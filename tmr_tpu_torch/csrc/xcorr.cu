// SAME-padded depthwise cross-correlation for Hopper (sm_90a): f32 on the tensor cores
// in 3xTF32, and int8 with an exact int32 sum.
//
// Replaces tmr_tpu/ops/pallas_xcorr.py _xcorr_kernel (xcorr_pallas): for every (image,
// channel) plane, out[y, x] = sum_{i,j < T} f[y + i - c, x + j - c] * t[i, j] with zero
// padding, c = T // 2, no kernel flip (correlation, not convolution). The int8 variant
// replaces the XLA integer grouped convolution of tmr_tpu/ops/xcorr.py _xcorr_int8dot:
// int8 feature and template, the sum exact in int32, then out = float(acc) * (fs * ts)
// with one f32 scale of each per plane.
//
// f32 kernel (xcorr_tf32_kernel). What bounds it on an H100: 2 T^2 operations per output
// and no channel reduction; 73.1 GFLOP of useful products at T = 33 on the matcher's
// 4 x 512 x 128^2 map. As 3xTF32 on the tensor cores that is 3 x 73.1 GFLOP at the 495
// TFLOP/s TF32 dense peak, 0.443 ms (0.537 ms with the band padding below); the bytes (the
// map in and out once) take 0.080 ms. On the CUDA cores it would be 1.09 ms at 67 TFLOP/s.
// In practice mma.sync bounds it: with the A operands made in registers (no loads, no
// splits) the products alone take 1.26-1.29 ms of the kernel's 1.44-1.45 ms at T = 33 on
// an NVIDIA H100 80GB HBM3 at 700 W (scripts/xcorr_variants.py), about 210 TFLOP/s of
// band MACs; the full TF32 rate needs wgmma.
// Design:
// - The product as a banded matrix product. For template row i, the tile's outputs are
//     out[m, n] += sum_k S[m + i, k] * B_i[k, n],  B_i[k, n] = t[i, k - n]
//   (0 outside [0, T)), where S is the staged input window. With mma.sync m16n8k8 (16
//   rows, 8 columns, depth 8) an n8 column tile nb needs KB = ceil((T + 7) / 8) k-blocks
//   of the band; the B fragment of k-block kb is the same for every column tile
//   (Toeplitz), and the A fragment of (nb, kb) depends only on nb + kb, so each A fragment
//   is loaded once per template row and feeds every (nb, kb) pair with that sum. Useful
//   share of the MACs: T / (8 KB), 82.5% at T = 33. The band is never written out: each
//   thread gathers its B fragments for row i from the template in shared memory.
// - The k order inside a k-block is permuted (slot q of the mma holds column 2q, slot
//   q + 4 column 2q + 1, in both A and B), so a thread's two A columns are adjacent: one
//   8-byte shared load per fragment row. The window's row pitch is 8 mod 32 floats, so
//   those loads hit every bank once per half-warp.
// - 3xTF32: every operand x is split into hi = tf32_rna(x) and lo = tf32_rna(x - hi)
//   (rounded as cvt.rna rounds: nearest, ties away, here in integer ops), and out
//   accumulates lo*hi + hi*lo + hi*hi in f32 registers: three mma per (nb, kb) pair, an
//   error of about 2^-21 per product, f32 grade. The window is split as each A fragment
//   is loaded, the template once when it is staged (hi and lo planes). A non-finite
//   input gives NaN over its whole band (the band's zeros times it), a wider region
//   than the T x T one of the plain correlation.
// - Staging: one CTA of 4 warps per (plane, 64 x 64 output tile). Its (63 + T) x
//   (64 + 8 (KB - 1)) input window goes into shared memory by 4-byte cp.async with
//   zero-fill (src-size 0) for elements outside the map or past the columns the tile
//   reads: the SAME padding, with no bounds test in the product loop, for any W.
// - Each warp owns 16 rows x 64 columns: 8 accumulator tiles. The tensor cores' f32
//   accumulation truncates, and a chain of T KB 3 mma into one accumulator drifted to
//   1.6-2.0 times the f32 tolerance at T = 65 on the card; so each template row sums into
//   a fresh accumulator (its first mma reads no C), then added to the f32 total with a
//   rounded add: 2 x 32 f32 registers. KB is a template parameter (9 instantiations for
//   T <= 65), so every fragment index is static.
// - Epilogue: f32 straight from the accumulators, masked at the ragged edge.
//
// int8 kernel (xcorr_int8_kernel). The int8 products are bounded at the 1979 TOP/s int8
// peak by their bytes (the int8 map in, the f32 map out: about 0.05 ms at 3.35 TB/s); the
// kernel runs one int32 IMAD per product on the CUDA cores, far from that. Design: one CTA
// of 256 threads per (plane, 32 x 32 output tile); the tile's input with its T - 1 halo
// and the plane's T x T template sit in shared memory, each thread accumulates 4 outputs
// in registers (rows ty, ty + 8, ty + 16, ty + 24 of its column), so every template tap
// is one broadcast read reused four times. Not yet: the band design above with
// mma.sync m16n8k32 s8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- f32: 3xTF32 band products on the tensor cores ----

constexpr int WARPS_M = 4, WARPS_N = 1;  // warps of a CTA
constexpr int WM = 1, WN = 8;            // m16 row tiles and n8 column tiles of a warp
constexpr int BM = 16 * WM * WARPS_M;    // output rows of a CTA
constexpr int BN = 8 * WN * WARPS_N;     // output columns of a CTA
constexpr int THREADS = 32 * WARPS_M * WARPS_N;

// the staged window's columns and row pitch (8 mod 32 floats) for KB k-blocks
__host__ __device__ constexpr int window_cols(int kb) { return BN + 8 * (kb - 1); }
__host__ __device__ constexpr int window_pitch(int kb) {
  return (window_cols(kb) + 23) / 32 * 32 + 8;
}

__host__ __device__ constexpr size_t tf32_smem_bytes(int kb, int t) {
  return ((size_t)(BM + t - 1) * window_pitch(kb) + 2 * t * t) * sizeof(float);
}

// cvt.rna.tf32.f32 (nearest, ties away) as integer ops: half a tf32 ulp added to the
// magnitude bits, the low 13 bits cleared. Equal to the cvt for finite values and
// infinities; the cvt issues at a lower rate (it cost 10% of the kernel at T = 33)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 |x|), both tf32. For an infinity lo is NaN; a NaN must be the
// canonical one (a NaN whose top 11 mantissa bits are set would carry into the sign bit
// and round to -0): callers canonicalize first
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ float canonical_nan(float x) {
  return isnan(x) ? __uint_as_float(0x7FC00000u) : x;
}

// c = a * b + c, or a * b where FIRST (c is not read)
template <bool FIRST>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if (FIRST) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// 4 bytes global -> shared, zero-filled where !ok (src-size 0: the source is not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

template <int KB>
__global__ void __launch_bounds__(THREADS)
    xcorr_tf32_kernel(const float* __restrict__ f, const float* __restrict__ tmpl,
                      float* __restrict__ out, int H, int W, int T, int tiles_x,
                      int tiles) {
  constexpr int COLS = window_cols(KB), LD = window_pitch(KB);
  extern __shared__ __align__(16) float smem[];
  const int rows = BM + T - 1;
  float* sW = smem;                // rows x LD: the input window, f32
  float* sThi = sW + rows * LD;    // T x T: the template's tf32 hi
  float* sTlo = sThi + T * T;      // T x T: its tf32 lo
  const int plane = blockIdx.x / tiles, tile = blockIdx.x - plane * tiles;
  const int y0 = (tile / tiles_x) * BM, x0 = (tile % tiles_x) * BN;
  const int c = T / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* fp = f + (size_t)plane * H * W;

  // window row r, column k holds f[y0 - c + r, x0 - c + k]; zero outside the map and
  // from column BN + T - 1 on (read by no output of the tile, multiplied by the band's
  // zeros)
  const int used = BN + T - 1;
  for (int r = warp; r < rows; r += THREADS / 32) {
    const int y = y0 - c + r;
    const bool row_ok = y >= 0 && y < H;
    const float* frow = fp + (size_t)(row_ok ? y : 0) * W;
    for (int k = lane; k < COLS; k += 32) {
      const int x = x0 - c + k;
      const bool ok = row_ok && k < used && x >= 0 && x < W;
      cp_async4(sW + r * LD + k, ok ? frow + x : fp, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const float* tp = tmpl + (size_t)plane * T * T;
  for (int e = threadIdx.x; e < T * T; e += THREADS) {
    uint32_t hi, lo;
    split_tf32(canonical_nan(tp[e]), hi, lo);
    sThi[e] = __uint_as_float(hi);
    sTlo[e] = __uint_as_float(lo);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // this thread's own copies have landed: canonicalize their NaNs for split_tf32
  for (int r = warp; r < rows; r += THREADS / 32)
    for (int k = lane; k < COLS; k += 32) sW[r * LD + k] = canonical_nan(sW[r * LD + k]);
  __syncthreads();

  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int r0 = wm * 16 * WM, c0 = wn * 8 * WN;
  float acc[WM][WN][4], part[WM][WN][4];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int nb = 0; nb < WN; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nb][q] = 0.f;
  // this thread's A elements: rows gid and gid + 8 of each m16 tile, columns 2 tig and
  // 2 tig + 1 of each k-block
  const float* a_base = sW + (r0 + gid) * LD + c0 + 2 * tig;

  for (int i = 0; i < T; ++i) {
    // B fragments of template row i: k-block kb holds t[i, 8 kb + k - n] at (k, n); this
    // thread holds n = gid and k = 2 tig, 2 tig + 1
    uint32_t bh[KB][2], bl[KB][2];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 8 * kb + 2 * tig + h - gid;
        const bool in = j >= 0 && j < T;
        const int e = in ? i * T + j : 0;
        bh[kb][h] = in ? __float_as_uint(sThi[e]) : 0u;
        bl[kb][h] = in ? __float_as_uint(sTlo[e]) : 0u;
      }
    const float* a_row = a_base + i * LD;
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int s = 0; s < WN + KB - 1; ++s) {
        const float2 top = *reinterpret_cast<const float2*>(a_row + mt * 16 * LD + 8 * s);
        const float2 bot =
            *reinterpret_cast<const float2*>(a_row + (mt * 16 + 8) * LD + 8 * s);
        uint32_t ah[4], al[4];
        split_tf32(top.x, ah[0], al[0]);
        split_tf32(bot.x, ah[1], al[1]);
        split_tf32(top.y, ah[2], al[2]);
        split_tf32(bot.y, ah[3], al[3]);
#pragma unroll
        for (int nb = 0; nb < WN; ++nb) {
          const int kb = s - nb;
          if (kb < 0 || kb >= KB) continue;
          if (kb == 0) {
            mma_tf32<true>(part[mt][nb], al, bh[kb][0], bh[kb][1]);
          } else {
            mma_tf32<false>(part[mt][nb], al, bh[kb][0], bh[kb][1]);
          }
          mma_tf32<false>(part[mt][nb], ah, bl[kb][0], bl[kb][1]);
          mma_tf32<false>(part[mt][nb], ah, bh[kb][0], bh[kb][1]);
        }
      }
    // the row's sum (from zero), added to the total with a rounded add
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int nb = 0; nb < WN; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[mt][nb][q] = __fadd_rn(acc[mt][nb][q], part[mt][nb][q]);
  }

  // accumulator q of tile (mt, nb) is row gid + 8 (q / 2), column 2 tig + q % 2
  float* op = out + (size_t)plane * H * W;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int nb = 0; nb < WN; ++nb)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int y = y0 + r0 + mt * 16 + gid + 8 * (q >> 1);
        const int x = x0 + c0 + nb * 8 + 2 * tig + (q & 1);
        if (y < H && x < W) op[(size_t)y * W + x] = acc[mt][nb][q];
      }
}

template <int KB>
int launch_tf32(const float* f, const float* t, float* out, int planes, int H, int W, int T,
                cudaStream_t stream) {
  const size_t smem = tf32_smem_bytes(KB, T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        xcorr_tf32_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_x = (W + BN - 1) / BN, tiles = tiles_x * ((H + BM - 1) / BM);
  xcorr_tf32_kernel<KB><<<(unsigned)planes * tiles, THREADS, smem, stream>>>(
      f, t, out, H, W, T, tiles_x, tiles);
  return (int)cudaGetLastError();
}

// ---- int8: exact int32 sums on the CUDA cores ----

constexpr int TILE = 32;

__global__ void __launch_bounds__(256)
    xcorr_int8_kernel(const int8_t* __restrict__ f, const int8_t* __restrict__ tmpl,
                      const float* __restrict__ fs, const float* __restrict__ ts,
                      float* __restrict__ out, int H, int W, int T, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int FS = TILE + T - 1;                       // staged input tile edge
  int8_t* sF = reinterpret_cast<int8_t*>(smem_raw);  // FS x FS
  int8_t* sT = sF + FS * FS;                         // T x T
  const int plane = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TILE, tx0 = (blockIdx.x % tiles_x) * TILE;
  const int c = T / 2;
  const int8_t* fp = f + (size_t)plane * H * W;
  const int8_t* tp = tmpl + (size_t)plane * T * T;
  for (int i = threadIdx.x; i < FS * FS; i += blockDim.x) {
    const int r = i / FS, cc = i - r * FS;
    const int y = ty0 - c + r, x = tx0 - c + cc;
    sF[i] = (y >= 0 && y < H && x >= 0 && x < W) ? fp[(size_t)y * W + x] : int8_t(0);
  }
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) sT[i] = tp[i];
  __syncthreads();
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  int acc[4] = {0, 0, 0, 0};
  for (int i = 0; i < T; ++i) {
    const int8_t* row = sF + (ty + i) * FS + tx;
    const int8_t* trow = sT + i * T;
    for (int j = 0; j < T; ++j) {
      const int w = trow[j];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] += int(row[r * 8 * FS + j]) * w;
    }
  }
  float* op = out + (size_t)plane * H * W;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int y = ty0 + ty + r * 8, x = tx0 + tx;
    if (y < H && x < W)
      op[(size_t)y * W + x] =
          __fmul_rn(__int2float_rn(acc[r]), __fmul_rn(fs[plane], ts[plane]));
  }
}

}  // namespace

extern "C" {

// feature (planes, H, W) f32, template (planes, T, T) f32, out (planes, H, W) f32; all
// contiguous, T odd and <= 65. Returns the CUDA error code (0 = launched).
int tmr_xcorr(const void* feature, const void* tmpl, void* out, int planes, int H, int W,
              int T, void* stream) {
  if (T < 1 || T > 65 || T % 2 == 0) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feature);
  const float* t = static_cast<const float*>(tmpl);
  float* o = static_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch ((T + 14) / 8) {  // KB = ceil((T + 7) / 8)
    case 1: return launch_tf32<1>(f, t, o, planes, H, W, T, s);
    case 2: return launch_tf32<2>(f, t, o, planes, H, W, T, s);
    case 3: return launch_tf32<3>(f, t, o, planes, H, W, T, s);
    case 4: return launch_tf32<4>(f, t, o, planes, H, W, T, s);
    case 5: return launch_tf32<5>(f, t, o, planes, H, W, T, s);
    case 6: return launch_tf32<6>(f, t, o, planes, H, W, T, s);
    case 7: return launch_tf32<7>(f, t, o, planes, H, W, T, s);
    case 8: return launch_tf32<8>(f, t, o, planes, H, W, T, s);
    default: return launch_tf32<9>(f, t, o, planes, H, W, T, s);
  }
}

// feature (planes, H, W) int8, template (planes, T, T) int8, fs and ts (planes,) f32,
// out (planes, H, W) f32; all contiguous, T odd.
int tmr_xcorr_int8(const void* feature, const void* tmpl, const void* fs, const void* ts,
                   void* out, int planes, int H, int W, int T, void* stream) {
  const int FS = TILE + T - 1;
  const size_t smem = (size_t)(FS * FS + T * T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(xcorr_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, planes);
  xcorr_int8_kernel<<<grid, 256, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)feature, (const int8_t*)tmpl, (const float*)fs, (const float*)ts,
      (float*)out, H, W, T, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
