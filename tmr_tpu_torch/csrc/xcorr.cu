// SAME-padded depthwise cross-correlation for Hopper (sm_90a) on the tensor cores: f32 in
// 3xTF32, and int8 with an exact int32 sum.
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
// int8 kernel (xcorr_int8_kernel). What bounds it on an H100: its bytes, the int8 map in
// and the f32 map out, 168 MB on the matcher's 4 x 512 x 128^2 map, 0.0508 ms at 3.35
// TB/s; the useful products at the 1979 TOP/s int8 peak take 0.037 ms at T = 33 and the
// band's performed ones (below) 0.0537 ms (0.0716 with 32-deep blocks only). Design: kernel 5's band products in s8, one
// pass (int8 products and int32 sums are exact, so no splits):
// - mma.sync m16n8k32 s8 x s8 -> s32: an n8 column tile needs T + 7 + rho columns of the
//   band, KB = ceil((T + 7 + rho) / 32) k-blocks (1 for T <= 25, 2 for T = 33, 3 for T =
//   65); where the last one needs no more than 16 it is an m16n8k16 product (K16), so the
//   band's depth is 16, 32, 48 and 80 at T = 9, 17, 33 and 65 (useful share 56%, 53%, 69%,
//   81%). KB and K16 are template parameters. One int32 accumulator chain over all T
//   template rows: integer sums do not drift.
// - A (the window) in the natural k order: this thread's a0 of fragment (nb, kb) is the
//   word at column 8 (nb + 4 kb) + 4 q of row g and a2 the word 16 columns on, which is
//   a0 of the fragment two column tiles on; so one 4-byte load per word feeds every
//   (nb, kb) pair that reads it: 2 (WN + 4 KB - 2) loads per m16 tile and template row
//   for WN KB mma. Row pitch 16 mod 32 bytes: those loads are conflict-free.
// - B (the band) is the same for every column tile and row tile: b0 of k-block kb holds
//   t[i, 32 kb + 4 q + kk - g - rho], kk = 0..3, b1 the same 16 on. Each template row is
//   staged with 12 zero bytes before it and zeros after, so any offset is two aligned
//   words joined by __byte_perm (the byte shift is fixed per thread), 0 outside [0, T).
// - Staging: one CTA of 4 warps per (plane, 64 x 128 output tile); each warp owns 16
//   rows x 128 columns (16 accumulator tiles, 64 registers). The window, (63 + T) rows
//   from the 16-aligned column x0 - c - e, e = (-c) mod 16, goes into shared memory by
//   16-byte cp.async with zero fill: SAME padding with no bounds test in the product
//   loop. e's multiple of 4 is folded into the A index and its rest rho (0..3) into the
//   band, so the A loads stay aligned words. A map whose rows are not 16-byte aligned
//   (W % 16 != 0) is staged bytewise.
// - Epilogue: float(acc) * (fs * ts), each step rounded as the plain version does, 8-byte
//   stores of two columns straight from the accumulators, masked at the ragged edge.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py; scripts/xcorr_variants.py
// --int8 for the cuts): 0.069-0.070 ms at T <= 9, 0.093 at 17, 0.186-0.188 at 33 and 0.472-
// 0.480 at 65, against 0.13-21.6 ms for the CUDA-core kernel before it (5.64 at T = 33).
// The products bind: with them cut out the kernel takes 0.070 ms at T = 33 (staging and
// the f32 store, near the bytes' bound), with the A loads, the staging or the store cut
// 0.173-0.186. With 32-deep blocks only, the products alone ran at 703 TOP/s of band
// products (36% of the int8 peak): the s8 mma.sync rate. A k16 product costs ~70% of a
// k32 one, so the K16 tail saves 7% at T = 33, not 25%. The next step is wgmma with the
// band in shared memory.

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

// ---- int8: exact s8 band products on the tensor cores ----

constexpr int I8_WARPS = 4;                 // warps of a CTA, stacked in rows
constexpr int I8_WM = 1, I8_WN = 16;        // m16 row tiles and n8 column tiles of a warp
constexpr int I8_BM = 16 * I8_WM * I8_WARPS;  // output rows of a CTA
constexpr int I8_BN = 8 * I8_WN;              // output columns of a CTA
constexpr int I8_THREADS = 32 * I8_WARPS;
constexpr int I8_TPAD = 12;  // zero bytes before each staged template row

// geometry mirrored by tmr_tpu_torch/ops/cuda_xcorr.py int8_geometry. The window starts
// at the 16-aligned column xs = x0 - c - e, e = (-c) mod 16 (x0 is a multiple of 16):
// delta = e & ~3 goes into the A-fragment index, rho = e & 3 into the band
__host__ __device__ constexpr int i8_kb(int t) { return (t + 7 + ((-(t / 2)) & 3) + 31) / 32; }
// the last k-block is 16 deep (m16n8k16) where the band's depth leaves it no more
__host__ __device__ constexpr bool i8_k16(int t) {
  return t + 7 + ((-(t / 2)) & 3) - 32 * (i8_kb(t) - 1) <= 16;
}
__host__ __device__ constexpr int i8_cols(int t, int kb) {
  return ((((-(t / 2)) & 15) & ~3) + I8_BN + 32 * kb - 8 + 15) / 16 * 16;
}
// row pitch 16 mod 32 bytes: a warp's A loads (rows g, words q + 2u) hit 32 banks once
__host__ __device__ constexpr int i8_pitch(int t, int kb) {
  return (i8_cols(t, kb) - 16 + 31) / 32 * 32 + 16;
}
__host__ __device__ constexpr int i8_tpitch(int kb) { return 32 * kb + 16; }
__host__ __device__ constexpr size_t i8_smem_bytes(int t, int kb) {
  return (size_t)(I8_BM + t - 1) * i8_pitch(t, kb) + (size_t)t * i8_tpitch(kb);
}

// c += a * b on the tensor cores, s8 x s8 -> s32 (exact: |sum| < 2^31 for T <= 65)
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the same, 16 deep
__device__ __forceinline__ void mma_s8_k16(int (&c)[4], uint32_t a0, uint32_t a1,
                                           uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// 16 bytes global -> shared, zero-filled where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

template <int KB, bool K16>
__global__ void __launch_bounds__(I8_THREADS)
    xcorr_int8_kernel(const int8_t* __restrict__ f, const int8_t* __restrict__ tmpl,
                      const float* __restrict__ fs, const float* __restrict__ ts,
                      float* __restrict__ out, int H, int W, int T, int tiles_x, int tiles,
                      int vec16) {
  constexpr int NU = I8_WN + 4 * KB - (K16 ? 4 : 2);  // A words per fragment row
  constexpr int TP = i8_tpitch(KB);
  extern __shared__ __align__(16) unsigned char smem_i8[];
  const int c = T / 2, e = (-c) & 15, delta = e & ~3, rho = e & 3;
  const int cols = i8_cols(T, KB), LD = i8_pitch(T, KB), rows = I8_BM + T - 1;
  unsigned char* sW = smem_i8;               // rows x LD: the input window
  unsigned char* sT = sW + (size_t)rows * LD;  // T x TP: template rows, zero-padded
  const int plane = blockIdx.x / tiles, tile = blockIdx.x - plane * tiles;
  const int y0 = (tile / tiles_x) * I8_BM, x0 = (tile % tiles_x) * I8_BN;
  const int xs = x0 - c - e;
  const int8_t* fp = f + (size_t)plane * H * W;

  // window row r, column k holds f[y0 - c + r, xs + k], zero outside the map
  if (vec16) {  // W % 16 == 0 and an aligned map: each 16-byte chunk is in or out whole
    const int chunks = cols / 16;
    for (int e16 = threadIdx.x; e16 < rows * chunks; e16 += I8_THREADS) {
      const int r = e16 / chunks, k = (e16 - r * chunks) * 16;
      const int y = y0 - c + r, x = xs + k;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      cp_async16(sW + r * LD + k, ok ? fp + (size_t)y * W + x : fp, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {  // ragged rows: bytes, four to a shared word
    const int words = cols / 4;
    for (int e4 = threadIdx.x; e4 < rows * words; e4 += I8_THREADS) {
      const int r = e4 / words, k = (e4 - r * words) * 4;
      const int y = y0 - c + r;
      uint32_t v = 0;
      if (y >= 0 && y < H) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int x = xs + k + b;
          if (x >= 0 && x < W) v |= (uint32_t)(uint8_t)fp[(size_t)y * W + x] << (8 * b);
        }
      }
      *reinterpret_cast<uint32_t*>(sW + r * LD + k) = v;
    }
  }
  // template row i at sT + i * TP: byte u holds t[i, u - I8_TPAD], zero outside [0, T)
  const int8_t* tp = tmpl + (size_t)plane * T * T;
  for (int e4 = threadIdx.x; e4 < T * (TP / 4); e4 += I8_THREADS) {
    const int i = e4 / (TP / 4), u = (e4 - i * (TP / 4)) * 4 - I8_TPAD;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (u + b >= 0 && u + b < T) v |= (uint32_t)(uint8_t)tp[i * T + u + b] << (8 * b);
    *reinterpret_cast<uint32_t*>(sT + i * TP + u + I8_TPAD) = v;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = warp * 16 * I8_WM;
  int acc[I8_WM][I8_WN][4];
#pragma unroll
  for (int mt = 0; mt < I8_WM; ++mt)
#pragma unroll
    for (int nb = 0; nb < I8_WN; ++nb)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nb][v] = 0;
  // A: fragment (nb, kb) is the window's columns delta + 8 nb + 32 kb + [0, 32); this
  // thread's a0 is the word at column delta + 8 u + 4 q (u = nb + 4 kb) of row g, a2 the
  // word of u + 2, a1 and a3 the same of row g + 8
  const uint32_t* a_base =
      reinterpret_cast<const uint32_t*>(sW + (r0 + g) * LD + delta) + q;
  // B: b0 of k-block kb holds t[i, 32 kb + 4 q + kk - g - rho] for kk = 0..3, b1 the same
  // at + 16: the padded row's bytes from o = 32 kb + 4 q - g - rho + I8_TPAD on, two
  // aligned words joined by a byte permute (the shift is the same for every kb and i)
  const int o = 4 * q - g - rho + I8_TPAD;
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(o & 3);
  const uint32_t* b_base = reinterpret_cast<const uint32_t*>(sT) + (o >> 2);

  for (int i = 0; i < T; ++i) {
    const uint32_t* brow = b_base + i * (TP / 4);
    uint32_t bf[KB][2];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bf[kb][h] = K16 && kb == KB - 1 && h == 1
                        ? 0u
                        : __byte_perm(brow[8 * kb + 4 * h], brow[8 * kb + 4 * h + 1], sel);
#pragma unroll
    for (int mt = 0; mt < I8_WM; ++mt) {
      const uint32_t* ra = a_base + (mt * 16 + i) * (LD / 4);
      const uint32_t* rb = ra + 8 * (LD / 4);
      uint32_t wa[NU], wb[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        wa[u] = ra[2 * u];
        wb[u] = rb[2 * u];
      }
#pragma unroll
      for (int nb = 0; nb < I8_WN; ++nb)
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          const int u = nb + 4 * kb;
          if (K16 && kb == KB - 1) {
            mma_s8_k16(acc[mt][nb], wa[u], wb[u], bf[kb][0]);
          } else {
            mma_s8(acc[mt][nb], wa[u], wb[u], wa[u + 2], wb[u + 2], bf[kb][0], bf[kb][1]);
          }
        }
    }
  }

  // accumulator v of tile (mt, nb) is row g + 8 (v / 2), column 2 q + v % 2; the epilogue
  // is the plain version's: float(acc) * (fs * ts), each step rounded
  const float scale = __fmul_rn(fs[plane], ts[plane]);
  float* op = out + (size_t)plane * H * W;
#pragma unroll
  for (int mt = 0; mt < I8_WM; ++mt)
#pragma unroll
    for (int nb = 0; nb < I8_WN; ++nb)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int y = y0 + r0 + mt * 16 + g + 8 * hr;
        const int x = x0 + nb * 8 + 2 * q;
        const float v0 = __fmul_rn(__int2float_rn(acc[mt][nb][2 * hr]), scale);
        const float v1 = __fmul_rn(__int2float_rn(acc[mt][nb][2 * hr + 1]), scale);
        if (y >= H || x >= W) continue;
        float* dst = op + (size_t)y * W + x;
        if ((W & 1) == 0) {  // x even, W even: 8-byte aligned and x + 1 < W
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (x + 1 < W) dst[1] = v1;
        }
      }
}

template <int KB, bool K16>
int launch_int8(const int8_t* f, const int8_t* t, const float* fs, const float* ts,
                float* out, int planes, int H, int W, int T, cudaStream_t stream) {
  const size_t smem = i8_smem_bytes(T, KB);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        xcorr_int8_kernel<KB, K16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_x = (W + I8_BN - 1) / I8_BN, tiles = tiles_x * ((H + I8_BM - 1) / I8_BM);
  const int vec16 = W % 16 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0;
  xcorr_int8_kernel<KB, K16><<<(unsigned)planes * tiles, I8_THREADS, smem, stream>>>(
      f, t, fs, ts, out, H, W, T, tiles_x, tiles, vec16);
  return (int)cudaGetLastError();
}

// ---- int8 on the CUDA cores: the design the kernel above replaced (one int32 IMAD per
// product), kept as the yardstick chip_smoke.py times it against; the port never calls it

constexpr int TILE = 32;

__global__ void __launch_bounds__(256)
    xcorr_int8_cuda_cores_kernel(const int8_t* __restrict__ f,
                                 const int8_t* __restrict__ tmpl,
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
// out (planes, H, W) f32; all contiguous, T odd and <= 65. Returns the CUDA error code.
int tmr_xcorr_int8(const void* feature, const void* tmpl, const void* fs, const void* ts,
                   void* out, int planes, int H, int W, int T, void* stream) {
  if (T < 1 || T > 65 || T % 2 == 0) return (int)cudaErrorInvalidValue;
  const int8_t* f = static_cast<const int8_t*>(feature);
  const int8_t* t = static_cast<const int8_t*>(tmpl);
  const float* a = static_cast<const float*>(fs);
  const float* b = static_cast<const float*>(ts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (2 * i8_kb(T) + i8_k16(T)) {  // KB = ceil((T + 7 + rho) / 32): 1 to 3
    case 2: return launch_int8<1, false>(f, t, a, b, o, planes, H, W, T, s);
    case 3: return launch_int8<1, true>(f, t, a, b, o, planes, H, W, T, s);
    case 4: return launch_int8<2, false>(f, t, a, b, o, planes, H, W, T, s);
    case 5: return launch_int8<2, true>(f, t, a, b, o, planes, H, W, T, s);
    case 6: return launch_int8<3, false>(f, t, a, b, o, planes, H, W, T, s);
    default: return launch_int8<3, true>(f, t, a, b, o, planes, H, W, T, s);
  }
}

// the CUDA-core yardstick, same arguments
int tmr_xcorr_int8_cuda_cores(const void* feature, const void* tmpl, const void* fs,
                              const void* ts, void* out, int planes, int H, int W, int T,
                              void* stream) {
  if (T < 1 || T > 65 || T % 2 == 0) return (int)cudaErrorInvalidValue;
  const int FS = TILE + T - 1;
  const size_t smem = (size_t)(FS * FS + T * T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(xcorr_int8_cuda_cores_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, planes);
  xcorr_int8_cuda_cores_kernel<<<grid, 256, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)feature, (const int8_t*)tmpl, (const float*)fs, (const float*)ts,
      (float*)out, H, W, T, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
