// int8 kernels of the decoder tail for Hopper (sm_90a): the general int8 x int8 -> int32
// matrix product with an f32 scale epilogue, and the fused 3x3 layer.
//
// Both replace tmr_tpu/ops/pallas_int8.py _int8_mm_kernel (int8_matmul):
//   out[m, n] = float(sum_k x[m, k] * w[n, k]) * (sx[m] * sw[n])
// with the sum exact in int32 and the epilogue rounded as the Pallas kernel rounds it
// (int -> f32 conversion, then one multiply by sx * sw).
//
// ---- int8_conv3x3_kernel (tmr_int8_conv3x3): one launch per 3x3 decoder layer -----------
// What the JAX int8dot/pallas arms compute for a 3x3 SAME conv (tmr_tpu/ops/fused_heads.py
// conv_mm, then leaky_relu), bit for bit:
//   for tap t = (dy, dx) in row-major order:
//     i32[p, n] = sum_k xq[b, y + dy - 1, x + dx - 1, k] * wq[t, n, k]  (zero outside the image)
//     v[p, n]   = float(i32) * (sx[b] * sw[t, n])
//     f[p, n]   = t == 0 ? v : f[p, n] + v                                  (f32, tap order)
//   out = leaky_relu(f + bias[n])
// Every step is written with __int2float_rn / __fmul_rn / __fadd_rn: nvcc would otherwise
// contract a multiply and an add into an FMA and change the last bit.
//
// What bounds it on an H100: the int8 tail's layer (4 x 128^2 pixels, 1024 -> 2048
// channels) is 2.47e12 int8 operations, 1.25 ms at the 1979 TOPS dense int8 peak; its
// minimal bytes (the int8 activation and taps in, the f32 output out) are 0.62 GB, 0.19
// ms. So the tensor cores bound it. The composition it replaces (9 launches of the
// general kernel below, each writing a 537 MB f32 tap, 8 f32 adds, the bias, leaky_relu
// and a padded copy of the activation) moved ~10 GB through HBM.
// Design:
// - Implicit GEMM with K = 9 x C_in: one output tile is 128 pixels of one image row x 128
//   output channels. Its nine taps are summed inside the kernel: per tap an exact int32
//   accumulator (64 registers a thread), folded into an f32 running sum (64 more) with the
//   tap's scales after the tap's last k-step, so the f32 tile is written once.
// - wgmma.mma_async m64n128k32 s32.s8.s8: two consumer warpgroups of 64 pixels each, both
//   operands K-major as the data lies (NHWC channels for A, the stored (N, C_in) tap rows
//   for B), from 128-byte K panels in the 128B-swizzled layout TMA writes. The first
//   k-step of a tap runs with scale-d = 0, which zeroes the int32 accumulator.
// - Operands by TMA into a ring of NS stages (one 16 KB A panel + one 16 KB B panel each)
//   with full/empty mbarriers, fed by one producer warp. A is a 4-D map over (C_in, W, H,
//   B) whose box is (128 bytes, 128 px, 1, 1), loaded at (k0, x0 + dx - 1, y + dy - 1, b):
//   TMA zero-fills negative and past-edge coordinates, which is the SAME padding, with
//   no padded copy of the activation and no bounds test. B is a 3-D map over (C_in, N, 9),
//   so rows past N are zero-filled and never read the next tap. Channels past C_in are
//   zero in both.
// - Persistent: one CTA per SM walks the tiles (N tiles fastest, so the 16 N tiles of
//   one image row run together and share their A panels in L2); the ring runs on across
//   tiles, so a tile's loads start under the previous tile's last fold and store.
// - Register file: the int32 and f32 accumulators of a 128 x 128 tile take 32 K of the
//   SM's 64 K registers; a 128 x 256 tile would need all of them. 288 threads (two
//   consumer warpgroups and the producer warp); nvcc -Xptxas -v (CUDA 12.8, sm_90a):
//   168 registers, 0 bytes stack frame, 0 spills.
// - L2 traffic: at 128 x 128 tiles the staged panels total ~19 GB per layer (8192 tiles
//   x 9 taps x 1024 K bytes x 256 rows). Measured on the H100 (PERF.md): 2.2-2.3 ms
//   against the 1.25 ms bound; the loads alone take ~2.4 ms (~8 TB/s from L2) and bind,
//   the products with their folds ~2.0-2.2 ms alone (the folds' int -> float
//   conversions run at 16 a clock per SM). Alternatives measured no faster and not
//   shipped: the pixel tiles fastest, 4 or 6 stages, the warpgroups staggered by two
//   stages, a 2-CTA cluster that multicasts the shared A panel (<= 3% at CTA-scope
//   releases; twice as slow at cluster scope). They are text edits timed in turns by
//   scripts/int8_variants.py, not switches here.
// - Any B, H, W and N: pixels past W and channels past N are masked in the store. C_in
//   must be a multiple of 16 (TMA's 16-byte strides); the wrapper raises otherwise.
//
// ---- int8_mm_kernel (tmr_int8_mm): the general product --------------------------------
// On the int8 path it runs the block-diagonal 1x1 heads ((65536 x 2048) . (2048 x 5)) and
// any conv that is not 3x3, one launch per tap. Design (right first, not yet fast):
// - one CTA of 8 warps per (BM x BN) tile of the output; the int32 accumulators stay in
//   registers for the whole K loop; K is walked 64 bytes at a time, each step two
//   mma.sync.m16n8k32.row.col.s32.s8.s8.s32;
// - A (row-major, K contiguous) and B (stored (N, K), K contiguous: the .col operand)
//   tiles go through registers into shared memory (rows padded to 80 bytes so the
//   fragment reads hit 32 distinct banks); the next tile's global loads are issued
//   before the current tile's products;
// - ragged M, N and K are zero-filled in the loads and masked in the store: no padded
//   copies. Where K or the row strides are not multiples of 16 bytes the loads go byte
//   by byte;
// - A's rows are addressed through (nh, nw) row dims and (sb, sh, sw) byte strides, so
//   a tap can read its shifted window [:, dy:dy+H, dx:dx+W, :] of a padded NHWC
//   activation in place, without a copy;
// - N <= 8 (the 1x1 heads, N = 5) takes a 128 x 8 tile: one n8 column of mma.
// On the general tap shape (65536 x 1024) . (1024 x 2048) it is bound by writing its
// 537 MB f32 result (0.16 ms at 3.35 TB/s) and took 0.88 ms (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // K bytes per step
constexpr int LDS = BK + 16;  // shared-memory row stride in bytes
constexpr int THREADS = 256;

struct Rows {  // row m = (b * nh + y) * nw + x of A starts at b * sb + y * sh + x * sw
  int nh, nw;
  long long sb, sh, sw;
};

__device__ __forceinline__ long long row_offset(int m, const Rows& r) {
  const int x = m % r.nw;
  const int t = m / r.nw;
  return (long long)(t / r.nh) * r.sb + (long long)(t % r.nh) * r.sh + (long long)x * r.sw;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of one row from k, zero past K or for a row outside the matrix
template <bool VEC>
__device__ __forceinline__ uint4 load16(const int8_t* row, bool ok, int k, int K) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!ok || k >= K) return v;
  if (VEC) return *reinterpret_cast<const uint4*>(row + k);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (k + j < K) w[j >> 2] |= (uint32_t)(uint8_t)row[k + j] << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(THREADS)
    int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, int M, int N, int K, Rows rows) {
  static_assert(WARPS_M * WARPS_N * 32 == THREADS, "8 warps");
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  constexpr int CH_ROW = BK / 16;  // 16-byte chunks per staged row
  constexpr int A_CH = BM * CH_ROW / THREADS;
  constexpr int B_CH = (BN * CH_ROW + THREADS - 1) / THREADS;
  static_assert(A_CH * THREADS == BM * CH_ROW, "A tile in whole chunks");

  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  const int8_t* arow[A_CH];
  bool aok[A_CH];
#pragma unroll
  for (int i = 0; i < A_CH; ++i) {
    const int m = m0 + (tid + i * THREADS) / CH_ROW;
    aok[i] = m < M;
    arow[i] = x + (aok[i] ? row_offset(m, rows) : 0);
  }
  const int8_t* brow[B_CH];
  bool bok[B_CH];
#pragma unroll
  for (int i = 0; i < B_CH; ++i) {
    const int c = tid + i * THREADS;
    const int n = n0 + c / CH_ROW;
    bok[i] = c < BN * CH_ROW && n < N;
    brow[i] = w + (bok[i] ? (long long)n * K : 0);
  }

  uint4 ra[A_CH], rb[B_CH];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i)
      ra[i] = load16<VEC>(arow[i], aok[i], k0 + ((tid + i * THREADS) % CH_ROW) * 16, K);
#pragma unroll
    for (int i = 0; i < B_CH; ++i)
      rb[i] = load16<VEC>(brow[i], bok[i], k0 + ((tid + i * THREADS) % CH_ROW) * 16, K);
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(As + (c / CH_ROW) * LDS + (c % CH_ROW) * 16) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int c = tid + i * THREADS;
      if (c < BN * CH_ROW)
        *reinterpret_cast<uint4*>(Bs + (c / CH_ROW) * LDS + (c % CH_ROW) * 16) = rb[i];
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* p = As + (wm * WTM + mi * 16 + g) * LDS + kk + t * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int8_t* p = Bs + (wn * WTN + ni * 8 + g) * LDS + kk + t * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    if (kt + 1 < nk) {
      __syncthreads();
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WTM + mi * 16 + g + h * 8;
      if (m >= M) continue;
      const float xs = sx[m];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * WTN + ni * 8 + t * 2 + j;
          if (n < N)
            out[(long long)m * N + n] =
                __fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + j]), __fmul_rn(xs, sw[n]));
        }
      }
    }
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
int launch(const int8_t* x, const int8_t* w, const float* sx, const float* sw, float* out,
           int M, int N, int K, Rows rows, bool vec, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (vec)
    int8_mm_kernel<BM, BN, WARPS_M, WARPS_N, true>
        <<<grid, THREADS, 0, stream>>>(x, w, sx, sw, out, M, N, K, rows);
  else
    int8_mm_kernel<BM, BN, WARPS_M, WARPS_N, false>
        <<<grid, THREADS, 0, stream>>>(x, w, sx, sw, out, M, N, K, rows);
  return (int)cudaGetLastError();
}

// ---- the fused 3x3 layer -------------------------------------------------------------

constexpr int CV_BM = 128;                      // output pixels per tile (one row segment)
constexpr int CV_BN = 128;                      // output channels per tile
constexpr int CV_BK = 128;                      // K bytes per stage: one 128B-swizzle panel
constexpr int CV_NS = 5;                        // stages of the TMA ring
constexpr int CV_A = CV_BM * CV_BK;             // A panel bytes
constexpr int CV_STAGE = CV_A + CV_BN * CV_BK;  // A + B panel bytes
constexpr int CV_TAPS = 9;
constexpr int CV_CONSUMERS = 256;               // two warpgroups of 64 pixels
constexpr int CV_THREADS = CV_CONSUMERS + 32;   // and the producer warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box into shared memory, completion counted in bytes on `bar`; coordinates
// outside the tensor (negative ones too) read as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register reads or writes of an accumulator across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma descriptor of a 128B-swizzled K-major operand (rows of 128 bytes, 8-row groups
// 1024 bytes apart, 1024-byte aligned as TMA writes it); a 32-byte k-step advances the
// start address field by 2.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

#define WG_ACC8(i)                                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),         \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define WG_ACC32(i) WG_ACC8(i), WG_ACC8(i + 8), WG_ACC8(i + 16), WG_ACC8(i + 24)

// d (64 x 128, s32) (+)= A (64 x 32, s8, shared) . B (32 x 128, s8, shared), both
// K-major; accumulate == 0 writes A . B (scale-d = 0).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,"
      "%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,"
      "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p;\n}\n"
      : WG_ACC32(0), WG_ACC32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// the 256 consumer threads only (named barrier 1; the producer warp never takes part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CV_CONSUMERS) : "memory");
}

struct ConvTile {
  int b, y, x0, n0;
};

// Tile i of the grid walk: N tiles fastest, then the 128-pixel segments of each image row.
__device__ __forceinline__ ConvTile conv_tile(int i, int nt, int xt, int H) {
  const int ni = i % nt, m = i / nt;
  const int xi = m % xt, row = m / xt;
  return ConvTile{row / H, row % H, xi * CV_BM, ni * CV_BN};
}

// ta: 4-D map of the int8 activation (C_in, W, H, B); tb: 3-D map of the int8 taps
// (C_in, N, 9); sx (B,), sw (9, N), bias (N,) f32; out (B, H, W, N) f32.
__global__ void __launch_bounds__(CV_THREADS, 1)
    int8_conv3x3_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, const float* __restrict__ sx,
                        const float* __restrict__ sw, const float* __restrict__ bias,
                        float* __restrict__ out, int H, int W, int N, int C, int xt, int nt,
                        int tiles, float slope) {
  extern __shared__ unsigned char cv_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(cv_smem_raw) + 1023) & ~uintptr_t(1023));
  float* s_scale = reinterpret_cast<float*>(ring + CV_NS * CV_STAGE);  // (9, BN) sx * sw
  float* s_bias = s_scale + CV_TAPS * CV_BN;                           // (BN,)
  uint64_t* full = reinterpret_cast<uint64_t*>(s_bias + CV_BN);
  uint64_t* empty = full + CV_NS;
  const int nkp = (C + CV_BK - 1) / CV_BK;  // K panels per tap
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < CV_NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CV_CONSUMERS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CV_CONSUMERS / 32) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      int it = 0;
      for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
        const ConvTile tl = conv_tile(i, nt, xt, H);
        for (int t = 0; t < CV_TAPS; ++t) {
          const int dy = t / 3, dx = t - 3 * dy;
          for (int kp = 0; kp < nkp; ++kp, ++it) {
            const int s = it % CV_NS, u = it / CV_NS;
            if (u) mbar_wait(&empty[s], (u - 1) & 1);
            unsigned char* st = ring + s * CV_STAGE;
            mbar_expect_tx(&full[s], CV_STAGE);
            tma_load_4d(st, &ta, &full[s], kp * CV_BK, tl.x0 + dx - 1, tl.y + dy - 1, tl.b);
            tma_load_3d(st + CV_A, &tb, &full[s], kp * CV_BK, tl.n0, t);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns tile rows 64c..64c+63; this thread rows r0 and r0 + 8,
  // columns 8j + 2q and 8j + 2q + 1 of each n8 block j (the wgmma accumulator layout)
  const int c = warp >> 2, q = lane & 3;
  const int r0 = 64 * c + 16 * (warp & 3) + (lane >> 2);
  const bool vec2 = (N & 1) == 0;
  int acc[64];
  float f[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;
  int it = 0;
  for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
    const ConvTile tl = conv_tile(i, nt, xt, H);
    // the tile's tap scales sx[b] * sw[t, n] (the Pallas epilogue's product) and bias
    consumer_sync();  // every consumer is past the previous tile's last fold
    const float xs = sx[tl.b];
    for (int e = threadIdx.x; e < CV_TAPS * CV_BN; e += CV_CONSUMERS) {
      const int t = e / CV_BN, n = tl.n0 + (e - t * CV_BN);
      s_scale[e] = n < N ? __fmul_rn(xs, sw[(size_t)t * N + n]) : 0.f;
    }
    for (int e = threadIdx.x; e < CV_BN; e += CV_CONSUMERS)
      s_bias[e] = tl.n0 + e < N ? bias[tl.n0 + e] : 0.f;
    consumer_sync();
    // -0 + v == v for every f32 v, so the first tap's fold below is f = v exactly
#pragma unroll
    for (int e = 0; e < 64; ++e) f[e] = -0.f;
    for (int t = 0; t < CV_TAPS; ++t) {
      for (int kp = 0; kp < nkp; ++kp, ++it) {
        const int s = it % CV_NS;
        mbar_wait(&full[s], (it / CV_NS) & 1);
        unsigned char* st = ring + s * CV_STAGE;
        const uint64_t da = sw128_desc(st + c * 64 * CV_BK), db = sw128_desc(st + CV_A);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < CV_BK / 32; ++kk)
          wgmma_s8_n128(acc, da + 2 * kk, db + 2 * kk, kp > 0 || kk > 0);
        wg_commit();
        if (kp > 0) {  // the previous stage's products are done: hand it back
          wg_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % CV_NS]);
        }
      }
      wg_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % CV_NS]);
      // fold the tap: f += float(i32) * (sx * sw[t, n]), rounded as the Pallas epilogue
      const float* sc = s_scale + t * CV_BN;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h;
          f[e] = __fadd_rn(f[e], __fmul_rn(__int2float_rn(acc[e]), s2.x));
          f[e + 1] = __fadd_rn(f[e + 1], __fmul_rn(__int2float_rn(acc[e + 1]), s2.y));
        }
      }
    }
    // bias, then leaky_relu as F.leaky_relu writes it (f > 0 ? f : f * slope); masked store
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tl.x0 + r0 + 8 * h;
      if (x >= W) continue;
      float* orow = out + (((size_t)tl.b * H + tl.y) * W + x) * N + tl.n0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * q, e = 4 * j + 2 * h;
        float a0 = __fadd_rn(f[e], s_bias[col]);
        float a1 = __fadd_rn(f[e + 1], s_bias[col + 1]);
        a0 = a0 > 0.f ? a0 : __fmul_rn(a0, slope);
        a1 = a1 > 0.f ? a1 : __fmul_rn(a1, slope);
        const int n = tl.n0 + col;
        if (vec2 && n + 1 < N) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(a0, a1);
        } else {
          if (n < N) orow[col] = a0;
          if (n + 1 < N) orow[col + 1] = a1;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_TENSOR_MAP = 1000;  // + the CUresult; 1000 alone: libcuda has no encoder

// cuTensorMapEncodeTiled from the libcuda.so.1 the runtime has loaded (no link against it)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// An int8 tensor of `rank` dims (dims[0] contiguous, byte strides of the others) as a TMA
// map whose box is (128 bytes, box1 rows, 1, ...), 128B-swizzled (the wgmma operand
// layout); reads outside the tensor are zero-filled.
int int8_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides, int box1) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return ERR_TENSOR_MAP;
  const cuuint32_t box[4] = {(cuuint32_t)CV_BK, (cuuint32_t)box1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

extern "C" {

// x: int8 rows of K contiguous bytes, row m = (b * nh + y) * nw + x at byte offset
// b * sb + y * sh + x * sw; w: (N, K) int8 contiguous; sx (M,), sw (N,) f32; out (M, N)
// f32 contiguous. Returns the CUDA error code (0 = launched).
int tmr_int8_mm(const void* x, const void* w, const void* sx, const void* sw, void* out,
                int M, int N, int K, int nh, int nw, long long sb, long long sh,
                long long sw_, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const Rows rows{nh, nw, sb, sh, sw_};
  const bool vec = K % 16 == 0 && sb % 16 == 0 && sh % 16 == 0 && sw_ % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  auto* op = static_cast<float*>(out);
  auto st = reinterpret_cast<cudaStream_t>(stream);
  if (N <= 8) return launch<128, 8, 8, 1>(xp, wp, sxp, swp, op, M, N, K, rows, vec, st);
  return launch<128, 128, 2, 4>(xp, wp, sxp, swp, op, M, N, K, rows, vec, st);
}

// xq: (B, H, W, C) int8 contiguous, 16-byte aligned, C a multiple of 16; sx (B,) f32;
// wq: (3, 3, N, C) int8 contiguous, 16-byte aligned; sw (3, 3, N) f32; bias (N,) f32;
// out (B, H, W, N) f32 contiguous: the 3x3 SAME conv summed over its nine taps, plus the
// bias, through leaky_relu(slope). Returns 0 when launched, a CUDA error code, or 1000
// (+ the CUresult) when a TMA descriptor cannot be made.
int tmr_int8_conv3x3(const void* xq, const void* sx, const void* wq, const void* sw,
                     const void* bias, void* out, int B, int H, int W, int C, int N,
                     float slope, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || N <= 0 || C <= 0) return 0;
  if (C % 16 || reinterpret_cast<uintptr_t>(xq) % 16 || reinterpret_cast<uintptr_t>(wq) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const cuuint64_t adims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t astrides[3] = {(cuuint64_t)C, (cuuint64_t)W * C, (cuuint64_t)H * W * C};
  const cuuint64_t bdims[3] = {(cuuint64_t)C, (cuuint64_t)N, (cuuint64_t)CV_TAPS};
  const cuuint64_t bstrides[2] = {(cuuint64_t)C, (cuuint64_t)N * C};
  int e;
  if ((e = int8_map(&ta, xq, 4, adims, astrides, CV_BM)) ||
      (e = int8_map(&tb, wq, 3, bdims, bstrides, CV_BN)))
    return e;
  const size_t smem = 1024 + (size_t)CV_NS * CV_STAGE + (CV_TAPS + 1) * CV_BN * 4 +
                      2 * CV_NS * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      int8_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int xt = (W + CV_BM - 1) / CV_BM, nt = (N + CV_BN - 1) / CV_BN;
  const long long tiles = (long long)B * H * xt * nt;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  int8_conv3x3_kernel<<<grid, CV_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<float*>(out), H, W, N, C, xt, nt,
      (int)tiles, slope);
  return (int)cudaGetLastError();
}

}  // extern "C"
