// int8 x int8 -> int32 matrix product with an f32 scale epilogue, for Hopper (sm_90a).
//
// Replaces tmr_tpu/ops/pallas_int8.py _int8_mm_kernel (int8_matmul):
//   out[m, n] = float(sum_k x[m, k] * w[n, k]) * (sx[m] * sw[n])
// with the sum exact in int32 and the epilogue rounded as the Pallas kernel rounds it
// (int -> f32 conversion, then one multiply by sx * sw).
//
// What bounds it on an H100: one 3x3 tap of the int8 decoder tail is a (65536 x 1024) x
// (1024 x 2048) product, 2.75e11 int8 operations (0.14 ms at 1979 TOPS) that write a
// 537 MB f32 result (0.16 ms at 3.35 TB/s): the bytes of the output, and then the
// tensor-core rate. Design (right first, not yet fast):
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
//   a 3x3 tap reads its shifted window [:, dy:dy+H, dx:dx+W, :] of the padded NHWC
//   activation in place, without nine 67 MB copies;
// - N <= 8 (the 1x1 heads, N = 5) takes a 128 x 8 tile: one n8 column of mma.
// Not yet: wgmma, TMA, a multi-stage pipeline, fusing the taps (later work).

#include <cuda_runtime.h>
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

}  // extern "C"
