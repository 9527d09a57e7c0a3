// Rel-pos attention kernels for Hopper (sm_90a), bf16 in, f32 softmax state.
//
// Replaces tmr_tpu/ops/pallas_attn.py:
//   tmr_global_attn  <- _attn_kernel / _attn_kernel_nobias (pallas_decomposed_attention)
//                       and _fused_attn_kernel (pallas_fused_attention): the same function
//   tmr_window_attn  <- _win_kernel (pallas_windowed_attention)
//
// Both compute softmax(q.k^T * scale + bias) . v per (batch*head) with the decomposed
// SAM rel-pos bias bias[q, (ky, kx)] = rel_h_q[q, ky] + rel_w_q[q, kx], where
// rel_h_q[q, ky] = q . rh[y_q, ky] and rel_w_q[q, kx] = q . rw[x_q, kx] in f32 (the JAX
// _bias_projections). The global kernel takes the projections (BH, S, gh) / (BH, S, gw),
// computed outside; the windowed kernel takes the (gh, gh, 64) / (gw, gw, 64) tables and
// computes them itself.
//
// Global kernel. It does 4*S^2*D flops per head on tensor cores (206 GFLOP per call at
// 4096 tokens, batch 4, 12 heads) and moves only q/k/v/out plus the projections, so it is
// compute-bound. q.k and p.v run through mma.sync m16n8k16 (bf16 -> f32) with ldmatrix
// operand loads (.trans for V); the online softmax keeps m/l/acc in registers (f32, exp2
// domain) and no score tile leaves the SM. One CTA of 4 warps per (bh, 64-query tile) loops
// over 64-key tiles (the TPU's sequential "arbitrary" grid axis), the next K/V tile
// streaming in by cp.async while the current one is consumed; the bias of a tile is read
// from the q tile's projection strips, staged once in shared memory (when a tile is one
// token-grid row, gw == 64, the rel-h term is one value per query row). Not yet: wgmma,
// TMA, warp specialisation (later work).
//
// Windowed kernel (SAM: 14x14 windows, S = 196, BH = 4 * 25 * 12 = 1200 per block). Its
// bound is bytes: q, k, v in and out, bf16, 120 MB per call, 0.036 ms at 3.35 TB/s; its
// 11.8 GFLOP take 0.012 ms at the bf16 peak. The first design (one CTA of 4 warps per
// window-head) lost time in four places: (1) it staged the whole window by
// synchronous loads, 97 KB of shared memory, 2 CTAs and 8 warps per SM, no math before
// everything landed; (2) it padded keys and rows to 256, 1.7x the tensor work, with a
// fourth pass of 4 real rows that one warp ran alone; (3) each score paid a runtime
// key / gw divide, two scattered f32 shared reads and a LOG2E multiply; (4) its wrapper
// wrote an f32 copy of q and 26 MB of f32 projections to HBM, which the kernel read back.
// This design, one CTA of 8 warps per (window, head):
//  - Projections fused (4): after Q lands, the CTA computes rel_h_q / rel_w_q into shared
//    memory. The tokens of one grid row y share rh[y] (of one column x, rw[x]), so each is
//    a (tokens, 64) x (64, 14) product on the tensor cores: q is exact in bf16, the f32
//    table is split into bf16 hi + lo terms, the sums are f32, and LOG2E is folded in as
//    they are written. Table fragments are read through L1/L2 (every CTA reads the same
//    ~100 KB). K and V are still in flight by cp.async while this runs.
//  - No divide per score (3): key slots are laid out by grid row, each row padded to
//    GWP = 8, 16, 32 or 64 slots (16 for SAM: 224 slots), so a lane's 8-key n-tile is one
//    key row with compile-time columns. A lane keeps the rel-w values of its columns in
//    4 * GWP / 8 registers for the whole strip and reads one rel-h value per key row and
//    query row: the bias is one add and one FMA with the scale. Pad slots (columns >= gw,
//    and one pad key row when the row count must be even) get -inf from a -inf rel-w or
//    rel-h entry, so no mask instruction runs; their K and V rows are zero-filled. The zero
//    tokens window_partition adds are real keys.
//  - Padding to 16 (2): query rows are padded to 208 (13 strips of 16), keys to 224 (1.21x
//    the needed tensor work, against 1.71x); strips go round-robin to the 8 warps (5 warps
//    run 2, 3 run 1), and the other CTA on the SM fills the gap.
//  - Asynchronous staging and occupancy (1): Q, K and V arrive by 16-byte cp.async into
//    128-byte rows swizzled by (chunk ^ row % 8), conflict-free for ldmatrix with no
//    padding. Shared memory for 14x14: Q 26,624 + K 28,672 + V 28,672 + rel-h 12,480 +
//    rel-w 13,312 = 109,760 B; nvcc -Xptxas -v (sm_90a, NTW = 2): 128 registers, no
//    spills. So 2 CTAs (16 warps) are resident per SM, by registers and shared memory both.
// Keys are processed in chunks of 64 with online softmax (one pass over 224 keys would need
// ~110 score registers per thread). exp2 is the SFU's ex2.approx. Measured on the H100
// (PERF.md), the attention strips take most of the time, not HBM: counted per call,
// their K/V fragment reads from shared memory (every warp reads all of K and V for its 16
// rows), the mma.sync rate and the SFU's exp2 each need ~15-30 us. wgmma, where one
// warpgroup reads a K/V tile once for 64 rows, is the next step; it is not used here
// because 208 rows fill 64-row tiles poorly and the first goal was the library's time.
// Window rows up to 64 tokens and staging up to 227 KB (squares up to 16x16) are taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;     // head dim
constexpr int BQ = 64;     // query rows per CTA pass (4 warps x 16)
constexpr int BK = 64;     // keys per tile
constexpr int KSTR = 72;   // padded bf16 row stride of the K/V tiles (ldmatrix conflict free)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row l % 8 of
// matrix l / 8. Plain: lane (g, t) gets M[g][2t..2t+1]; .trans: M[2t..2t+1][g].
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct WarpState {
  uint32_t qf[4][4];  // Q fragments for the 4 head-dim chunks of 16
  float o[8][4];      // output accumulators, 8 head-dim n-tiles of 8
  float m[2];         // running max (log2 domain) of rows g and g+8
  float l[2];         // this thread's partial denominators of rows g and g+8
};

// Load this warp's 16 query rows (rows r0 and r0+8 for this lane) as mma A fragments.
__device__ __forceinline__ void load_q(WarpState& st, const __nv_bfloat16* qr0,
                                       const __nv_bfloat16* qr1, bool ok0, bool ok1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + 2 * t;
    st.qf[kc][0] = ok0 ? ld32(qr0 + c) : 0u;
    st.qf[kc][1] = ok1 ? ld32(qr1 + c) : 0u;
    st.qf[kc][2] = ok0 ? ld32(qr0 + c + 8) : 0u;
    st.qf[kc][3] = ok1 ? ld32(qr1 + c + 8) : 0u;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// One 64-key tile of online-softmax attention for this warp's 16 query rows, in the
// log2 domain (exp2 of scores pre-multiplied by log2 e). sK / sV: the tile's 64 key
// rows of K and V, row-major with stride KSTR; key0: index of the tile's first key.
// ROW_TILE: the tile is exactly one token-grid row (gw == BK), so the rel-h bias is one
// value per query row and the rel-w column is the key's column in the tile.
template <bool HAS_BIAS, bool ROW_TILE>
__device__ __forceinline__ void attend_tile(WarpState& st, const __nv_bfloat16* sK,
                                            const __nv_bfloat16* sV, int key0,
                                            float scale_log2, const float* rh0,
                                            const float* rh1, const float* rw0,
                                            const float* rw1, int gw) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix and row this lane addresses
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, sK + ((np * 2 + (lm >> 1)) * 8 + lr) * KSTR + kc * 16 + (lm & 1) * 8);
      mma_bf16(s[2 * np], st.qf[kc], b[0], b[1]);
      mma_bf16(s[2 * np + 1], st.qf[kc], b[2], b[3]);
    }
  }
  float rhv0 = 0.f, rhv1 = 0.f;
  if (HAS_BIAS && ROW_TILE) {
    rhv0 = rh0[key0 / gw];
    rhv1 = rh1[key0 / gw];
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n * 8 + 2 * t + j, key = key0 + col;
      float v0 = s[n][j] * scale_log2, v1 = s[n][2 + j] * scale_log2;
      if (HAS_BIAS && ROW_TILE) {
        // the rel-w columns of this thread are key columns n*8 + 2t + {0, 1}: one
        // 8-byte load per row (the strip's stride keeps them 8-byte aligned)
        const float2 w0 = *reinterpret_cast<const float2*>(rw0 + n * 8 + 2 * t);
        const float2 w1 = *reinterpret_cast<const float2*>(rw1 + n * 8 + 2 * t);
        v0 += (rhv0 + (j ? w0.y : w0.x)) * LOG2E;
        v1 += (rhv1 + (j ? w1.y : w1.x)) * LOG2E;
      } else if (HAS_BIAS) {
        const int ky = key / gw, kx = key - ky * gw;
        v0 += (rh0[ky] + rw0[kx]) * LOG2E;
        v1 += (rh1[ky] + rw1[kx]) * LOG2E;
      }
      s[n][j] = v0;
      s[n][2 + j] = v1;
      mx0 = fmaxf(mx0, v0);
      mx1 = fmaxf(mx1, v1);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(st.m[0], mx0), mn1 = fmaxf(st.m[1], mx1);
  const float a0 = exp2f(st.m[0] - mn0), a1 = exp2f(st.m[1] - mn1);
  st.m[0] = mn0;
  st.m[1] = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = exp2f(s[n][0] - mn0);
    s[n][1] = exp2f(s[n][1] - mn0);
    s[n][2] = exp2f(s[n][2] - mn1);
    s[n][3] = exp2f(s[n][3] - mn1);
    ps0 += s[n][0] + s[n][1];
    ps1 += s[n][2] + s[n][3];
  }
  st.l[0] = st.l[0] * a0 + ps0;
  st.l[1] = st.l[1] * a1 + ps1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    st.o[n][0] *= a0;
    st.o[n][1] *= a0;
    st.o[n][2] *= a1;
    st.o[n][3] *= a1;
  }
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
    a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
    a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, sV + (kc * 16 + (lm & 1) * 8 + lr) * KSTR + (dp * 2 + (lm >> 1)) * 8);
      mma_bf16(st.o[2 * dp], a, b[0], b[1]);
      mma_bf16(st.o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store_out(WarpState& st, __nv_bfloat16* or0, __nv_bfloat16* or1,
                                          bool ok0, bool ok1) {
  const int t = threadIdx.x & 3;
  float l0 = st.l[0], l1 = st.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(or0 + c) =
          __floats2bfloat162_rn(st.o[n][0] / l0, st.o[n][1] / l0);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(or1 + c) =
          __floats2bfloat162_rn(st.o[n][2] / l1, st.o[n][3] / l1);
  }
}

// Start the asynchronous copy of one 64-key tile of K and V (rows k0..k0+63).
__device__ __forceinline__ void issue_kv_tile(const __nv_bfloat16* k, const __nv_bfloat16* v,
                                              int k0, __nv_bfloat16* sK, __nv_bfloat16* sV) {
  for (int i = threadIdx.x; i < BK * (HD / 8); i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8;
    cp_async16(sK + r * KSTR + c, k + (size_t)(k0 + r) * HD + c);
    cp_async16(sV + r * KSTR + c, v + (size_t)(k0 + r) * HD + c);
  }
  cp_async_commit();
}

// Copy rows [r0, r0+nrows) of a (rows, width) f32 projection into shared memory with row
// stride `stride` (rows past `limit` are left unset: their results are discarded).
__device__ __forceinline__ void stage_proj(const float* src, int r0, int nrows, int limit,
                                           int width, int stride, float* dst) {
  for (int i = threadIdx.x; i < nrows * width; i += blockDim.x) {
    const int r = i / width, c = i - r * width;
    if (r0 + r < limit) dst[r * stride + c] = src[(size_t)(r0 + r) * width + c];
  }
}

template <bool HAS_BIAS, bool ROW_TILE>
__global__ void __launch_bounds__(128, 4)
    global_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ rhq,
                       const float* __restrict__ rwq, __nv_bfloat16* __restrict__ out, int S,
                       int gh, int gw, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 buffers x BK rows
  __nv_bfloat16* sV = sK + 2 * BK * KSTR;                        // 2 buffers x BK rows
  // bias strips of the q tile; with ROW_TILE the rel-h term is one value per row and
  // tile, read from global memory, and only the rel-w strip is staged (stride gw + 8:
  // 8-byte aligned rows, conflict-free float2 reads), which leaves room for 4 CTAs/SM
  float* sRh = reinterpret_cast<float*>(sV + 2 * BK * KSTR);
  float* sRw = ROW_TILE ? sRh : sRh + BQ * (gh + 1);
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const size_t base = (size_t)bh * S * HD;
  issue_kv_tile(k + base, v + base, 0, sK, sV);
  if (HAS_BIAS) {
    if (!ROW_TILE) stage_proj(rhq + (size_t)bh * S * gh, q0, BQ, S, gh, gh + 1, sRh);
    stage_proj(rwq + (size_t)bh * S * gw, q0, BQ, S, gw, gw + 8, sRw);
  }
  const int lr0 = warp * 16 + g;  // local rows lr0, lr0 + 8
  const float* rh0 = ROW_TILE ? rhq + ((size_t)bh * S + q0 + lr0) * gh : sRh + lr0 * (gh + 1);
  const float* rh1 = ROW_TILE ? rh0 + 8 * gh : rh0 + 8 * (gh + 1);
  WarpState st;
  load_q(st, q + base + (size_t)(q0 + lr0) * HD, q + base + (size_t)(q0 + lr0 + 8) * HD, true,
         true);
  const int nk = S / BK;
  for (int kt = 0; kt < nk; ++kt) {
    // double buffering: tile kt+1 streams in while tile kt is consumed
    if (kt + 1 < nk) {
      const int nb = (kt + 1) & 1;
      issue_kv_tile(k + base, v + base, (kt + 1) * BK, sK + nb * BK * KSTR,
                    sV + nb * BK * KSTR);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cb = kt & 1;
    attend_tile<HAS_BIAS, ROW_TILE>(
        st, sK + cb * BK * KSTR, sV + cb * BK * KSTR, kt * BK, scale_log2,
        rh0, rh1, sRw + lr0 * (gw + 8), sRw + (lr0 + 8) * (gw + 8), gw);
    __syncthreads();  // the buffer is refilled by the next iteration's prefetch
  }
  store_out(st, out + base + (size_t)(q0 + lr0) * HD, out + base + (size_t)(q0 + lr0 + 8) * HD,
            true, true);
}

// ---- windowed attention ------------------------------------------------------------------

constexpr int WIN_WARPS = 8;  // 256 threads per (window, head) CTA

// Row-swizzled (rows, 64) bf16 tile, rows of 128 bytes: the 16-byte chunk c of row r lives
// at chunk c ^ (r & 7), so the 8 rows an ldmatrix phase reads sit in 8 distinct bank groups
// without padding the rows.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * HD + ((chunk ^ (row & 7)) << 3);
}

// cp.async of 16 bytes that writes zeros when `bytes` is 0 (the source is not read then).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 2^x by the SFU's ex2.approx (about 2 ulp; -inf -> +0), one instruction where
// exp2f adds range handling
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16 hi/lo split of two f32 values: x = hi + lo + O(2^-18 |x|).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// The bias projections of one (window, head), f32, into shared memory, pre-multiplied by
// log2 e: sRH[t][ky] = q_t . rh[y_t, ky] and sRW[t][kx] = q_t . rw[x_t, kx]. All tokens of
// one grid row y share the matrix rh[y] (and of one column x, rw[x]), so each is a small
// product (tokens of the row or column, 64) x (64, gh or gw) on the tensor cores: q is bf16
// and exact as an mma operand, the f32 table is split into bf16 hi + lo terms, the sums are
// f32. The A rows are gathered by ldmatrix (one row address per lane); the B fragments are
// read straight from the tables (L1/L2: every CTA of the call reads the same ~50 KB).
__device__ __forceinline__ void window_projections(const __nv_bfloat16* sQ, const float* rh,
                                                   const float* rw, float* sRH, float* sRW,
                                                   int gh, int gw, int st_h, int st_w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int mt_h = (gw + 15) >> 4, mt_w = (gh + 15) >> 4;  // 16-token tiles per group
  const int nh = gh * mt_h, units = nh + gw * mt_w;
  for (int u = warp; u < units; u += WIN_WARPS) {
    const bool is_h = u < nh;
    const int uu = is_h ? u : u - nh, mt_n = is_h ? mt_h : mt_w;
    const int grp = uu / mt_n, m0 = (uu - grp * mt_n) * 16;
    // group grp: tokens tok0 + i * tstep for i < nrows; output columns ncols
    const int nrows = is_h ? gw : gh, ncols = is_h ? gh : gw;
    const int tok0 = is_h ? grp * gw : grp, tstep = is_h ? 1 : gw;
    const float* tab = (is_h ? rh : rw) + (size_t)grp * ncols * HD;
    float* dst = is_h ? sRH : sRW;
    const int st = is_h ? st_h : st_w;
    uint32_t a[4][4];
    const int ai = min(m0 + (lm & 1) * 8 + lr, nrows - 1);  // pad rows repeat a real one
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], sQ + swz(tok0 + ai * tstep, kk * 2 + (lm >> 1)));
    for (int n0 = 0; n0 < ncols; n0 += 16) {  // two n-tiles: 16 table loads in flight
      float2 x[2][4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 8 * h + g;
        const float* brow = tab + (size_t)min(col, ncols - 1) * HD + 2 * t;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          x[h][kk][0] = *reinterpret_cast<const float2*>(brow + kk * 16);
          x[h][kk][1] = *reinterpret_cast<const float2*>(brow + kk * 16 + 8);
          if (col >= ncols) x[h][kk][0] = x[h][kk][1] = make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (n0 + 8 * h >= ncols) break;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t h0, l0, h1, l1;
          split_bf16(x[h][kk][0].x, x[h][kk][0].y, h0, l0);
          split_bf16(x[h][kk][1].x, x[h][kk][1].y, h1, l1);
          mma_bf16(c, a[kk], l0, l1);
          mma_bf16(c, a[kk], h0, h1);
        }
        const int c0 = n0 + 8 * h + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = m0 + g + 8 * r;
          if (i >= nrows) continue;
          float* row = dst + (tok0 + i * tstep) * st;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (c0 + j < ncols) row[c0 + j] = c[2 * r + j] * LOG2E;
        }
      }
    }
  }
}

// One chunk of NT key n-tiles (NT / NTW whole key-grid rows from key row ky) of online-
// softmax attention for this warp's 16 query rows. Key slots are grid-ordered with rows of
// GWP = 8 NTW slots, so n-tile n of the chunk is key row ky + n / NTW, columns
// 8 (n % NTW) + 2t + {0, 1} for this lane: the bias of a score is this lane's rel-h value of
// that key row (one shared read per row and key row) plus one of its 4 NTW rel-w registers.
// Pad slots carry a -inf rel-w (columns >= gw) or rel-h (the pad key row) and fall out.
template <int NTW, int NT>
__device__ __forceinline__ void window_chunk(WarpState& st, const __nv_bfloat16* sK,
                                             const __nv_bfloat16* sV, int ky,
                                             const float* rh0, const float* rh1,
                                             const float (&rw0)[NTW][2],
                                             const float (&rw1)[NTW][2], float scale_log2) {
  const int lane = threadIdx.x & 31, lm = lane >> 3, lr = lane & 7;
  const int key0 = ky * 8 * NTW;
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, sK + swz(key0 + np * 16 + (lm >> 1) * 8 + lr, kk * 2 + (lm & 1)));
      mma_bf16(s[2 * np], st.qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], st.qf[kk], b[2], b[3]);
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY, h0 = 0.f, h1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int m = n % NTW;
    if (m == 0) {
      h0 = rh0[ky + n / NTW];
      h1 = rh1[ky + n / NTW];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[n][j] = fmaf(s[n][j], scale_log2, h0 + rw0[m][j]);
      s[n][2 + j] = fmaf(s[n][2 + j], scale_log2, h1 + rw1[m][j]);
      mx0 = fmaxf(mx0, s[n][j]);
      mx1 = fmaxf(mx1, s[n][2 + j]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(st.m[0], mx0), mn1 = fmaxf(st.m[1], mx1);
  const float a0 = ex2(st.m[0] - mn0), a1 = ex2(st.m[1] - mn1);
  st.m[0] = mn0;
  st.m[1] = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = ex2(s[n][0] - mn0);
    s[n][1] = ex2(s[n][1] - mn0);
    s[n][2] = ex2(s[n][2] - mn1);
    s[n][3] = ex2(s[n][3] - mn1);
    ps0 += s[n][0] + s[n][1];
    ps1 += s[n][2] + s[n][3];
  }
  st.l[0] = st.l[0] * a0 + ps0;
  st.l[1] = st.l[1] * a1 + ps1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    st.o[n][0] *= a0;
    st.o[n][1] *= a0;
    st.o[n][2] *= a1;
    st.o[n][3] *= a1;
  }
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
    a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
    a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, sV + swz(key0 + kc * 16 + (lm & 1) * 8 + lr, dp * 2 + (lm >> 1)));
      mma_bf16(st.o[2 * dp], a, b[0], b[1]);
      mma_bf16(st.o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// One CTA per (window, head): q/k/v/out (BH, S, 64) bf16, S = gh * gw; rh (gh, gh, 64) and
// rw (gw, gw, 64) f32, the get_rel_pos tables. Shared memory: Q (sp rows), K and V (ghp
// key rows of GWP slots each), all row-swizzled bf16; sRH (sp, st_h) and sRW (sp, GWP) f32.
template <int NTW>
__global__ void __launch_bounds__(WIN_WARPS * 32, 2)
    window_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ rh,
                       const float* __restrict__ rw, __nv_bfloat16* __restrict__ out, int S,
                       int gh, int gw, int ghp, int sp, int st_h, float scale_log2) {
  constexpr int GWP = 8 * NTW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nkey = ghp * GWP;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + sp * HD;
  __nv_bfloat16* sV = sK + nkey * HD;
  float* sRH = reinterpret_cast<float*>(sV + nkey * HD);
  float* sRW = sRH + sp * st_h;
  const size_t base = (size_t)blockIdx.x * S * HD;
  // Q, then K and V in key-slot order, all by cp.async (pad rows and slots zero-filled:
  // zero K and V keep the masked slots finite and out of the sums)
  for (int i = threadIdx.x; i < sp * 8; i += blockDim.x) {
    const int r = i >> 3, c = i & 7;
    cp_async16_zfill(sQ + swz(r, c), q + base + (size_t)min(r, S - 1) * HD + c * 8,
                     r < S ? 16 : 0);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < nkey * 8; i += blockDim.x) {
    const int j = i >> 3, c = i & 7, ky = j / GWP, kx = j % GWP;
    const bool ok = ky < gh && kx < gw;
    const size_t src = base + (size_t)(ok ? ky * gw + kx : 0) * HD + c * 8;
    cp_async16_zfill(sK + swz(j, c), k + src, ok ? 16 : 0);
    cp_async16_zfill(sV + swz(j, c), v + src, ok ? 16 : 0);
  }
  cp_async_commit();
  // the -inf columns of the pad slots: rel-w columns gw..GWP-1, the rel-h column of the
  // pad key row (ghp > gh)
  for (int i = threadIdx.x; i < sp * (GWP - gw); i += blockDim.x) {
    const int r = i / (GWP - gw);
    sRW[r * GWP + gw + (i - r * (GWP - gw))] = -INFINITY;
  }
  for (int r = threadIdx.x; r < sp; r += blockDim.x) sRH[r * st_h + gh] = -INFINITY;
  cp_async_wait<1>();
  __syncthreads();  // Q has landed; K and V are still in flight under the projections
  window_projections(sQ, rh, rw, sRH, sRW, gh, gw, st_h, GWP);
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  constexpr int CROWS = 8 / NTW;  // key rows per chunk of 8 n-tiles
  for (int strip = warp; strip * 16 < sp; strip += WIN_WARPS) {
    const int r0 = strip * 16 + g, r1 = r0 + 8;
    WarpState st;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(st.qf[kk], sQ + swz(strip * 16 + (lm & 1) * 8 + lr, kk * 2 + (lm >> 1)));
#pragma unroll
    for (int n = 0; n < 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
    st.m[0] = st.m[1] = -INFINITY;
    st.l[0] = st.l[1] = 0.f;
    float rw0[NTW][2], rw1[NTW][2];
#pragma unroll
    for (int m = 0; m < NTW; ++m) {
      const float2 w0 = *reinterpret_cast<const float2*>(sRW + r0 * GWP + 8 * m + 2 * t);
      const float2 w1 = *reinterpret_cast<const float2*>(sRW + r1 * GWP + 8 * m + 2 * t);
      rw0[m][0] = w0.x;
      rw0[m][1] = w0.y;
      rw1[m][0] = w1.x;
      rw1[m][1] = w1.y;
    }
    const float* rh0 = sRH + r0 * st_h;
    const float* rh1 = sRH + r1 * st_h;
    int ky = 0;
    for (; ky + CROWS <= ghp; ky += CROWS)
      window_chunk<NTW, 8>(st, sK, sV, ky, rh0, rh1, rw0, rw1, scale_log2);
    switch ((ghp - ky) * NTW) {  // the last chunk: 2, 4 or 6 n-tiles (ghp * NTW is even)
      case 2: window_chunk<NTW, 2>(st, sK, sV, ky, rh0, rh1, rw0, rw1, scale_log2); break;
      case 4: window_chunk<NTW, 4>(st, sK, sV, ky, rh0, rh1, rw0, rw1, scale_log2); break;
      case 6: window_chunk<NTW, 6>(st, sK, sV, ky, rh0, rh1, rw0, rw1, scale_log2); break;
      default: break;
    }
    store_out(st, out + base + (size_t)r0 * HD, out + base + (size_t)r1 * HD, r0 < S, r1 < S);
  }
}

template <typename K>
int launch_prep(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <bool HAS_BIAS, bool ROW_TILE>
int launch_global(const void* q, const void* k, const void* v, const void* rhq,
                  const void* rwq, void* out, int BH, int S, int gh, int gw, float scale,
                  cudaStream_t st) {
  const size_t smem =
      (size_t)4 * BK * KSTR * 2 +
      (HAS_BIAS ? (size_t)BQ * ((ROW_TILE ? 0 : gh + 1) + gw + 8) * 4 : 0);
  int e;
  if ((e = launch_prep(global_attn_kernel<HAS_BIAS, ROW_TILE>, smem))) return e;
  global_attn_kernel<HAS_BIAS, ROW_TILE><<<dim3(S / BQ, BH), 128, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)rhq, (const float*)rwq, (__nv_bfloat16*)out, S, gh, gw, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int NTW>
int launch_window(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                  void* out, int BH, int S, int gh, int gw, float scale, cudaStream_t st) {
  // geometry mirrored by tmr_tpu_torch/ops/cuda_attn.py window_geometry
  const int gwp = 8 * NTW, ghp = gh + ((gh * NTW) & 1), sp = (S + 15) / 16 * 16;
  const int st_h = (gh + 1) | 1;
  const size_t smem = (size_t)(sp + 2 * ghp * gwp) * HD * 2 + (size_t)sp * (st_h + gwp) * 4;
  int e;
  if ((e = launch_prep(window_attn_kernel<NTW>, smem))) return e;
  window_attn_kernel<NTW><<<BH, WIN_WARPS * 32, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)rh, (const float*)rw, (__nv_bfloat16*)out, S, gh, gw, ghp, sp, st_h,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/out: (BH, S, 64) bf16 contiguous; rhq (BH, S, gh), rwq (BH, S, gw) f32 or null
// when has_bias == 0. Requires S % 64 == 0. Returns the CUDA error code (0 = launched).
int tmr_global_attn(const void* q, const void* k, const void* v, const void* rhq,
                    const void* rwq, void* out, int BH, int S, int gh, int gw, float scale,
                    int has_bias, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!has_bias)
    return launch_global<false, false>(q, k, v, nullptr, nullptr, out, BH, S, 1, 1, scale, st);
  if (gw == BK)
    return launch_global<true, true>(q, k, v, rhq, rwq, out, BH, S, gh, gw, scale, st);
  return launch_global<true, false>(q, k, v, rhq, rwq, out, BH, S, gh, gw, scale, st);
}

// q/k/v/out: (BH, S, 64) bf16 contiguous with S = gh * gw window tokens; rh (gh, gh, 64)
// and rw (gw, gw, 64) f32 contiguous, the get_rel_pos tables. One CTA per window-head; rows
// of up to 64 tokens (gw <= 64). Returns the CUDA error code (0 = launched).
int tmr_window_attn(const void* q, const void* k, const void* v, const void* rh,
                    const void* rw, void* out, int BH, int S, int gh, int gw, float scale,
                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (gw <= 8) return launch_window<1>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  if (gw <= 16) return launch_window<2>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  if (gw <= 32) return launch_window<4>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  if (gw <= 64) return launch_window<8>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
