// Rel-pos attention kernels for Hopper (sm_90a), bf16 in, f32 softmax state.
//
// Replaces tmr_tpu/ops/pallas_attn.py:
//   tmr_global_attn  <- _attn_kernel / _attn_kernel_nobias (pallas_decomposed_attention)
//                       and _fused_attn_kernel (pallas_fused_attention): the same function
//   tmr_window_attn  <- _win_kernel (pallas_windowed_attention)
//
// Both compute softmax(q.k^T * scale + bias) . v per (batch*head) with the decomposed
// SAM rel-pos bias bias[q, (ky, kx)] = rel_h_q[q, ky] + rel_w_q[q, kx]; the f32 projections
// rel_h_q (BH, S, gh) / rel_w_q (BH, S, gw) are computed outside (the JAX _bias_projections).
//
// What bounds them on an H100: the global kernel does 4*S^2*D flops per head on tensor cores
// (206 GFLOP per call at 4096 tokens, batch 4, 12 heads) and moves only q/k/v/out plus the
// projections, so it is compute-bound; the windowed kernel (196 tokens) moves ~150 MB for
// ~12 GFLOP and is memory-bound. Design: q.k and p.v run on tensor cores through mma.sync
// m16n8k16 (bf16 -> f32) with ldmatrix operand loads (.trans for V); the online softmax
// keeps m/l/acc in registers (f32, exp2 domain) and no score tile ever leaves the SM. The
// global kernel is one CTA of 4 warps per (bh, 64-query tile) looping over 64-key tiles
// inside the block (the TPU's sequential "arbitrary" grid axis), with the next K/V tile
// streaming in by cp.async while the current one is consumed (double buffer); the bias for
// a tile is read from the q tile's projection strips, staged once in shared memory (when a
// tile is one token-grid row, gw == 64, the rel-h term is one value per query row). The
// windowed kernel is one CTA per (window, head): the whole 196-token window
// (padded to 256 rows, zero-filled) sits in shared memory, pad keys are masked to -inf in
// the kernel (the zero tokens window_partition adds are real keys and are not masked).
// Not yet: wgmma, TMA, warp specialisation (later work).

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
template <bool HAS_BIAS, bool MASK, bool ROW_TILE>
__device__ __forceinline__ void attend_tile(WarpState& st, const __nv_bfloat16* sK,
                                            const __nv_bfloat16* sV, int key0, int valid,
                                            float scale_log2, const float* rh0,
                                            const float* rh1, const float* rw0,
                                            const float* rw1, int gw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
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
      if (MASK && key >= valid) {
        v0 = -INFINITY;
        v1 = -INFINITY;
      } else if (HAS_BIAS && ROW_TILE) {
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

// Copy rows [0, nrows) of K and V (HD bf16 each) into row-major tiles of stride KSTR,
// zero-filling rows >= limit (zero V rows keep 0 * pad out of the sums).
__device__ __forceinline__ void stage_kv(const __nv_bfloat16* k, const __nv_bfloat16* v,
                                         int nrows, int limit, __nv_bfloat16* sK,
                                         __nv_bfloat16* sV) {
  for (int i = threadIdx.x; i < nrows * (HD / 8); i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (r < limit) {
      kv = *reinterpret_cast<const uint4*>(k + (size_t)r * HD + c);
      vv = *reinterpret_cast<const uint4*>(v + (size_t)r * HD + c);
    }
    *reinterpret_cast<uint4*>(sK + r * KSTR + c) = kv;
    *reinterpret_cast<uint4*>(sV + r * KSTR + c) = vv;
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
    attend_tile<HAS_BIAS, false, ROW_TILE>(
        st, sK + cb * BK * KSTR, sV + cb * BK * KSTR, kt * BK, S, scale_log2,
        rh0, rh1, sRw + lr0 * (gw + 8), sRw + (lr0 + 8) * (gw + 8), gw);
    __syncthreads();  // the buffer is refilled by the next iteration's prefetch
  }
  store_out(st, out + base + (size_t)(q0 + lr0) * HD, out + base + (size_t)(q0 + lr0 + 8) * HD,
            true, true);
}

__global__ void __launch_bounds__(128)
    window_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ rhq,
                       const float* __restrict__ rwq, __nv_bfloat16* __restrict__ out, int S,
                       int SP, int gh, int gw, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + SP * KSTR;
  float* sRh = reinterpret_cast<float*>(sV + SP * KSTR);
  float* sRw = sRh + S * (gh + 1);
  const int bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const size_t base = (size_t)bh * S * HD;
  stage_kv(k + base, v + base, SP, S, sK, sV);
  stage_proj(rhq + (size_t)bh * S * gh, 0, S, S, gh, gh + 1, sRh);
  stage_proj(rwq + (size_t)bh * S * gw, 0, S, S, gw, gw + 1, sRw);
  __syncthreads();
  for (int q0 = 0; q0 < S; q0 += BQ) {
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    if (q0 + warp * 16 >= S) continue;  // warp-uniform: all 16 rows are padding
    const bool ok0 = r0 < S, ok1 = r1 < S;
    WarpState st;
    load_q(st, q + base + (size_t)r0 * HD, q + base + (size_t)r1 * HD, ok0, ok1);
    const float* rh0 = sRh + (ok0 ? r0 : 0) * (gh + 1);
    const float* rh1 = sRh + (ok1 ? r1 : 0) * (gh + 1);
    const float* rw0 = sRw + (ok0 ? r0 : 0) * (gw + 1);
    const float* rw1 = sRw + (ok1 ? r1 : 0) * (gw + 1);
    for (int k0 = 0; k0 < SP; k0 += BK)
      attend_tile<true, true, false>(st, sK + k0 * KSTR, sV + k0 * KSTR, k0, S, scale_log2,
                                     rh0, rh1, rw0, rw1, gw);
    store_out(st, out + base + (size_t)r0 * HD, out + base + (size_t)r1 * HD, ok0, ok1);
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

// q/k/v/out: (BH, S, 64) bf16 contiguous with S = gh * gw window tokens; rhq (BH, S, gh),
// rwq (BH, S, gw) f32. One CTA per window-head; S is padded to a multiple of 64 in shared
// memory and the pad keys are masked.
int tmr_window_attn(const void* q, const void* k, const void* v, const void* rhq,
                    const void* rwq, void* out, int BH, int S, int gh, int gw, float scale,
                    void* stream) {
  const int SP = (S + 63) / 64 * 64;
  const size_t smem = (size_t)2 * SP * KSTR * 2 + (size_t)S * (gh + 1 + gw + 1) * 4;
  int e;
  if ((e = launch_prep(window_attn_kernel, smem))) return e;
  window_attn_kernel<<<BH, 128, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)rhq, (const float*)rwq, (__nv_bfloat16*)out, S, SP, gh, gw,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // extern "C"
