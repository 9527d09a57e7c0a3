// Rel-pos attention in f32 for Hopper (sm_90a): 3xTF32 products on the tensor cores, f32
// softmax state. The f32 instantiations of csrc/attn.cu's two functions, for
// compute_dtype="float32".
//
// Replaces, for f32 operands, tmr_tpu/ops/pallas_attn.py:
//   tmr_global_attn_f32  <- _attn_kernel (pallas_decomposed_attention) and
//                           _fused_attn_kernel (pallas_fused_attention): the same function
//   tmr_window_attn_f32  <- _win_kernel (pallas_windowed_attention)
// The JAX kernels run any dtype: under compute_dtype="float32" their dots take f32
// operands into f32 sums, and p.astype(v.dtype) is a no-op, so p stays f32 for p.v. Both
// entries compute softmax(q.k^T * scale + bias) . v per (batch*head) with the decomposed
// SAM bias bias[q, (ky, kx)] = rel_h_q[q, ky] + rel_w_q[q, kx], rel_h_q[q, ky] = q .
// rh[y_q, ky] and rel_w_q[q, kx] = q . rw[x_q, kx] (the JAX _bias_projections); the global
// entry reads the compact (2g - 1, D) tables (rh[y, ky] = R_h[y - ky + g - 1]), the
// windowed one the expanded (g, g, D) tables. Head dims 64 (SAM ViT-B) and 80 (ViT-H).
// No bias-free variant: SAM always has the bias.
//
// What bounds it on an H100: the products, 4 S^2 D flops per head, each f32 product taken
// as three TF32 products (3xTF32) at the 495 TFLOP/s TF32 dense peak: global attention at
// 64x64 tokens, BH 48, D 64 is 206 GFLOP, 1.25 ms as 3xTF32; at D 80, BH 64, 344 GFLOP,
// 2.08 ms; on the 1536 bucket's 96x96 tokens, BH 48, 1.04 TFLOP, 6.33 ms. The windowed
// blocks (14x14, BH 1200 at D 64 and 1600 at D 80) do 11.8 / 19.7 GFLOP, 0.072 / 0.120 ms,
// about the time their f32 bytes (q, k, v in and out once: 241 / 401 MB) take at 3.35 TB/s.
// On the CUDA cores at 67 TFLOP/s the products would take 2.5x the 3xTF32 bound.
//
// Why 3xTF32: the plain version and the JAX reference are exact f32. One TF32 product keeps
// 11 bits of each operand and misses an f32-grade bound (2e-5 of the output's max) by
// about 15x, as kernel 5's check showed; every operand x is split into hi = tf32(x) and lo
// = tf32(x - hi), and a product is lo*hi + hi*lo + hi*hi in f32 sums, about 2^-21 per
// product. The bf16 kernels' exact bf16 q against a hi/lo table does not carry over: an
// f32 q is not exact in TF32.
//
// Design (simple first; wgmma and TMA are later work):
//  - One CTA of 4 warps per (batch*head, 64 query rows), each warp 16 query rows; keys in
//    tiles of 32, double-buffered in shared memory by 16-byte cp.async (rows of D + 4
//    floats: every fragment read below hits 32 distinct banks), zero-filled past S.
//  - Bias projections inside: after Q lands, thread r of each half of the CTA computes
//    its query row's rel-h (first half) or rel-w (second half) terms as f32 FMAs on the
//    CUDA cores from the tables in L1/L2, times log2 e, into shared memory; (gh + gw) D
//    products a row, 2% of the attention's products at 64x64 and 7% at 14x14, as exact as
//    f32 sums get, while the second K/V tile is in flight. Pad query rows get 0.
//  - q.k: mma.sync m16n8k8 TF32, Q's fragments split and scaled by scale * log2 e once and
//    held in registers (hi and lo: 2 D / 2 registers), K's split as they are read.
//    Each n8 tile of scores starts a fresh accumulator: the tensor cores' f32
//    accumulation truncates, and a chain stays as short as kernel 5's.
//  - Softmax: online over the key tiles in f32 (max, rescale, sum), ex2.approx; the bias
//    is two shared reads per score, each key's (ky, kx) stepped from one divide a tile;
//    keys past S get -inf.
//  - p.v: p (f32) is split into hi and lo in place. The k order of a block is permuted
//    (slot t holds key 2t, slot t + 4 key 2t + 1, in both A and B), so the q.k
//    accumulator's registers are p.v's A fragment as they stand. Each 8-column output
//    tile takes the tile's four k-blocks in a fresh accumulator, then o = o * alpha + acc
//    with a rounded FMA: no mma chain runs through the whole key axis.
//  - Non-finite inputs: hi is taken by cvt.rna.tf32.f32, which keeps a NaN or an infinity
//    (the integer rounding of kernel 5 would carry a NaN's mantissa into the sign), lo by
//    integer ops.
// Shared memory: (64 + 4 x 32) rows of D + 4 floats plus 64 x ((gh | 1) + (gw | 1)) f32
// projections: 85.5 KB at 64x64, D 64; 114 KB at 96x96, D 80; 60 KB for 14x14 windows.
// Mirrored by tmr_tpu_torch/ops/cuda_attn.py geometry_f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ERR_ARGUMENT = 2000;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows of a CTA
constexpr int BK = 32;          // keys of a tile
constexpr size_t SMEM_LIMIT = 227 * 1024;

// shared bytes for head dim d and projection row strides sth, stw
inline size_t smem_bytes(int d, int sth, int stw) {
  return ((size_t)(BQ + 4 * BK) * (d + 4) + (size_t)BQ * (sth + stw)) * sizeof(float);
}

// cvt.rna.tf32.f32 (nearest, ties away) as integer ops: half a tf32 ulp added to the
// magnitude bits, the low 13 bits cleared; equal to the cvt for finite values
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + O(2^-22 |x|), both tf32. hi by the cvt, so a NaN or an infinity stays one
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
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

// lo * hi + hi * lo + hi * hi of one k-block, the small terms first
template <bool FIRST>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split_tf32(b0, b0h, b0l);
  split_tf32(b1, b1h, b1l);
  mma_tf32<FIRST>(c, al, b0h, b1h);
  mma_tf32<false>(c, ah, b0l, b1l);
  mma_tf32<false>(c, ah, b0h, b1h);
}

// 2^x by the SFU's ex2.approx (about 2 ulp; -inf -> +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, zero-filled where !ok (src-size 0: the source is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + rows) of a (S, D) matrix into shared rows of D + 4 floats; rows past
// S are zero-filled
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0, int rows,
                                      int S) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * (D + 4) + 4 * c, ok ? src + (size_t)(row0 + r) * D + 4 * c : src,
               ok);
  }
}

template <int D, bool COMPACT>
__global__ void __launch_bounds__(THREADS)
    attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ th,
                    const float* __restrict__ tw, float* __restrict__ out, int S, int gh,
                    int gw, int sth, int stw, float qk_scale) {
  constexpr int LD = D + 4, KB = D / 8;  // row pitch; k-blocks of q.k = n-tiles of p.v
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;               // BQ x LD
  float* sK = sQ + BQ * LD;       // 2 x BK x LD
  float* sV = sK + 2 * BK * LD;   // 2 x BK x LD
  float* sH = sV + 2 * BK * LD;   // BQ x sth: rel_h_q x log2 e
  float* sW = sH + BQ * sth;      // BQ x stw: rel_w_q x log2 e
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = (S + BK - 1) / BK;

  stage<D>(sQ, qb, q0, BQ, S);
  stage<D>(sK, kb, 0, BK, S);
  stage<D>(sV, vb, 0, BK, S);
  cp_async_commit();
  if (nt > 1) {
    stage<D>(sK + BK * LD, kb, BK, BK, S);
    stage<D>(sV + BK * LD, vb, BK, BK, S);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // projections: the first BQ threads rel-h of their row, the others rel-w
  {
    const int r = tid % BQ, row = q0 + r;
    const bool w_half = tid >= BQ;
    const int n = w_half ? gw : gh;
    float* dst = (w_half ? sW : sH) + r * (w_half ? stw : sth);
    if (row < S) {
      const int y = row / gw, x = row - y * gw, pos = w_half ? x : y;
      const float* tab = w_half ? tw : th;
      float qr[D];
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 f = *reinterpret_cast<const float4*>(sQ + r * LD + d);
        qr[d] = f.x, qr[d + 1] = f.y, qr[d + 2] = f.z, qr[d + 3] = f.w;
      }
      for (int c = 0; c < n; ++c) {
        const float* tr = COMPACT ? tab + (size_t)(pos - c + n - 1) * D
                                  : tab + ((size_t)pos * n + c) * D;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(tr + d));
          acc = fmaf(qr[d], f.x, acc);
          acc = fmaf(qr[d + 1], f.y, acc);
          acc = fmaf(qr[d + 2], f.z, acc);
          acc = fmaf(qr[d + 3], f.w, acc);
        }
        dst[c] = acc * LOG2E;
      }
    } else {
      for (int c = 0; c < n; ++c) dst[c] = 0.f;
    }
  }
  __syncthreads();

  const int r0 = warp * 16;
  const bool active = q0 + r0 < S;  // a strip wholly past S only keeps the barriers
  // Q's A fragments, x scale x log2 e, split: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
  // a3 (g + 8, t + 4) of each k-block
  uint32_t qh[KB][4], ql[KB][4];
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    const float* p = sQ + (r0 + g) * LD + i * 8 + t;
    const float a[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(a[j] * qk_scale, qh[i][j], ql[i][j]);
  }
  float o[KB][4];
#pragma unroll
  for (int i = 0; i < KB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float* h0 = sH + (r0 + g) * sth;
  const float* h1 = h0 + 8 * sth;
  const float* w0 = sW + (r0 + g) * stw;
  const float* w1 = w0 + 8 * stw;

  for (int kt = 0; kt < nt; ++kt) {
    if (kt > 0) {
      cp_async_wait<1>();  // tile kt landed; tile kt + 1 may be in flight
      __syncthreads();
    }
    const float* cK = sK + (kt & 1) * BK * LD;
    const float* cV = sV + (kt & 1) * BK * LD;
    if (active) {
      // scores of 4 n8 tiles: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
      float s[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float* kp = cK + (nb * 8 + g) * LD + t;
        mma_3xtf32<true>(s[nb], qh[0], ql[0], kp[0], kp[4]);
#pragma unroll
        for (int i = 1; i < KB; ++i)
          mma_3xtf32<false>(s[nb], qh[i], ql[i], kp[8 * i], kp[8 * i + 4]);
      }
      // the bias, -inf past S, the rows' max
      const int j0 = kt * BK + 2 * t;
      int ky = j0 / gw, kx = j0 - ky * gw;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (j0 + nb * 8 + e < S) {
            s[nb][e] += h0[ky] + w0[kx];
            s[nb][2 + e] += h1[ky] + w1[kx];
          } else {
            s[nb][e] = s[nb][2 + e] = -INFINITY;
          }
          mx0 = fmaxf(mx0, s[nb][e]);
          mx1 = fmaxf(mx1, s[nb][2 + e]);
          kx += e == 0 ? 1 : 7;  // to key 2t + 1, then to the next tile's 2t
          while (kx >= gw) kx -= gw, ++ky;
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
      m0 = mx0, m1 = mx1;
      l0 *= alpha0, l1 *= alpha1;
      // p, split, as p.v's A fragments: key 2t in slot t, key 2t + 1 in slot t + 4
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float p0 = ex2(s[nb][0] - mx0), p1 = ex2(s[nb][1] - mx0);
        const float p2 = ex2(s[nb][2] - mx1), p3 = ex2(s[nb][3] - mx1);
        l0 += p0 + p1, l1 += p2 + p3;
        split_tf32(p0, ph[nb][0], pl[nb][0]);
        split_tf32(p2, ph[nb][1], pl[nb][1]);
        split_tf32(p1, ph[nb][2], pl[nb][2]);
        split_tf32(p3, ph[nb][3], pl[nb][3]);
      }
      // p.v: B of k-block nb, n-tile dn is V[key nb*8 + 2t (+1)][dn*8 + g]
#pragma unroll
      for (int dn = 0; dn < KB; ++dn) {
        float c[4];
        const float* vp = cV + 2 * t * LD + dn * 8 + g;
        mma_3xtf32<true>(c, ph[0], pl[0], vp[0], vp[LD]);
#pragma unroll
        for (int nb = 1; nb < 4; ++nb)
          mma_3xtf32<false>(c, ph[nb], pl[nb], vp[8 * nb * LD], vp[(8 * nb + 1) * LD]);
        o[dn][0] = fmaf(o[dn][0], alpha0, c[0]);
        o[dn][1] = fmaf(o[dn][1], alpha0, c[1]);
        o[dn][2] = fmaf(o[dn][2], alpha1, c[2]);
        o[dn][3] = fmaf(o[dn][3], alpha1, c[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer kt & 1
    if (kt + 2 < nt) {
      stage<D>(sK + (kt & 1) * BK * LD, kb, (kt + 2) * BK, BK, S);
      stage<D>(sV + (kt & 1) * BK * LD, vb, (kt + 2) * BK, BK, S);
    }
    cp_async_commit();  // one group a tile, empty or not, so wait<1> stays right
  }

  if (!active) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  float* ob = out + base;
#pragma unroll
  for (int dn = 0; dn < KB; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<float2*>(ob + (size_t)row0 * D + col) =
          make_float2(__fdiv_rn(o[dn][0], l0), __fdiv_rn(o[dn][1], l0));
    if (row1 < S)
      *reinterpret_cast<float2*>(ob + (size_t)row1 * D + col) =
          make_float2(__fdiv_rn(o[dn][2], l1), __fdiv_rn(o[dn][3], l1));
  }
}

template <int D, bool COMPACT>
int launch(const void* q, const void* k, const void* v, const void* th, const void* tw,
           void* out, int BH, int S, int gh, int gw, float scale, cudaStream_t st) {
  if (BH < 1 || BH > 65535 || gh < 1 || gw < 1 || S != gh * gw) return ERR_ARGUMENT;
  // geometry mirrored by tmr_tpu_torch/ops/cuda_attn.py geometry_f32
  const int sth = gh | 1, stw = gw | 1;
  const size_t smem = smem_bytes(D, sth, stw);
  if (smem > SMEM_LIMIT) return ERR_ARGUMENT;
  auto kernel = attn_f32_kernel<D, COMPACT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((S + BQ - 1) / BQ, BH), THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)th, (const float*)tw,
      (float*)out, S, gh, gw, sth, stw, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/out: (BH, S, D) f32 contiguous, 16-byte aligned, over a (gh, gw) token grid, S =
// gh * gw, D = 64 or 80; rph (2gh - 1, D) and rpw (2gw - 1, D) f32 contiguous, the compact
// rel-pos tables. Returns 0 when launched, a CUDA error code, or 2000 for a head dim, a
// shape or a grid whose projections do not fit shared memory.
int tmr_global_attn_f32(const void* q, const void* k, const void* v, const void* rph,
                        const void* rpw, void* out, int BH, int S, int gh, int gw, int D,
                        float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64, true>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, st);
  if (D == 80) return launch<80, true>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, st);
  return ERR_ARGUMENT;
}

// q/k/v/out: (BH, S, D) f32 contiguous, 16-byte aligned, with S = gh * gw window tokens, D
// = 64 or 80; rh (gh, gh, D) and rw (gw, gw, D) f32 contiguous, the get_rel_pos tables.
// Returns 0 when launched, a CUDA error code, or 2000 for an argument the kernel does not
// take.
int tmr_window_attn_f32(const void* q, const void* k, const void* v, const void* rh,
                        const void* rw, void* out, int BH, int S, int gh, int gw, int D,
                        float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64, false>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  if (D == 80) return launch<80, false>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  return ERR_ARGUMENT;
}

}  // extern "C"
