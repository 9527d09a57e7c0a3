// Rel-pos attention in f32 for Hopper (sm_90a): 3xTF32 products by wgmma, f32 softmax
// state. The f32 instantiations of csrc/attn.cu's functions, for compute_dtype="float32".
//
// Replaces, for f32 operands, tmr_tpu/ops/pallas_attn.py:
//   tmr_global_attn_f32  <- _attn_kernel and _fused_attn_kernel (with the bias: the same
//                           function) and _attn_kernel_nobias (has_bias == 0)
//   tmr_window_attn_f32  <- _win_kernel (pallas_windowed_attention)
// The JAX kernels run any dtype: under compute_dtype="float32" their dots take f32
// operands into f32 sums, and p.astype(v.dtype) is a no-op, so p stays f32 for p.v. Both
// entries compute softmax(q.k^T * scale + bias) . v per (batch*head), with the decomposed
// SAM bias bias[q, (ky, kx)] = rel_h_q[q, ky] + rel_w_q[q, kx], rel_h_q[q, ky] = q .
// rh[y_q, ky] and rel_w_q[q, kx] = q . rw[x_q, kx] (the JAX _bias_projections), or none;
// the global entry reads the compact (2g - 1, D) tables (rh[y, ky] = R_h[y - ky + g - 1]),
// the windowed one the expanded (g, g, D) tables. Without the bias nothing depends on the
// grid, so Attention(use_rel_pos=False) sends its windowed blocks to the global entry
// over the window's tokens. Head dims 64 (SAM ViT-B) and 80 (ViT-H).
//
// What bounds it on an H100: the products, 4 S^2 D flops per head, each f32 product taken
// as three TF32 products (3xTF32) at the 495 TFLOP/s TF32 dense peak: global attention at
// 64x64 tokens, BH 48, D 64 is 206 GFLOP, 1.25 ms as 3xTF32; at D 80, BH 64, 344 GFLOP,
// 2.08 ms; on the 1536 bucket's 96x96 tokens, BH 48, 1.04 TFLOP, 6.33 ms. The windowed
// blocks (14x14, BH 1200 at D 64 and 1600 at D 80) do 11.8 / 19.7 GFLOP, 0.072 / 0.120 ms,
// about the time their f32 bytes (q, k, v in and out once: 241 / 401 MB) take at 3.35 TB/s.
//
// Why 3xTF32: the plain version and the JAX reference are exact f32; one TF32 product
// keeps 11 bits of each operand and misses an f32-grade bound (2e-5 of the output's max)
// by about 15x. Every operand x is split into hi = tf32(x) and lo = x - hi, and a product
// is lo*hi + hi*lo + hi*hi in f32 sums, about 2^-21 per product.
//
// The first design (mma.sync m16n8k8, one CTA of 4 warps per 64 query rows, 32-key
// tiles by cp.async, every warp splitting every K and V word it read, projections on the
// CUDA cores before the first product) ran at 4.7-10.9x these bounds. This design:
//  - wgmma m64nNk8 .f32.tf32.tf32 for both products. One CTA of 3 warpgroups per (128
//    query rows, batch*head): warpgroup 0 loads and splits, warpgroups 1 and 2 each own 64
//    query rows. Warp 0's first thread keeps 32-key K and V tiles in flight by TMA (3-D
//    maps over (BH, S, D), 128-byte rows, 128B-swizzled, zero-filled past S and past D)
//    into a ring of NS stages with full / split / empty mbarriers (NS = 4, 3 or 2: the
//    most that fit).
//  - Split once a tile: warps 1-3 turn each landed tile into what every consumer reads.
//    K is K-major for q.k as it lands: hi is written over it in place and lo into a plane
//    of the same layout. TF32 wgmma takes K-major operands only, and V lands keys x head
//    dim, so the split writes V^T (hi and lo planes, D rows of 32 keys, 128B-swizzled) for
//    p.v, lane = key, 4 head-dim columns a 16-byte read, each write to 32 distinct banks.
//    The tensor cores read a raw f32 word as a truncated tf32 (a variant that leaves K's
//    raw words as hi meets the tier), but hi is written rounded: a quarter of the error,
//    and no result rests on how the low 13 bits are read. lo stays the f32 word x - hi:
//    read as tf32 it loses at most 2^-11 of itself, truncated or rounded.
//  - Operand layout. q.k: A = Q from registers (hi and lo fragments, times scale * log2 e,
//    split once when the CTA starts: 2 D / 2 registers), B = K from shared memory. p.v:
//    A = p from registers: in V^T a k-block's slots are permuted (slot t holds key 2t,
//    slot t + 4 key 2t + 1, of each 8 keys), so the q.k accumulator's registers are p.v's
//    A fragment as they stand; B = V^T. At D 80 p.v runs as two 40-column passes, so one
//    fresh accumulator of 20 registers fits beside the output's 40.
//  - What the first design found holds: each tile's scores and each tile's p.v start in
//    a fresh accumulator (a long tensor-core chain truncates), and o = o * alpha + acc by
//    a rounded FMA; the softmax state is f32 (ex2.approx), keys past S get -inf; a NaN or
//    an infinity in q, k, v or p leaves lo a NaN, so no non-finite input is lost.
//  - Projections on the tensor cores, while the first tiles land and are split: the 8
//    consumer warps deal out tasks of 16 table rows x 8 query rows (mma.sync m16n8k8,
//    3xTF32 in three independent chains, two tasks at a time, operands by 16-byte loads
//    with the k-slots permuted alike in A and B), times log2 e into shared memory. Compact
//    tables (Toeplitz, rh[y, ky] = R_h[y - ky + gh - 1]): 8 consecutive rows against the
//    window of table rows they need. Expanded tables: the rows that share a y (or an x)
//    against that coordinate's table. The bias is read without stepping: on grids whose
//    rows are whole tiles (gw a multiple of 32: 64x64, 96x96) a tile is one key row, so a
//    row's rel-h term is one shared read a tile and its rel-w terms one float2 per 8 keys;
//    elsewhere each lane derives its 8 keys' (ky, kx) once a tile by a reciprocal multiply.
//  - Windowed rows (14x14, S 196) run the same kernel: 2 CTAs per (window, head) in place
//    of the first design's 4, so a window's K/V is staged and split twice, not 4 times;
//    the 196 query rows are padded to 256 (the second CTA's second warpgroup holds 4 live
//    rows) and the 196 keys to 224 (the last tile holds 4).
// Shared memory, the binding budget: a stage is K (hi in place), K lo and raw V, ceil(D /
// 32) panels of 32 x 128 bytes each, and V^T hi and lo, D x 128 bytes each: 40 KB at D 64,
// 56 KB at D 80; then 12 mbarriers and, with the bias, the (128, gh | 1) rel-h and (128,
// stw) rel-w projections, stw = gw + 8 on whole-tile rows (float2 reads) and gw | 1
// elsewhere: 194,144 B (3 stages) at 64x64, D 64; 185,952 B (2 stages) at D 80; 180,320 B
// (4 stages) / 188,512 B (3) for 14x14 windows; 226,912 / 218,720 B on 96x96. Grids up
// to gh + gw ~290 (D 64) or ~226 (D 80) fit. Mirrored by tmr_tpu_torch/ops/cuda_attn.py
// geometry_f32.
// Registers: warpgroup 0 gives registers to the consumers (setmaxnreg 56 / 224): a
// consumer holds Q (2 D / 2), o (D / 2), a p.v accumulator (32 or 20), the scores and p hi
// (16) and p lo (16).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ERR_TENSOR_MAP = 1000;  // + the CUresult; 1000 alone: no cuTensorMapEncodeTiled
constexpr int ERR_ARGUMENT = 2000;    // an argument the kernels do not take (_build.launch)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;  // warpgroup 0: load and split; 1 and 2: 64 query rows each
constexpr int BQ = 128;       // query rows of a CTA
constexpr int BK = 32;        // keys of a tile
constexpr int PANEL = BK * 128;  // one 128-byte panel of a 32-key tile
constexpr int BAR_BYTES = 96;    // full, split and empty mbarriers of up to 4 stages
constexpr size_t SMEM_LIMIT = 227 * 1024;

enum Bias { NONE = 0, COMPACT = 1, EXPANDED = 2 };

template <int D>
struct Geo {
  static constexpr int KB = D / 8;                 // k-blocks of q.k
  static constexpr int KP = (D + 31) / 32;         // 128-byte panels of a K or V row
  static constexpr int KBYTES = KP * PANEL;        // K, K lo or raw V of one tile
  static constexpr int VTBYTES = D * 128;          // V^T hi or lo: D rows of 32 keys
  static constexpr int STAGE = 3 * KBYTES + 2 * VTBYTES;
  static constexpr int PV_N = D == 80 ? 40 : 64;   // output columns of one p.v pass
  static constexpr int PV_PASSES = D / PV_N;
};

inline size_t smem_bytes(int stage, int ns, int sth, int stw) {
  return 1024 + (size_t)ns * stage + BAR_BYTES + (size_t)BQ * (sth + stw) * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo: hi = tf32(x) rounded to nearest (ties away) by integer ops, lo = x - hi,
// an f32 word within 2^-11 |x|. Read as tf32, lo keeps ~11 bits of itself. A NaN or an
// infinity makes lo a NaN (whatever hi becomes), so it survives every product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// 2^x by the SFU's ex2.approx (about 2 ulp; -inf -> +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// One TMA tile (box of the tensor map) into shared memory, completion counted in bytes on
// `bar`. Coordinates are (column, row, batch*head); reads past the tensor are zero-filled.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// The splitters' plain shared-memory writes, made visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving register reads or writes of an accumulator across the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a 128B-swizzled K-major operand (rows of 128 bytes = 32 tf32, 8-row
// groups 1024 bytes apart, 1024-byte aligned as TMA writes it); an 8-wide k-block advances
// the start by 32 bytes (+2 in the descriptor's 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

#define WG_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_ACC20(i) WG_ACC4(i), WG_ACC4(i + 4), WG_ACC4(i + 8), WG_ACC4(i + 12), WG_ACC4(i + 16)

// d (64 x 32) (+)= A (64 x 8 tf32, registers) . B (8 x 32, shared, K-major)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p, "
      "1, 1;\n}\n"
      : WG_ACC4(0), WG_ACC4(4), WG_ACC4(8), WG_ACC4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 40) (+)= A (64 x 8) . B (8 x 40)
__device__ __forceinline__ void wgmma_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19}, "
      "{%20,%21,%22,%23}, %24, p, 1, 1;\n}\n"
      : WG_ACC20(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 8) . B (8 x 64)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,"
      "%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : WG_ACC20(0), WG_ACC4(20), WG_ACC4(24), WG_ACC4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  if constexpr (N == 64)
    wgmma_n64(d, a, b, accumulate);
  else
    wgmma_n40(d, a, b, accumulate);
}

// K's 16 bytes at k: hi over the raw words, lo into klo
__device__ __forceinline__ void split_k4(uint4* k, uint4* klo) {
  const uint4 x = *k;
  uint4 h, l;
  split_tf32(__uint_as_float(x.x), h.x, l.x);
  split_tf32(__uint_as_float(x.y), h.y, l.y);
  split_tf32(__uint_as_float(x.z), h.z, l.z);
  split_tf32(__uint_as_float(x.w), h.w, l.w);
  *k = h;
  *klo = l;
}

// Warps 1-3: split the landed tile of one stage. K: hi over the raw word, lo into its plane
// (the same swizzled layout). V: lane = key of the tile, a warp takes 4 head-dim columns at a
// time (one 16-byte read of the raw swizzled tile) and writes them into V^T's rows at the
// key's permuted slot; the 32 lanes write 32 distinct banks.
template <int D>
__device__ __forceinline__ void split_stage(unsigned char* st, int sid) {
  using G = Geo<D>;
  constexpr int KCH = G::KBYTES / 16;  // 16-byte chunks of K
  uint4* k = reinterpret_cast<uint4*>(st);
  uint4* klo = reinterpret_cast<uint4*>(st + G::KBYTES);
#pragma unroll
  for (int i = 0; i < (KCH + 95) / 96; ++i)
    if (sid + 96 * i < KCH) split_k4(k + sid + 96 * i, klo + sid + 96 * i);
  const unsigned char* v = st + 2 * G::KBYTES;
  uint32_t* vt = reinterpret_cast<uint32_t*>(st + 3 * G::KBYTES);
  uint32_t* vtlo = reinterpret_cast<uint32_t*>(st + 3 * G::KBYTES + G::VTBYTES);
  const int r = sid & 31, w0 = sid >> 5;  // lane = key of the tile; 3 warps
  const int slot = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
  const unsigned char* vr = v + r * 128;
#pragma unroll
  for (int j = 0; j < (D / 4 + 2) / 3; ++j) {
    const int u = w0 + 3 * j;  // 4 head-dim columns d0 .. d0 + 3
    if (u >= D / 4) break;
    const int d0 = 4 * u;
    const float4 x = *reinterpret_cast<const float4*>(
        vr + (d0 >> 5) * PANEL + ((((d0 & 31) >> 2) ^ (r & 7)) << 4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
    // V^T word of (row d, the key's slot): the slot's chunk swizzled by d & 7 = (d0 & 4) | i
    const int sw = (slot >> 2) ^ (d0 & 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int wd = (d0 + i) * 32 + (((sw ^ i) << 2) | (slot & 3));
      split_tf32(xs[i], vt[wd], vtlo[wd]);
    }
  }
}

// c += a . b, one m16n8k8 TF32 product (mma.sync)
__device__ __forceinline__ void mma_m16n8k8(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One projection task of a warp: C (16 table rows x 8 query rows) = T . q^T by 3xTF32 in a
// fresh accumulator. A rows: table rows tab0 + i (i < 16; zero at or past tab_end); B
// columns: the CTA rows rbase + k * rstride (k < rcnt; zero past). Each product, times
// log2 e, lands in out[row * st + c] with c = pos(row) + cbase - i (the compact table, row
// j = pos - c + n - 1) or c = cbase + i (the expanded table), where 0 <= c < n. rcnt 0 is
// an empty task.
struct ProjTask {
  const float* T;
  float* out;
  int tab0, tab_end, rbase, rstride, rcnt, cbase, n, st;
  bool w_half;
};

// NT tasks at once: their loads in flight together, 3 NT independent mma chains (lo*hi,
// hi*lo, hi*hi of each task, D / 8 products long). TOEPLITZ: the compact tables.
template <int D, int NT, bool TOEPLITZ>
__device__ __forceinline__ void projection_tasks(const ProjTask (&tk)[NT],
                                                 const float* __restrict__ qb, int q0, int gw,
                                                 float inv_gw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float *a0r[NT], *a1r[NT], *br[NT];
  float cl[NT][4], cm[NT][4], ch[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const ProjTask& k = tk[n];
    a0r[n] = k.tab0 + g < k.tab_end ? k.T + (size_t)(k.tab0 + g) * D : nullptr;
    a1r[n] = k.tab0 + g + 8 < k.tab_end ? k.T + (size_t)(k.tab0 + g + 8) * D : nullptr;
    br[n] = g < k.rcnt ? qb + (size_t)(q0 + k.rbase + g * k.rstride) * D : nullptr;
#pragma unroll
    for (int e = 0; e < 4; ++e) cl[n][e] = cm[n][e] = ch[n][e] = 0.f;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k2 = 0; k2 < D / 16; ++k2) {
    // the k-slots of two k-blocks permuted alike in A and B (a contraction does not care):
    // lane t's 16 bytes at d = 16 k2 + 4t give slots t and t + 4 of both blocks
    const int d = 16 * k2 + 4 * t;
    float4 f0[NT], f1[NT], fb[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      f0[n] = a0r[n] ? __ldg(reinterpret_cast<const float4*>(a0r[n] + d)) : zero;
      f1[n] = a1r[n] ? __ldg(reinterpret_cast<const float4*>(a1r[n] + d)) : zero;
      fb[n] = br[n] ? __ldg(reinterpret_cast<const float4*>(br[n] + d)) : zero;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // a0 (i = g, slot t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, k =
        // g), b1 (t + 4, g)
        const float a[4] = {h ? f0[n].z : f0[n].x, h ? f1[n].z : f1[n].x,
                            h ? f0[n].w : f0[n].y, h ? f1[n].w : f1[n].y};
        const float b0 = h ? fb[n].z : fb[n].x, b1 = h ? fb[n].w : fb[n].y;
        uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(a[j], ah[j], al[j]);
        split_tf32(b0, bh0, bl0);
        split_tf32(b1, bh1, bl1);
        mma_m16n8k8(cl[n], al, bh0, bh1);
        mma_m16n8k8(cm[n], ah, bl0, bl1);
        mma_m16n8k8(ch[n], ah, bh0, bh1);
      }
    }
  }
  // c0 (i = g, k = 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const ProjTask& k = tk[n];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = g + 8 * (e >> 1), kk = 2 * t + (e & 1);
      if (kk >= k.rcnt) continue;
      const int row = k.rbase + kk * k.rstride, q = q0 + row;
      int c = k.cbase + i;
      if constexpr (TOEPLITZ) {  // c = pos(row) + cbase - i, pos the row's y or x
        const int y = __float2int_rz(__fmul_rn((float)q + 0.5f, inv_gw));
        c = (k.w_half ? q - y * gw : y) + k.cbase - i;
      }
      if (c >= 0 && c < k.n)
        k.out[row * k.st + c] = ((cl[n][e] + cm[n][e]) + ch[n][e]) * LOG2E;
    }
  }
}

// The CTA's bias projections, rel-h into sRh (row stride sth) and rel-w into sRw (stw), as
// projection tasks dealt round-robin to the 8 consumer warps (cw). Compact tables
// (Toeplitz): 8 consecutive rows against the 16-row windows of table rows they need.
// Expanded tables: the rows that share a y (rel-h) or an x (rel-w), 8 at a time, against
// that coordinate's table, 16 entries at a time. Rows past S get zeros.
template <int D, int BIAS>
__device__ __forceinline__ void projections(const float* __restrict__ qb,
                                            const float* __restrict__ th,
                                            const float* __restrict__ tw, float* sRh,
                                            float* sRw, int q0, int S, int gh, int gw, int sth,
                                            int stw, float inv_gw, int ct) {
  const int cw = ct >> 5, lane = ct & 31;
  const int live = min(BQ, S - q0);
  for (int i = ct; i < (BQ - live) * sth; i += 256) sRh[live * sth + i] = 0.f;
  for (int i = ct; i < (BQ - live) * stw; i += 256) sRw[live * stw + i] = 0.f;
  // this warp's tasks run two at a time
  ProjTask held{};
  bool holding = false;
  auto take = [&](const ProjTask& k) {
    if (holding) {
      const ProjTask pair[2] = {held, k};
      projection_tasks<D, 2, BIAS == COMPACT>(pair, qb, q0, gw, inv_gw, lane);
    } else {
      held = k;
    }
    holding = !holding;
  };
  int task = 0;
  for (int half = 0; half < 2; ++half) {
    const bool w = half;
    const int n = w ? gw : gh, st = w ? stw : sth;
    const float* T = w ? tw : th;
    float* out = w ? sRw : sRh;
    if (BIAS == COMPACT) {
      for (int rb = 0; rb < live; rb += 8) {
        const int cnt = min(8, live - rb), qa = q0 + rb, qz = qa + cnt - 1;
        int pmin, pmax;
        if (!w) {
          pmin = qa / gw, pmax = qz / gw;
        } else if (qa / gw == qz / gw) {
          pmin = qa % gw, pmax = qz % gw;
        } else {
          pmin = 0, pmax = gw - 1;
        }
        const int jend = min(pmax + n - 1, 2 * n - 2);
        for (int j0 = pmin; j0 <= jend; j0 += 16, ++task)
          if ((task & 7) == cw)
            take({T, out, j0, 2 * n - 1, rb, 1, cnt, n - 1 - j0, n, st, w});
      }
    } else if (!w) {
      for (int v = q0 / gw; v <= (q0 + live - 1) / gw; ++v) {
        const int r0 = max(v * gw - q0, 0), r1 = min((v + 1) * gw - q0, live);
        for (int rb = r0; rb < r1; rb += 8)
          for (int c0 = 0; c0 < n; c0 += 16, ++task)
            if ((task & 7) == cw)
              take({T, out, v * n + c0, v * n + n, rb, 1, min(8, r1 - rb), c0, n, st, w});
      }
    } else {
      const int q0x = q0 % gw;
      for (int v = 0; v < gw; ++v) {
        const int first = v >= q0x ? v - q0x : v - q0x + gw;  // the first CTA row with x == v
        if (first >= live) continue;
        const int cnt = (live - 1 - first) / gw + 1;
        for (int kb = 0; kb < cnt; kb += 8)
          for (int c0 = 0; c0 < n; c0 += 16, ++task)
            if ((task & 7) == cw)
              take({T, out, v * n + c0, v * n + n, first + kb * gw, gw, min(8, cnt - kb), c0,
                    n, st, w});
      }
    }
  }
  if (holding) {
    const ProjTask pair[2] = {held, ProjTask{}};
    projection_tasks<D, 2, BIAS == COMPACT>(pair, qb, q0, gw, inv_gw, lane);
  }
}

// One CTA per (BQ query rows, batch*head). q/out (BH, S, D) f32; K and V through the TMA
// maps tk, tv; th/tw the bias tables (BIAS) or null. ROW_TILE: gw % BK == 0, so a tile is
// one grid row of keys.
template <int D, int BIAS, bool ROW_TILE>
__global__ void __launch_bounds__(THREADS, 1)
    attn_f32_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const float* __restrict__ q,
                    const float* __restrict__ th, const float* __restrict__ tw,
                    float* __restrict__ out, int S, int gh, int gw, int sth, int stw, int ns,
                    float qk_scale, float inv_gw) {
  using G = Geo<D>;
  constexpr int KB = G::KB, PV_N = G::PV_N, PV_PASSES = G::PV_PASSES;
  extern __shared__ unsigned char f32_smem_raw[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(f32_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + (size_t)ns * G::STAGE);
  uint64_t* split = full + 4;
  uint64_t* empty = full + 8;
  float* sRh = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(full) + BAR_BYTES);
  float* sRw = sRh + BQ * sth;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int nk = (S + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, wg = warp >> 2, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&split[s], 3);  // one arrive per splitter warp
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // load and split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 0) {  // producer: one thread keeps the ring full
      if (lane == 0) {
        for (int kt = 0; kt < nk; ++kt) {
          const int s = kt % ns, u = kt / ns;
          if (u) mbar_wait(&empty[s], (u - 1) & 1);
          unsigned char* st = stages + (size_t)s * G::STAGE;
          mbar_expect_tx(&full[s], 2 * G::KBYTES);
          for (int p = 0; p < G::KP; ++p) {
            tma_load_3d(st + p * PANEL, &tk, &full[s], 32 * p, kt * BK, bh);
            tma_load_3d(st + 2 * G::KBYTES + p * PANEL, &tv, &full[s], 32 * p, kt * BK, bh);
          }
        }
      }
    } else {  // splitters
      const int sid = threadIdx.x - 32;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ns;
        mbar_wait(&full[s], (kt / ns) & 1);
        split_stage<D>(stages + (size_t)s * G::STAGE, sid);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&split[s]);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int c = wg - 1, g = lane >> 2, t = lane & 3;
    const int lr0 = 64 * c + 16 * (warp & 3) + g, lr1 = lr0 + 8;  // CTA-local rows
    const int row0 = q0 + lr0, row1 = q0 + lr1;
    const float* qb = q + (size_t)bh * S * D;
    // Q's A fragments: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of each
    // k-block, loaded before the projections (their latency under the projections' work),
    // then times scale x log2 e and split
    float qa[KB][4];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const int col = 8 * kk + t;
      qa[kk][0] = row0 < S ? __ldg(qb + (size_t)row0 * D + col) : 0.f;
      qa[kk][1] = row1 < S ? __ldg(qb + (size_t)row1 * D + col) : 0.f;
      qa[kk][2] = row0 < S ? __ldg(qb + (size_t)row0 * D + col + 4) : 0.f;
      qa[kk][3] = row1 < S ? __ldg(qb + (size_t)row1 * D + col + 4) : 0.f;
    }
    if constexpr (BIAS != NONE) {
      projections<D, BIAS>(qb, th, tw, sRh, sRw, q0, S, gh, gw, sth, stw, inv_gw,
                           threadIdx.x - 128);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
    }
    uint32_t qh[KB][4], ql[KB][4];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(qa[kk][j] * qk_scale, qh[kk][j], ql[kk][j]);
    float o[PV_PASSES][PV_N / 2];
#pragma unroll
    for (int h = 0; h < PV_PASSES; ++h)
#pragma unroll
      for (int i = 0; i < PV_N / 2; ++i) o[h][i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const float* rh0 = sRh + lr0 * sth;
    const float* rh1 = sRh + lr1 * sth;
    const float* rw0 = sRw + lr0 * stw;
    const float* rw1 = sRw + lr1 * stw;
    const bool active = q0 + 64 * c < S;  // a warpgroup wholly past S keeps the barriers

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ns;
      mbar_wait(&split[s], (kt / ns) & 1);
      const unsigned char* st = stages + (size_t)s * G::STAGE;
      if (active) {
        // scores of the tile: sc[4j + e] (row g, key 8j + 2t + e), sc[4j + 2 + e] (g + 8)
        float sc[16];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          const uint64_t bhi = sw128_desc(st + (kk >> 2) * PANEL) + (kk & 3) * 2;
          const uint64_t blo = sw128_desc(st + G::KBYTES + (kk >> 2) * PANEL) + (kk & 3) * 2;
          wgmma_n32(sc, ql[kk], bhi, kk > 0);
          wgmma_n32(sc, qh[kk], blo, 1);
          wgmma_n32(sc, qh[kk], bhi, 1);
        }
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        // the bias, -inf past S
        const int k0 = kt * BK;
        if constexpr (BIAS != NONE && ROW_TILE) {
          const int ky = k0 / gw, kx0 = k0 - ky * gw;
          const float h0 = rh0[ky], h1 = rh1[ky];
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const float2 w0 = *reinterpret_cast<const float2*>(rw0 + kx0 + 8 * j + 2 * t);
            const float2 w1 = *reinterpret_cast<const float2*>(rw1 + kx0 + 8 * j + 2 * t);
            sc[4 * j] += h0 + w0.x;
            sc[4 * j + 1] += h0 + w0.y;
            sc[4 * j + 2] += h1 + w1.x;
            sc[4 * j + 3] += h1 + w1.y;
          }
        } else {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * j + 2 * t + e;
              if (key >= S) {
                sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
              } else if constexpr (BIAS != NONE) {
                const int ky = __float2int_rz(__fmul_rn((float)key + 0.5f, inv_gw));
                const int kx = key - ky * gw;
                sc[4 * j + e] += rh0[ky] + rw0[kx];
                sc[4 * j + 2 + e] += rh1[ky] + rw1[kx];
              }
            }
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float alpha0 = ex2(m0 - mx0), alpha1 = ex2(m1 - mx1);
        m0 = mx0, m1 = mx1;
        l0 *= alpha0, l1 *= alpha1;
        // p, split, as p.v's A fragments: key 2t of a k-block in slot t, key 2t + 1 in
        // slot t + 4 (V^T's slot order)
        uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float p0 = ex2(sc[4 * j] - mx0), p1 = ex2(sc[4 * j + 1] - mx0);
          const float p2 = ex2(sc[4 * j + 2] - mx1), p3 = ex2(sc[4 * j + 3] - mx1);
          l0 += p0 + p1, l1 += p2 + p3;
          split_tf32(p0, ph[j][0], pl[j][0]);
          split_tf32(p2, ph[j][1], pl[j][1]);
          split_tf32(p1, ph[j][2], pl[j][2]);
          split_tf32(p3, ph[j][3], pl[j][3]);
        }
        // p.v in PV_PASSES passes of PV_N columns, each in a fresh accumulator
        const unsigned char* vt = st + 3 * G::KBYTES;
#pragma unroll
        for (int h = 0; h < PV_PASSES; ++h) {
          float acc[PV_N / 2];
          wg_fence();
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const uint64_t bhi = sw128_desc(vt + h * PV_N * 128) + j * 2;
            const uint64_t blo = sw128_desc(vt + G::VTBYTES + h * PV_N * 128) + j * 2;
            wgmma_pv<PV_N>(acc, pl[j], bhi, j > 0);
            wgmma_pv<PV_N>(acc, ph[j], blo, 1);
            wgmma_pv<PV_N>(acc, ph[j], bhi, 1);
          }
          wg_commit();
          wg_wait0();
          fence_regs(acc);
#pragma unroll
          for (int i = 0; i < PV_N / 2; ++i)
            o[h][i] = fmaf(o[h][i], (i & 2) ? alpha1 : alpha0, acc[i]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    if (!active) return;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    float* ob = out + (size_t)bh * S * D;
#pragma unroll
    for (int h = 0; h < PV_PASSES; ++h) {
#pragma unroll
      for (int j = 0; j < PV_N / 8; ++j) {
        const int col = h * PV_N + 8 * j + 2 * t;
        if (row0 < S)
          *reinterpret_cast<float2*>(ob + (size_t)row0 * D + col) =
              make_float2(__fdiv_rn(o[h][4 * j], l0), __fdiv_rn(o[h][4 * j + 1], l0));
        if (row1 < S)
          *reinterpret_cast<float2*>(ob + (size_t)row1 * D + col) =
              make_float2(__fdiv_rn(o[h][4 * j + 2], l1), __fdiv_rn(o[h][4 * j + 3], l1));
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime has loaded (no link against it)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A (BH, S, D) f32 tensor as a 3-D TMA map whose box is 32 columns x BK rows of one
// batch*head, 128B-swizzled (the wgmma operand layout); reads past S or D are zero-filled.
int f32_map(CUtensorMap* map, const void* ptr, int D, int S, int BH) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return ERR_TENSOR_MAP;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)S * D * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

template <int D, int BIAS, bool ROW_TILE>
int launch(const void* q, const void* k, const void* v, const void* th, const void* tw,
           void* out, int BH, int S, int gh, int gw, float scale, cudaStream_t st) {
  if (BH < 1 || BH > 65535 || gh < 1 || gw < 1 || S != gh * gw) return ERR_ARGUMENT;
  // geometry mirrored by tmr_tpu_torch/ops/cuda_attn.py geometry_f32: the deepest ring of
  // 4, 3 or 2 stages that fits beside the projections
  const int sth = BIAS != NONE ? gh | 1 : 0;
  const int stw = BIAS == NONE ? 0 : ROW_TILE ? gw + 8 : gw | 1;
  int ns = 4;
  while (ns >= 2 && smem_bytes(Geo<D>::STAGE, ns, sth, stw) > SMEM_LIMIT) --ns;
  if (ns < 2) return ERR_ARGUMENT;
  const size_t smem = smem_bytes(Geo<D>::STAGE, ns, sth, stw);
  CUtensorMap tk, tv;
  int e;
  if ((e = f32_map(&tk, k, D, S, BH)) || (e = f32_map(&tv, v, D, S, BH))) return e;
  auto kernel = attn_f32_kernel<D, BIAS, ROW_TILE>;
  const cudaError_t a =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  kernel<<<dim3((S + BQ - 1) / BQ, BH), THREADS, smem, st>>>(
      tk, tv, (const float*)q, (const float*)th, (const float*)tw, (float*)out, S, gh, gw,
      sth, stw, ns, scale * LOG2E, 1.f / (float)gw);
  return (int)cudaGetLastError();
}

template <int D>
int global_entry(const void* q, const void* k, const void* v, const void* rph, const void* rpw,
                 void* out, int BH, int S, int gh, int gw, float scale, int has_bias,
                 cudaStream_t st) {
  if (!has_bias)
    return launch<D, NONE, false>(q, k, v, nullptr, nullptr, out, BH, S, gh, gw, scale, st);
  if (gw % BK == 0)
    return launch<D, COMPACT, true>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, st);
  return launch<D, COMPACT, false>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, st);
}

}  // namespace

extern "C" {

// q/k/v/out: (BH, S, D) f32 contiguous, 16-byte aligned, over a (gh, gw) token grid, S =
// gh * gw, D = 64 or 80; rph (2gh - 1, D) and rpw (2gw - 1, D) f32 contiguous, the compact
// rel-pos tables, or null when has_bias == 0. Returns 0 when launched, a CUDA error code,
// 1000 (+ the CUresult) when a TMA descriptor cannot be made, or 2000 for a head dim, a
// shape or a grid whose projections do not fit shared memory.
int tmr_global_attn_f32(const void* q, const void* k, const void* v, const void* rph,
                        const void* rpw, void* out, int BH, int S, int gh, int gw, int D,
                        float scale, int has_bias, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return global_entry<64>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, has_bias, st);
  if (D == 80)
    return global_entry<80>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, has_bias, st);
  return ERR_ARGUMENT;
}

// q/k/v/out: (BH, S, D) f32 contiguous, 16-byte aligned, with S = gh * gw window tokens, D
// = 64 or 80; rh (gh, gh, D) and rw (gw, gw, D) f32 contiguous, the get_rel_pos tables.
// Returns 0 when launched, a CUDA error code, 1000 (+ the CUresult) for a TMA descriptor,
// or 2000 for an argument the kernel does not take.
int tmr_window_attn_f32(const void* q, const void* k, const void* v, const void* rh,
                        const void* rw, void* out, int BH, int S, int gh, int gw, int D,
                        float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, EXPANDED, false>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  if (D == 80)
    return launch<80, EXPANDED, false>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  return ERR_ARGUMENT;
}

}  // extern "C"
