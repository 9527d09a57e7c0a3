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
// _bias_projections). Both make the projections themselves, on the tensor cores: the
// global kernel from the compact (2g - 1, D) tables, the windowed kernel from the
// expanded (g, g, D) get_rel_pos tables. Each is one launch that writes nothing to HBM
// but its output.
//
// Global kernel (SAM ViT-B: 4 blocks of 48 x 4096 x 64 per batch of 4). It does 4 S^2 D
// flops per head, 206 GFLOP per call: 0.208 ms at the bf16 peak, which bounds it (its
// bytes, q/k/v/out and the tables, take 0.03 ms). It has 805 M scores, and the SFU's ex2
// (16 a clock per SM) needs ~0.21 ms for them, so the exponentials must run under the
// products. The first design (mma.sync, one CTA of 4 warps per 64 query rows, cp.async
// double buffering, projections precomputed in HBM) took 1.07 ms alone and 1.39 ms with
// its projections; what held it back, and what this design does:
//  1. L2 -> shared traffic: 64 query rows per CTA made every CTA stream its head's whole
//     K and V, 3.2 GB per call. Now a CTA owns 128 query rows (2 consumer warpgroups of 64),
//     half the traffic.
//  2. Shared -> register traffic: each warp read every K and V tile through ldmatrix for
//     16 rows. Now q.k and p.v are wgmma: a warpgroup reads a tile once for its 64 rows.
//     q.k takes A = Q from registers (loaded once) and B = K from shared memory (K-major);
//     p.v takes A = p from registers (the q.k accumulator layout is the A fragment layout)
//     and B = V through the transpose bit (V stays as stored, keys x head dim).
//  3. Per-score work: ex2.approx.ftz in place of exp2f; the scale (x log2 e) and the rel-w
//     term are one FFMA (the projections are stored x log2 e), and the rel-h term, one
//     value per grid row of keys, enters only the row max and the exponent's offset; no
//     global load in the key loop. The exponentials run under the products twice over:
//     a warpgroup issues q.k of tile kt before p.v of tile kt-1 and runs its softmax while
//     p.v is in flight, and with the bias the two consumer warpgroups take turns at the
//     tensor cores through two named barriers (without it, where the softmax is shorter,
//     they measured faster running freely).
//  4. Projections through HBM: the wrapper wrote an f32 copy of q and 100 MB of f32
//     projections per call. Now each warp computes its 16 rows' projections after Q lands,
//     while the first K/V tiles are in flight: the tables are Toeplitz (rh[y, ky] =
//     R_h[y - ky + gh - 1]), so the rel-h terms of a row are q . R_h over a window of table
//     rows, and a warp multiplies (mma.sync, q exact in bf16, the f32 table as bf16 hi + lo
//     terms, f32 sums) only the table rows its 16 rows need: 8-9 groups of 8 for rel-h, 10-11
//     for rel-w on the 64x64 grid, ~4% of the attention's tensor work. The (128, gh) and
//     (128, gw) results stay in shared memory.
//  5. Copies and occupancy: K/V tiles (128-byte rows, 128B-swizzled) arrive by TMA
//     (cp.async.bulk.tensor, 3-D maps over (BH, S, D)) into a ring (3 stages of 128 keys,
//     96 KB, on the main path; 4 of 64 elsewhere) with full/empty mbarriers, fed by one
//     producer thread; the producer warpgroup hands its registers to the consumers
//     (setmaxnreg 40 / 232). One CTA of 12 warps per SM (182 KB of shared memory on the
//     main path).
// Alternatives measured slower on the main path and removed (PERF.md): Q read from shared
// memory by every q.k, 64-key tiles, and no turn-taking with the bias.
// Any token count: Q rows and K/V keys past S are zero-filled by TMA; the last tile's pad
// keys get -inf (a separate instantiation of the tile step, so full tiles run no mask
// instruction; on the main path a key row past the grid has rel-h -inf); pad query rows
// are never stored. When a grid row is 64 tokens (the main path) a lane's rel-w terms are
// 16 registers for the whole loop and its rel-h terms one shared read per key row and
// tile; other grids (24x40, 96x96, 20x20, ...) derive each column's (ky, kx) once per tile
// by a reciprocal multiply and read both terms from shared memory. The head dim is a
// template parameter (64-column panels; 64 and 80 instantiated).
// Head dim 80 (SAM ViT-H: 4 blocks of 64 x 4096 x 80 per batch of 4; 4 S^2 D BH = 344
// GFLOP, 0.347 ms at the bf16 peak): q.k takes 5 k-steps; Q, K and V take two panels, the
// second zero-filled by TMA past column 80, so p.v performs 128 / 80 of the products it
// needs (0.452 ms at the peak). With two panels a ring of 128-key tiles and the 64x64
// projections fits only 2 stages, so every D = 80 instantiation takes 3 stages of 64 keys
// (a 96x96 grid's projections still fit). Measured in turns (scripts/attn_variants.py,
// PERF.md): 4 stages of 64 keys 2-4% slower, 2 stages of 128 keys ~45% slower.
// nvcc 12.9 -Xptxas -v (sm_90a), each of <64, 128, bias, row tile>,
// <64, 64, bias, general>, <64, 64, no bias> and <80, 64, *, *>: 168 registers (the
// launch bound's share of 384 threads), 0 bytes stack frame, 0 spills.
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
// Head dim 80 (SAM ViT-H: 1600 window-heads per block, 28 blocks per batch of 4; q, k, v
// and out are 201 MB a call, 0.060 ms at 3.35 TB/s): rows of 160 bytes in 10 chunks keep
// the ldmatrix phases conflict-free with a one-bit swizzle (swz), and the 14x14 staging
// is 130,752 B, so one CTA fits an SM. That CTA runs 16 warps, one per query strip, and a
// warp re-reads its Q fragments from shared memory for each key chunk rather than holding
// them, so 16 warps fit 128 registers. nvcc 12.9 -Xptxas -v (sm_90a), <80, NTW>: 128
// registers; NTW = 1 and 2 (SAM's 14x14) spill 8 bytes, NTW = 4 and 8 (rows over 16
// tokens) 32 and 92. Measured in turns at 14x14 (scripts/attn_variants.py, PERF.md): 8
// warps holding Q in registers (171 registers, no spills) 0.253-0.260 ms, this design
// 0.208-0.214. <64, NTW> as above.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

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

template <int D>
struct WarpState {
  uint32_t qf[D / 16][4];  // Q fragments for the D / 16 head-dim chunks of 16
  float o[D / 8][4];       // output accumulators, D / 8 head-dim n-tiles of 8
  float m[2];              // running max (log2 domain) of rows g and g+8
  float l[2];              // this thread's partial denominators of rows g and g+8
};

template <int D>
__device__ __forceinline__ void store_out(WarpState<D>& st, __nv_bfloat16* or0,
                                          __nv_bfloat16* or1, bool ok0, bool ok1) {
  const int t = threadIdx.x & 3;
  float l0 = st.l[0], l1 = st.l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(or0 + c) =
          __floats2bfloat162_rn(st.o[n][0] / l0, st.o[n][1] / l0);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(or1 + c) =
          __floats2bfloat162_rn(st.o[n][2] / l1, st.o[n][3] / l1);
  }
}

// ---- windowed attention ------------------------------------------------------------------

// Warps of a (window, head) CTA, and whether a warp holds its strip's Q fragments in
// registers. D = 64: 8 warps, two CTAs an SM, Q in registers. D = 80: one CTA an SM (its
// staging), 16 warps so that each of a 14x14 window's 13 query strips has its own, and Q
// re-read from shared memory for each key chunk so that 16 warps fit 128 registers
// (scripts/attn_variants.py: 18% faster than 8 warps with Q in registers; the re-read costs
// D = 64 1%).
template <int D>
constexpr int WIN_WARPS = D == 64 ? 8 : 16;
template <int D>
constexpr bool WIN_Q_REGS = D == 64;

// Row-swizzled (rows, D) bf16 tile of D / 8 chunks of 16 bytes a row, rows of 2D bytes
// with no padding: chunk c of row r lives at chunk c ^ f(r), so that the 8 rows an ldmatrix
// phase reads (8 consecutive rows from a multiple of 8, one chunk) sit in 8 distinct bank
// groups of 16 bytes. D = 64 (128-byte rows): f(r) = r & 7. D = 80 (160-byte rows): row r
// starts at bank group 2r mod 8, so rows r and r + 4 of each 8 would collide; f(r) =
// (r >> 2) & 1 flips the chunk's low bit in rows 4-7, which moves them to the groups of the
// other parity (a bijection on chunks 0-9: it swaps 2i and 2i + 1). Mirrored, with the
// bank-group check, by tests/test_torch_attention.py.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(D == 64 || D == 80, "the windowed kernel takes head dim 64 or 80");
  return row * D + ((chunk ^ (D == 64 ? (row & 7) : ((row >> 2) & 1))) << 3);
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
// product (tokens of the row or column, D) x (D, gh or gw) on the tensor cores: q is bf16
// and exact as an mma operand, the f32 table is split into bf16 hi + lo terms, the sums are
// f32. The A rows are gathered by ldmatrix (one row address per lane); the B fragments are
// read straight from the tables (L1/L2: every CTA of the call reads the same ~50 KB).
template <int D>
__device__ __forceinline__ void window_projections(const __nv_bfloat16* sQ, const float* rh,
                                                   const float* rw, float* sRH, float* sRW,
                                                   int gh, int gw, int st_h, int st_w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int mt_h = (gw + 15) >> 4, mt_w = (gh + 15) >> 4;  // 16-token tiles per group
  const int nh = gh * mt_h, units = nh + gw * mt_w;
  for (int u = warp; u < units; u += WIN_WARPS<D>) {
    const bool is_h = u < nh;
    const int uu = is_h ? u : u - nh, mt_n = is_h ? mt_h : mt_w;
    const int grp = uu / mt_n, m0 = (uu - grp * mt_n) * 16;
    // group grp: tokens tok0 + i * tstep for i < nrows; output columns ncols
    const int nrows = is_h ? gw : gh, ncols = is_h ? gh : gw;
    const int tok0 = is_h ? grp * gw : grp, tstep = is_h ? 1 : gw;
    const float* tab = (is_h ? rh : rw) + (size_t)grp * ncols * D;
    float* dst = is_h ? sRH : sRW;
    const int st = is_h ? st_h : st_w;
    uint32_t a[D / 16][4];
    const int ai = min(m0 + (lm & 1) * 8 + lr, nrows - 1);  // pad rows repeat a real one
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(a[kk], sQ + swz<D>(tok0 + ai * tstep, kk * 2 + (lm >> 1)));
    for (int n0 = 0; n0 < ncols; n0 += 16) {  // two n-tiles: D / 4 table loads in flight
      float2 x[2][D / 16][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 8 * h + g;
        const float* brow = tab + (size_t)min(col, ncols - 1) * D + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
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
        for (int kk = 0; kk < D / 16; ++kk) {
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
template <int D, int NTW, int NT>
__device__ __forceinline__ void window_chunk(WarpState<D>& st, const __nv_bfloat16* sK,
                                             const __nv_bfloat16* sV, int ky,
                                             const __nv_bfloat16* sQ, int qrow,
                                             const float* rh0, const float* rh1,
                                             const float (&rw0)[NTW][2],
                                             const float (&rw1)[NTW][2], float scale_log2) {
  const int lane = threadIdx.x & 31, lm = lane >> 3, lr = lane & 7;
  const int key0 = ky * 8 * NTW;
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if (!WIN_Q_REGS<D>) ldsm_x4(st.qf[kk], sQ + swz<D>(qrow, kk * 2 + (lm >> 1)));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, sK + swz<D>(key0 + np * 16 + (lm >> 1) * 8 + lr, kk * 2 + (lm & 1)));
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
  for (int n = 0; n < D / 8; ++n) {
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
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, sV + swz<D>(key0 + kc * 16 + (lm & 1) * 8 + lr, dp * 2 + (lm >> 1)));
      mma_bf16(st.o[2 * dp], a, b[0], b[1]);
      mma_bf16(st.o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// One CTA per (window, head): q/k/v/out (BH, S, D) bf16, S = gh * gw; rh (gh, gh, D) and
// rw (gw, gw, D) f32, the get_rel_pos tables. Shared memory: Q (sp rows), K and V (ghp
// key rows of GWP slots each), all row-swizzled bf16; sRH (sp, st_h) and sRW (sp, GWP) f32.
// D = 64: two CTAs per SM (registers capped at 128); D = 80 stages 130,752 B at 14x14, so
// one CTA per SM, registers uncapped.
template <int D, int NTW>
__global__ void __launch_bounds__(WIN_WARPS<D> * 32, D == 64 ? 2 : 1)
    window_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ rh,
                       const float* __restrict__ rw, __nv_bfloat16* __restrict__ out, int S,
                       int gh, int gw, int ghp, int sp, int st_h, float scale_log2) {
  constexpr int GWP = 8 * NTW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nkey = ghp * GWP;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  constexpr int CH = D / 8;  // 16-byte chunks a row
  __nv_bfloat16* sK = sQ + sp * D;
  __nv_bfloat16* sV = sK + nkey * D;
  float* sRH = reinterpret_cast<float*>(sV + nkey * D);
  float* sRW = sRH + sp * st_h;
  const size_t base = (size_t)blockIdx.x * S * D;
  // Q, then K and V in key-slot order, all by cp.async (pad rows and slots zero-filled:
  // zero K and V keep the masked slots finite and out of the sums)
  for (int i = threadIdx.x; i < sp * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    cp_async16_zfill(sQ + swz<D>(r, c), q + base + (size_t)min(r, S - 1) * D + c * 8,
                     r < S ? 16 : 0);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < nkey * CH; i += blockDim.x) {
    const int j = i / CH, c = i % CH, ky = j / GWP, kx = j % GWP;
    const bool ok = ky < gh && kx < gw;
    const size_t src = base + (size_t)(ok ? ky * gw + kx : 0) * D + c * 8;
    cp_async16_zfill(sK + swz<D>(j, c), k + src, ok ? 16 : 0);
    cp_async16_zfill(sV + swz<D>(j, c), v + src, ok ? 16 : 0);
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
  window_projections<D>(sQ, rh, rw, sRH, sRW, gh, gw, st_h, GWP);
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  constexpr int CROWS = 8 / NTW;  // key rows per chunk of 8 n-tiles
  for (int strip = warp; strip * 16 < sp; strip += WIN_WARPS<D>) {
    const int r0 = strip * 16 + g, r1 = r0 + 8;
    const int qrow = strip * 16 + (lm & 1) * 8 + lr;  // this lane's ldmatrix row of Q
    WarpState<D> st;
    if (WIN_Q_REGS<D>) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(st.qf[kk], sQ + swz<D>(qrow, kk * 2 + (lm >> 1)));
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
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
      window_chunk<D, NTW, 8>(st, sK, sV, ky, sQ, qrow, rh0, rh1, rw0, rw1, scale_log2);
    switch ((ghp - ky) * NTW) {  // the last chunk: 2, 4 or 6 n-tiles (ghp * NTW is even)
      case 2:
        window_chunk<D, NTW, 2>(st, sK, sV, ky, sQ, qrow, rh0, rh1, rw0, rw1, scale_log2);
        break;
      case 4:
        window_chunk<D, NTW, 4>(st, sK, sV, ky, sQ, qrow, rh0, rh1, rw0, rw1, scale_log2);
        break;
      case 6:
        window_chunk<D, NTW, 6>(st, sK, sV, ky, sQ, qrow, rh0, rh1, rw0, rw1, scale_log2);
        break;
      default: break;
    }
    store_out<D>(st, out + base + (size_t)r0 * D, out + base + (size_t)r1 * D, r0 < S,
                 r1 < S);
  }
}

// ---- global attention --------------------------------------------------------------------

constexpr int GQ = 128;         // query rows per CTA: 2 consumer warpgroups x 64
constexpr int G_THREADS = 384;  // warpgroup 0 loads (one thread), warpgroups 1-2 compute

// Head dim D is stored as 64-column panels (128-byte rows, one 128B-swizzle span each; a
// head dim that is not a multiple of 64 is zero-filled by TMA up to the panel edge: at
// D = 80 the second panel holds 16 real columns, so p.v performs 128 / 80 of the products
// it needs and Q, K and V take twice the shared memory of D = 64).
template <int D>
struct GPanels {
  static constexpr int NP = (D + 63) / 64;  // panels per row
  static constexpr int KS = (D + 15) / 16;  // 16-wide k-steps of q.k
};
// K/V ring depth. One panel (D = 64): 4 stages of 64-key tiles (64 KB) or 3 of 128-key
// tiles (96 KB). Two panels (D = 80): 3 stages of 64-key tiles (96 KB): with the
// projections of a 96x96 grid that is 231,480 B, within the 232,448 a block may use.
template <int D, int BK>
struct GStages {
  static constexpr int NS = GPanels<D>::NP == 1 ? (BK == 64 ? 4 : 3) : 3;
};

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
// `bar`. Coordinates are (column, row, batch*head); rows past the tensor are zero-filled.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// Named barriers of the two consumer warpgroups' turns (no-ops when they run freely).
template <bool TURNS>
__device__ __forceinline__ void named_sync(int id) {
  if (TURNS) asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

template <bool TURNS>
__device__ __forceinline__ void named_arrive(int id) {
  if (TURNS) asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a 128B-swizzled operand tile (rows of 128 bytes, 8-row groups 1024
// bytes apart, 1024-byte aligned as TMA writes it). The same layout serves a K-major
// operand (Q, K: 16-wide k-steps advance the start by 32 bytes) and the MN-major V (the
// transpose bit; 16-key k-steps advance it by 2048 bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

#define WG_ACC8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC32(i) WG_ACC8(i), WG_ACC8(i + 8), WG_ACC8(i + 16), WG_ACC8(i + 24)

// d (64 x 64, f32) (+)= A (64 x 16, bf16 registers) . B (16 x 64, shared; TB: MN-major,
// as V is read, else K-major)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,"
      "%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : WG_ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
}

// d (64 x 128, f32) (+)= A (64 x 16, bf16 registers) . B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,"
      "%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,"
      "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
      : WG_ACC32(0), WG_ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// A warp's 16 query rows (CTA-local rows lr0..lr0+15 of the swizzled Q tile) as the A
// fragments of mma.sync m16n8k16, which are also a warp's share of a wgmma A operand.
template <int D>
__device__ __forceinline__ void load_q_fragments(const unsigned char* sQ, int lr0,
                                                 uint32_t (&a)[GPanels<D>::KS][4]) {
  const int lane = threadIdx.x & 31, lm = lane >> 3, lr = lane & 7;
  const int row = lr0 + (lm & 1) * 8 + lr;
#pragma unroll
  for (int kk = 0; kk < GPanels<D>::KS; ++kk) {
    const int chunk = kk * 2 + (lm >> 1);
    ldsm_x4(a[kk],
            sQ + (chunk >> 3) * GQ * 128 + row * 128 + (((chunk & 7) ^ (row & 7)) << 4));
  }
}

// Bias projections of one warp's 16 query rows (CTA-local rows lr0..lr0+15, bf16 in the
// swizzled Q tile) against one compact rel-pos table R (L = 2g - 1 rows of D f32):
//   out[r][kk] = LOG2E * (q_r . R[c_r + g - 1 - kk]),  kk < g,
// c_r the row's grid coordinate (y for rel-h, x for rel-w): the get_rel_pos table of a
// self-attention grid is Toeplitz, rh[c, kk] = R[c - kk + g - 1]. The products run on the
// tensor cores (mma.sync, q exact in bf16, R split into bf16 hi + lo terms, f32 sums) over
// only the table rows [cmin, cmax + g - 1] that some row of the warp needs, 8 at a time;
// each product lands in the row's output slot or is dropped.
template <int D>
__device__ __forceinline__ void global_projection(const unsigned char* sQ, int lr0,
                                                  const float* __restrict__ R, int g, int c0,
                                                  int c1, int cmin, int cmax, float* out,
                                                  int st) {
  constexpr int KS = GPanels<D>::KS;
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  uint32_t a[KS][4];
  load_q_fragments<D>(sQ, lr0, a);
  const int L = 2 * g - 1;
  const int jhi = min(cmax + g - 1, L - 1);
  // two groups of 8 table rows per pass: their 32 loads in flight together, and four
  // independent mma chains (hi and lo terms of each group) in place of one
  for (int j0 = cmin & ~7; j0 <= jhi; j0 += 16) {
    float2 x[2][KS][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* brow = R + (size_t)min(j0 + 8 * h + gq, L - 1) * D + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          x[h][kk][e] = kk * 16 + 8 * e + 2 * t < D
                            ? *reinterpret_cast<const float2*>(brow + kk * 16 + 8 * e)
                            : make_float2(0.f, 0.f);
      }
    }
    float chi[2][4] = {}, clo[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t h0, l0, h1, l1;
        split_bf16(x[h][kk][0].x, x[h][kk][0].y, h0, l0);
        split_bf16(x[h][kk][1].x, x[h][kk][1].y, h1, l1);
        mma_bf16(clo[h], a[kk], l0, l1);
        mma_bf16(chi[h], a[kk], h0, h1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int cr = r ? c1 : c0;
        float* orow = out + (lr0 + gq + 8 * r) * st;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = cr + g - 1 - (j0 + 8 * h + 2 * t + e);
          if (kk >= 0 && kk < g) orow[kk] = (clo[h][2 * r + e] + chi[h][2 * r + e]) * LOG2E;
        }
      }
    }
  }
}

// What a consumer thread needs to turn a tile's scores into probabilities.
struct GRows {
  const float* rh0;  // rel-h row of query rows r0 and r1 (shared, x LOG2E)
  const float* rh1;
  const float* rw0;  // rel-w rows (general path)
  const float* rw1;
  int S, gh, gw;
  float inv_gw, scale_log2;
};

// One K/V tile's online softmax for this thread's two query rows: scores (in the wgmma
// accumulator layout: s[4j + e] row g, key 8j + 2t + e; s[4j + 2 + e] row g + 8) get the
// scale and the bias in one FFMA (the projections carry LOG2E), then the running max, the
// rescale of o and l, exp2 by ex2.approx, and p packed as the bf16 A fragments of the p.v
// wgmma.
// ROW_TILE (gw == 64): the tile's key rows are whole grid rows, so a key's rel-w term is
// the register rw[j % 8][e] for the whole loop, folded into the FFMA, and the rel-h term h
// of key row u is one shared read per tile that never touches a score: the row max of
// key row u is max(s') + h, and p = ex2(s' - (m - h)). A key row past the grid (the
// half-empty last tile when BK = 128) has h = -inf. Otherwise each column's (ky, kx) is
// derived once per tile by a reciprocal multiply and both terms are shared reads; MASK
// (the last tile when S % BK != 0) sets pad keys to -inf. This part leaves the
// probabilities in s and returns the rescale factors of o and l in a; global_finish
// rescales o and packs p once the p.v product of the previous tile no longer writes o.
template <int BK, bool HAS_BIAS, bool ROW_TILE, bool MASK>
__device__ __forceinline__ void global_softmax(float (&s)[BK / 2], float (&m)[2],
                                               float (&l)[2], float (&a)[2],
                                               const float (&rw0)[8][2],
                                               const float (&rw1)[8][2], const GRows& rows,
                                               int kt) {
  constexpr int NU = BK / 64;  // 64-key parts of the tile (one grid row each with ROW_TILE)
  const int t = threadIdx.x & 3;
  float h0[NU], h1[NU], mx0[NU], mx1[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    h0[u] = h1[u] = 0.f;
    mx0[u] = mx1[u] = -INFINITY;
    if (HAS_BIAS && ROW_TILE) {
      const int ky = kt * NU + u;
      h0[u] = ky < rows.gh ? rows.rh0[ky] : -INFINITY;
      h1[u] = ky < rows.gh ? rows.rh1[ky] : -INFINITY;
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v0, v1;
      const int key = kt * BK + 8 * j + 2 * t + e;
      if (HAS_BIAS && ROW_TILE) {
        v0 = fmaf(s[4 * j + e], rows.scale_log2, rw0[j % 8][e]);
        v1 = fmaf(s[4 * j + 2 + e], rows.scale_log2, rw1[j % 8][e]);
      } else if (HAS_BIAS) {
        int ky = __float2int_rz(__fmul_rn((float)key + 0.5f, rows.inv_gw));
        const int kx = key - ky * rows.gw;
        if (MASK) ky = min(ky, rows.gh - 1);  // pad keys: any row in range, masked below
        v0 = fmaf(s[4 * j + e], rows.scale_log2, rows.rh0[ky] + rows.rw0[kx]);
        v1 = fmaf(s[4 * j + 2 + e], rows.scale_log2, rows.rh1[ky] + rows.rw1[kx]);
      } else {
        v0 = s[4 * j + e] * rows.scale_log2;
        v1 = s[4 * j + 2 + e] * rows.scale_log2;
      }
      if (MASK && key >= rows.S) v0 = v1 = -INFINITY;
      s[4 * j + e] = v0;
      s[4 * j + 2 + e] = v1;
      mx0[j / 8] = fmaxf(mx0[j / 8], v0);
      mx1[j / 8] = fmaxf(mx1[j / 8], v1);
    }
  }
  float tm0 = -INFINITY, tm1 = -INFINITY;  // the tile's row maxima, rel-h included
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    tm0 = fmaxf(tm0, mx0[u] + h0[u]);
    tm1 = fmaxf(tm1, mx1[u] + h1[u]);
  }
  tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 1));
  tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 2));
  tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 1));
  tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 2));
  const float mn0 = fmaxf(m[0], tm0), mn1 = fmaxf(m[1], tm1);
  const float a0 = ex2(m[0] - mn0), a1 = ex2(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float c0 = mn0 - h0[j / 8], c1 = mn1 - h1[j / 8];  // folded per part
    s[4 * j] = ex2(s[4 * j] - c0);
    s[4 * j + 1] = ex2(s[4 * j + 1] - c0);
    s[4 * j + 2] = ex2(s[4 * j + 2] - c1);
    s[4 * j + 3] = ex2(s[4 * j + 3] - c1);
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l[0] = l[0] * a0 + ps0;
  l[1] = l[1] * a1 + ps1;
  a[0] = a0;
  a[1] = a1;
}

template <int D, int BK>
__device__ __forceinline__ void global_finish(const float (&s)[BK / 2],
                                              float (&o)[GPanels<D>::NP][32],
                                              uint32_t (&p)[BK / 16][4], const float (&a)[2]) {
#pragma unroll
  for (int pn = 0; pn < GPanels<D>::NP; ++pn) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[pn][4 * j] *= a[0];
      o[pn][4 * j + 1] *= a[0];
      o[pn][4 * j + 2] *= a[1];
      o[pn][4 * j + 3] *= a[1];
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// s = q . k^T of one tile for this warpgroup's 64 rows: A = Q from the registers qa
// (loaded once), B = K from shared memory.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2],
                                         const uint32_t (&qa)[GPanels<D>::KS][4],
                                         const unsigned char* sK) {
#pragma unroll
  for (int kk = 0; kk < GPanels<D>::KS; ++kk) {
    const uint64_t b = sw128_desc(sK + (kk >> 2) * BK * 128) + (kk & 3) * 2;
    if constexpr (BK == 64)
      wgmma_rs_n64<0>(s, qa[kk], b, kk > 0);
    else
      wgmma_rs_n128(s, qa[kk], b, kk > 0);
  }
}

// o += p . v of one tile (A = p from registers, B = V shared through the transpose bit).
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[GPanels<D>::NP][32],
                                         const uint32_t (&p)[BK / 16][4],
                                         const unsigned char* sV) {
#pragma unroll
  for (int pn = 0; pn < GPanels<D>::NP; ++pn) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_n64<1>(o[pn], p[kk], sw128_desc(sV + pn * BK * 128 + kk * 16 * 128), 1);
  }
}

template <int D, int BK>
__host__ __device__ constexpr size_t global_smem_fixed() {
  return 1024 + (size_t)GPanels<D>::NP * GQ * 128 +
         (size_t)GStages<D, BK>::NS * 2 * GPanels<D>::NP * BK * 128 +
         (size_t)(1 + 2 * GStages<D, BK>::NS) * 8;
}

// One CTA per (128 query rows, batch*head): q/k/v/out (BH, S, D) bf16, S = gh * gw; rph
// (2gh - 1, D) and rpw (2gw - 1, D) f32, the compact rel-pos tables (null without bias).
// Warpgroup 0 is the producer: one thread issues Q's TMA, then keeps the ring of K/V tiles
// full (full/empty mbarriers). Warpgroups 1 and 2 each own 64 query rows: they make their
// bias projections in shared memory while the first tiles land, then run q.k (wgmma),
// the softmax, and p.v (wgmma) per tile; with the bias they take turns at the tensor cores
// through two named barriers (one issues q.k of tile kt and p.v of tile kt-1 while the
// other runs its softmax).
template <int D, int BK, bool HAS_BIAS, bool ROW_TILE>
__global__ void __launch_bounds__(G_THREADS, 1)
    global_attn_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const float* __restrict__ rph,
                       const float* __restrict__ rpw, __nv_bfloat16* __restrict__ out, int S,
                       int gh, int gw, int sth, int stw, float scale_log2) {
  constexpr int NP = GPanels<D>::NP, NS = GStages<D, BK>::NS;
  constexpr int QBYTES = NP * GQ * 128, KVBYTES = NP * BK * 128;
  constexpr bool TURNS = HAS_BIAS;
  extern __shared__ unsigned char g_smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(g_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sKV = sQ + QBYTES;  // stage s: K at s * 2 * KVBYTES, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + NS * 2 * KVBYTES);
  uint64_t* qfull = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;
  float* sRh = reinterpret_cast<float*>(bars + 1 + 2 * NS);  // (GQ, sth) x LOG2E
  float* sRw = sRh + GQ * sth;                                 // (GQ, stw) x LOG2E
  const int bh = blockIdx.y, q0 = blockIdx.x * GQ;
  const int nk = (S + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, wg = warp >> 2;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qfull, QBYTES);
      for (int pn = 0; pn < NP; ++pn)
        tma_load_3d(sQ + pn * GQ * 128, &tq, qfull, 64 * pn, q0, bh);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % NS, u = kt / NS;
        if (u) mbar_wait(&empty[s], (u - 1) & 1);
        unsigned char* sK = sKV + s * 2 * KVBYTES;
        mbar_expect_tx(&full[s], 2 * KVBYTES);
        for (int pn = 0; pn < NP; ++pn) {
          tma_load_3d(sK + pn * BK * 128, &tk, &full[s], 64 * pn, kt * BK, bh);
          tma_load_3d(sK + KVBYTES + pn * BK * 128, &tv, &full[s], 64 * pn, kt * BK, bh);
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
    const int lr0 = 64 * c + 16 * (warp & 3);  // this warp's first CTA-local row
    const int r0 = lr0 + gq, r1 = r0 + 8;
    mbar_wait(qfull, 0);
    uint32_t qa[GPanels<D>::KS][4];  // this warp's 16 Q rows as wgmma A fragments
    load_q_fragments<D>(sQ, lr0, qa);
    float rw0[8][2], rw1[8][2];
    GRows rows{sRh + r0 * sth, sRh + r1 * sth, sRw + r0 * stw, sRw + r1 * stw, S, gh, gw,
               1.f / (float)gw, scale_log2};
    if (HAS_BIAS) {
      // grid coordinates of this thread's rows and the ranges over the warp's 16 rows
      // (pad rows past S take the last token's)
      const int tf = min(q0 + lr0, S - 1), tl = min(q0 + lr0 + 15, S - 1);
      const int ta = min(q0 + r0, S - 1), tb = min(q0 + r1, S - 1);
      const int ya = ta / gw, yb = tb / gw, yf = tf / gw, yl = tl / gw;
      global_projection<D>(sQ, lr0, rph, gh, ya, yb, yf, yl, sRh, sth);
      const bool one_row = yf == yl;
      global_projection<D>(sQ, lr0, rpw, gw, ta - ya * gw, tb - yb * gw,
                           one_row ? tf - yf * gw : 0, one_row ? tl - yl * gw : gw - 1, sRw,
                           stw);
      __syncwarp();
      if (ROW_TILE) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            rw0[j][e] = rows.rw0[8 * j + 2 * t + e];
            rw1[j][e] = rows.rw1[8 * j + 2 * t + e];
          }
        }
      }
    }
    float o[NP][32], s[BK / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[pn][i] = 0.f;
    const int me = 1 + c, other = 2 - c;  // named barriers 1 and 2
    const int nfull = S / BK;               // tiles with no pad key
    if (c == 1) named_arrive<TURNS>(1);     // consumer 0 takes the first turn
    float a[2];
    // tile 0: q.k alone
    mbar_wait(&full[0], 0);
    named_sync<TURNS>(me);
    wg_fence();
    issue_qk<D, BK>(s, qa, sKV);
    wg_commit();
    named_arrive<TURNS>(other);
    wg_wait<0>();
    fence_regs(s);
    if (0 < nfull || ROW_TILE)
      global_softmax<BK, HAS_BIAS, ROW_TILE, false>(s, m, l, a, rw0, rw1, rows, 0);
    else
      global_softmax<BK, HAS_BIAS, ROW_TILE, true>(s, m, l, a, rw0, rw1, rows, 0);
    global_finish<D, BK>(s, o, p, a);
    for (int kt = 1; kt < nk; ++kt) {
      const int st = kt % NS, prev = (kt - 1) % NS;
      mbar_wait(&full[st], (kt / NS) & 1);
      named_sync<TURNS>(me);
      wg_fence();
      // q.k of tile kt first: its softmax then runs while p.v of tile kt-1 is in flight
      issue_qk<D, BK>(s, qa, sKV + st * 2 * KVBYTES);
      wg_commit();
      issue_pv<D, BK>(o, p, sKV + prev * 2 * KVBYTES + KVBYTES);
      wg_commit();
      named_arrive<TURNS>(other);
      wg_wait<1>();
      fence_regs(s);
      if (kt < nfull || ROW_TILE)
        global_softmax<BK, HAS_BIAS, ROW_TILE, false>(s, m, l, a, rw0, rw1, rows, kt);
      else
        global_softmax<BK, HAS_BIAS, ROW_TILE, true>(s, m, l, a, rw0, rw1, rows, kt);
      wg_wait<0>();
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) fence_regs(o[pn]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
      global_finish<D, BK>(s, o, p, a);
    }
    // the last tile's p.v; consumer 1 makes no arrive after its last turn, so each named
    // barrier gets as many arrivals as it has waits
    named_sync<TURNS>(me);
    wg_fence();
    issue_pv<D, BK>(o, p, sKV + ((nk - 1) % NS) * 2 * KVBYTES + KVBYTES);
    wg_commit();
    if (c == 0) named_arrive<TURNS>(other);
    wg_wait<0>();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) fence_regs(o[pn]);
    float l0 = l[0], l1 = l[1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float il0 = 1.f / l0, il1 = 1.f / l1;
    const int row0 = q0 + r0, row1 = q0 + r1;
    __nv_bfloat16* o0 = out + ((size_t)bh * S + row0) * D;
    __nv_bfloat16* o1 = out + ((size_t)bh * S + row1) * D;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * pn + 8 * j + 2 * t;
        if (col >= D) continue;
        if (row0 < S)
          *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
              __floats2bfloat162_rn(o[pn][4 * j] * il0, o[pn][4 * j + 1] * il0);
        if (row1 < S)
          *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
              __floats2bfloat162_rn(o[pn][4 * j + 2] * il1, o[pn][4 * j + 3] * il1);
      }
    }
  }
}


// ---- host side ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int ERR_TENSOR_MAP = 1000;  // + the CUresult; 1000 alone: no driver entry point
constexpr int ERR_ARGUMENT = 2000;    // an argument the kernels do not take (_build.launch)

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no link against libcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A (BH, S, D) bf16 tensor as a 3-D TMA map whose box is 64 columns x `rows` rows of one
// batch*head, 128B-swizzled (the wgmma operand layout); reads past S are zero-filled.
int bf16_map(CUtensorMap* map, const void* ptr, int D, int S, int BH, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return ERR_TENSOR_MAP;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
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

template <int D, bool HAS_BIAS, bool ROW_TILE>
int launch_global(const void* q, const void* k, const void* v, const void* rph,
                  const void* rpw, void* out, int BH, int S, int gh, int gw, float scale,
                  cudaStream_t st) {
  // geometry mirrored by tmr_tpu_torch/ops/cuda_attn.py global_geometry: 128-key tiles
  // on the main path at D = 64 (64-key tiles measured slower there); without the bias 128
  // measured slower, and the general bias path's per-column (ky, kx) does not fit the
  // registers; at D = 80 a ring of 128-key tiles with the 64x64 projections fits only 2
  // stages, and the second output panel leaves the registers no room for 64 scores
  constexpr int BK = HAS_BIAS && ROW_TILE && D == 64 ? 128 : 64;
  CUtensorMap tq, tk, tv;
  int e;
  if ((e = bf16_map(&tq, q, D, S, BH, GQ)) || (e = bf16_map(&tk, k, D, S, BH, BK)) ||
      (e = bf16_map(&tv, v, D, S, BH, BK)))
    return e;
  const int sth = HAS_BIAS ? gh | 1 : 0, stw = HAS_BIAS ? gw | 1 : 0;
  const size_t smem = global_smem_fixed<D, BK>() + (size_t)GQ * (sth + stw) * 4;
  auto kernel = global_attn_kernel<D, BK, HAS_BIAS, ROW_TILE>;
  if ((e = launch_prep(kernel, smem))) return e;
  kernel<<<dim3((S + GQ - 1) / GQ, BH), G_THREADS, smem, st>>>(
      tq, tk, tv, (const float*)rph, (const float*)rpw, (__nv_bfloat16*)out, S, gh, gw, sth,
      stw, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D, int NTW>
int launch_window(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                  void* out, int BH, int S, int gh, int gw, float scale, cudaStream_t st) {
  // geometry mirrored by tmr_tpu_torch/ops/cuda_attn.py window_geometry
  const int gwp = 8 * NTW, ghp = gh + ((gh * NTW) & 1), sp = (S + 15) / 16 * 16;
  const int st_h = (gh + 1) | 1;
  const size_t smem = (size_t)(sp + 2 * ghp * gwp) * D * 2 + (size_t)sp * (st_h + gwp) * 4;
  int e;
  if ((e = launch_prep(window_attn_kernel<D, NTW>, smem))) return e;
  window_attn_kernel<D, NTW><<<BH, WIN_WARPS<D> * 32, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)rh, (const float*)rw, (__nv_bfloat16*)out, S, gh, gw, ghp, sp, st_h,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int global_entry(const void* q, const void* k, const void* v, const void* rph, const void* rpw,
                 void* out, int BH, int S, int gh, int gw, float scale, int has_bias,
                 cudaStream_t st) {
  if (!has_bias)
    return launch_global<D, false, false>(q, k, v, nullptr, nullptr, out, BH, S, gh, gw,
                                          scale, st);
  if (gw == 64)
    return launch_global<D, true, true>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, st);
  return launch_global<D, true, false>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, st);
}

template <int D>
int window_entry(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                 void* out, int BH, int S, int gh, int gw, float scale, cudaStream_t st) {
  if (gw <= 8) return launch_window<D, 1>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  if (gw <= 16) return launch_window<D, 2>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  if (gw <= 32) return launch_window<D, 4>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  if (gw <= 64) return launch_window<D, 8>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  return ERR_ARGUMENT;
}

}  // namespace

extern "C" {

// q/k/v/out: (BH, S, D) bf16 contiguous over a (gh, gw) token grid, S = gh * gw >= 1, head
// dim D = 64 or 80; rph (2gh - 1, D) and rpw (2gw - 1, D) f32 contiguous, the compact
// rel-pos tables, or null when has_bias == 0. Returns 0 when launched, a CUDA error code,
// 1000 (+ the CUresult) when a TMA descriptor cannot be made, or 2000 for a head dim the
// kernel does not take.
int tmr_global_attn(const void* q, const void* k, const void* v, const void* rph,
                    const void* rpw, void* out, int BH, int S, int gh, int gw, int D,
                    float scale, int has_bias, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64)
    return global_entry<64>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, has_bias, st);
  if (D == 80)
    return global_entry<80>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, has_bias, st);
  return ERR_ARGUMENT;
}

// q/k/v/out: (BH, S, D) bf16 contiguous with S = gh * gw window tokens, D = 64 or 80; rh
// (gh, gh, D) and rw (gw, gw, D) f32 contiguous, the get_rel_pos tables. One CTA per
// window-head; rows of up to 64 tokens (gw <= 64). Returns the CUDA error code (0 =
// launched), or 2000 for a head dim or a window row the kernel does not take.
int tmr_window_attn(const void* q, const void* k, const void* v, const void* rh,
                    const void* rw, void* out, int BH, int S, int gh, int gw, int D,
                    float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 64) return window_entry<64>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  if (D == 80) return window_entry<80>(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
  return ERR_ARGUMENT;
}

}  // extern "C"
