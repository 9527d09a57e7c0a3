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
//  5. Copies and occupancy: K/V tiles (128-byte rows, 128B-swizzled; head dim 80 below)
//     arrive by TMA (cp.async.bulk.tensor, 3-D maps over (BH, S, D)) into a ring (3
//     stages of 128 keys, 96 KB, on the main path; 4 of 64 elsewhere) with full/empty
//     mbarriers, fed by one producer thread; the producer warpgroup hands its registers
//     to the consumers (setmaxnreg 40 / 232). One CTA of 12 warps per SM (182 KB of
//     shared memory on the main path).
// Alternatives measured slower on the main path and removed (PERF.md): Q read from shared
// memory by every q.k, 64-key tiles, and no turn-taking with the bias.
// Any token count: Q rows and K/V keys past S are zero-filled by TMA; the last tile's pad
// keys get -inf (a separate instantiation of the tile step, so full tiles run no mask
// instruction; on the main path a key row past the grid has rel-h -inf); pad query rows
// are never stored. When a grid row is 64 tokens (the main path) a lane's rel-w terms are
// 16 registers for the whole loop and its rel-h terms one shared read per key row and
// tile. So too when a grid row is 96 tokens (the 1536 bucket's 96x96 grid): each K/V tile
// is one grid row of 96 keys (q.k one m64n96k16 wgmma a k-step, p.v six k16 steps, no pad
// key since S = 96 gh), a lane's rel-w terms are 24 registers and its rel-h term one shared
// read a tile; measured in turns (scripts/attn_variants.py, PERF.md) 2.5x faster than the
// general path below at BH 48 and 1.6x at head dim 80, and rel-w read from shared memory
// per 8-key group 1.8x slower than from registers. Other grids (24x40, 20x20, ...) derive
// each column's (ky, kx) once per tile by a reciprocal multiply and read both terms from
// shared memory. The head dim is a template parameter (64 and 80 instantiated).
// Head dim 80 (SAM ViT-H: 4 blocks of 64 x 4096 x 80 per batch of 4; 4 S^2 D BH = 344
// GFLOP, 0.347 ms at the bf16 peak) at its 80 columns: a row of Q, K or V is a 64-column
// 128B-swizzled panel plus a 16-column 32B-swizzled one (its own TMA box of 16 columns and
// 32-byte rows, its own wgmma descriptor, sw32_desc), 160 bytes a row with no padding. q.k
// takes k-steps 0-3 from the first panel and k-step 4 from the second; p.v is one
// m64n64k16 and one m64n16k16 a 16-key step, 80 columns of products and 40 accumulator
// registers. So a 128-key stage is 40 KB, and the main path runs D = 64's ring: 3 stages of
// 128 keys with the 64x64 projections (211,000 B), and 3 stages of 96 keys on 96-token rows
// (213,048 B with the 96x96 grid's). The design it replaced kept two 64-column panels, the
// second zero-filled past column 80: p.v performed 128 / 80 of the products, and only 64-key
// tiles fit (3 stages; 2 of 96 keys on 96-token rows). Measured in turns against it
// (scripts/attn_variants.py, PERF.md): 64x64 with the bias 0.928-0.959 ms against
// 1.029-1.134, 64-key tiles in this layout 1.005-1.016; without the bias 0.900-0.905
// against 0.934-0.943 (128-key tiles 0.920-0.949, 3 stages of 64 keys 0.974-0.998); 96x96
// 4.14-4.47 against 5.87-6.14 (2 stages of 96 keys 5.06-5.20).
// nvcc 12.9 -Xptxas -v (sm_90a), each of <D, 128, bias, 64>, <D, 96, bias, 96>,
// <D, 64, bias, 0> and <D, 64, no bias, 0> (<D, BK, bias, GW>) at D = 64 and 80: 168
// registers (the launch bound's share of 384 threads), 0 bytes stack frame, 0 spills.
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
// Head dim 80, windows wider or taller than 16 (off every SAM path): rows of 160 bytes in
// 10 chunks keep the ldmatrix phases conflict-free with a one-bit swizzle (swz); one CTA
// of 16 warps an SM, a warp re-reading its Q fragments for each key chunk so that 16 warps
// fit 128 registers. <64, NTW> as above.
//
// Head dim 80, windows up to 16x16 (SAM ViT-H: 1600 window-heads of 14x14 a block, 28
// blocks a batch of 4; q, k, v and out are 201 MB a call, 0.060 ms at 3.35 TB/s; 19.7
// GFLOP, ~29 as performed with the padding): window_attn_kernel_wg<NSLOT, GWP>. The design
// it replaced (the one above, 16 warps of mma.sync) took 0.208-0.214 ms at 14x14: one CTA
// an SM with no overlap of one window-head's loads and the next one's math, every warp
// reading all of K and V for its 16 rows, online softmax over 64-key chunks. This design:
//  - Persistent CTAs: min(BH, SMs), CTA b taking window-heads b, b + gridDim.x, ... One
//    thread of warpgroup 0 loads by TMA: K and V through 4-D maps over (BH, gh, gw, 80)
//    whose box is whole key rows of GWP = 16 slots (14 rows, 16 for windows taller than
//    14), so TMA writes the slots in grid-row order and zero-fills columns past gw and rows
//    past gh;
//    Q through a 3-D map, 256 rows, zero past S. Both in two panels, 64 columns
//    128B-swizzled and 16 columns 32B-swizzled (as the global kernel's GPanels<80>). Q is
//    reloaded as soon as the last q.k has read it, K and V (one stage) as soon as the last
//    p.v has.
//  - wgmma on 64-row strips: the two consumer warpgroups take strips c, c + 2 of the 256
//    staged rows, no barrier between them. q.k is one m64n<NSLOT>k16 chain (A = Q and B =
//    K from shared memory: k-steps 0-3 from the 64-column panel, 4 from the 16-column
//    one); the softmax is one pass over all NSLOT slots (the JAX kernel's one block of
//    keys), p normalized before its bf16 rounding as the JAX kernel does; p.v is one
//    m64n64k16 and one m64n16k16 a 16-key step (A = p from registers: the q.k accumulator
//    is the A fragment; B = V through the transpose bit). A lane keeps the rel-w values of
//    its n-tile columns in registers and reads one rel-h value a key row; pad slots fall
//    out through -inf rel-w (columns past gw) or rel-h (rows past gh) entries.
//  - Projections one window-head ahead: warps 1-3 of warpgroup 0 make the next
//    window-head's projections (window_projections_ahead) into the other of two buffers,
//    while the strips of this one run.
// Measured (scripts/attn_variants.py, PERF.md; NVIDIA H100 80GB HBM3, 700 W), 14x14 at BH
// 1600 in turns against the design it replaced: 0.191-0.193 ms against 0.215-0.218
// (BH 3136: 0.335-0.342 against 0.388-0.397). Phase cuts: the loads alone 0.052, with
// the projections 0.117, with the strips 0.156-0.158; the strips and projections with no
// load 0.177-0.178; the table or q loads of the projections cut 0.174-0.176: the
// projections (made from the expanded f32 tables through L2, ~21k cycles a window-head
// for three warps) bound the kernel, and the strips (~17k: q.k 2.5k, softmax 7.5k, p.v
// 4.2k, stores 2.8k for a warpgroup's two) are nearly as long. Alternatives measured
// slower and removed: two K/V stages at 14x14 0.194-0.197 (L1 then holds 28 KB of the
// tables' 125 KB; at 7x7 they tie one stage, 0.091 ms); projection trips of one unit
// 0.204-0.206; 104 / 200 registers handed over by setmaxnreg with such trips 0.206-0.207;
// the wgmma unserialized 0.210-0.211.
// ptxas serializes the strips' wgmma (info C7520: arrives under a branch on the strip),
// and so they fit 168 registers with no spill; with the arrives and stores under
// predicates it does not serialize them, and spills 320 bytes at 224 slots. Four consumer
// warpgroups (one strip each) or two halves of 112 slots were not built: a fourth
// warpgroup leaves 128 registers a thread, where the 112 score registers do not fit and
// m64n256k16 does not compile. Two instantiations: <224, 16> for windows of up to 14 rows
// (a 7x7 window there takes 0.091 ms at BH 1600, where a 64-slot build took 0.066) and
// <256, 16>. nvcc -Xptxas -v (sm_90a): <224, 16> 168 registers, no spill; <256, 16> 168
// registers, 24 bytes of spill stores.

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

// bf16 hi/lo split of two f32 values: x = hi + lo + O(2^-18 |x|). Two conversions: hi
// packed by one, read back by shifts.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
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

// Head dim D as a tile of R rows holds it: columns 0-63 in a 64-column panel (R rows of 128
// bytes, 128B-swizzled), and at D = 80 columns 64-79 after it in a 16-column panel (R rows
// of 32 bytes, 32B-swizzled: 16-byte chunk c of row r at chunk c ^ ((r >> 2) & 1)). A tile
// takes R * 2D bytes, no column of padding; both panels stay 1024-byte aligned (R is a
// multiple of 32).
template <int D>
struct GPanels {
  static_assert(D == 64 || D == 80, "the global kernel takes head dim 64 or 80");
  static constexpr int TW = D - 64;   // columns of the 16-column panel (0: none)
  static constexpr int KS = D / 16;   // 16-wide k-steps of q.k
  static constexpr int ROW = 2 * D;   // bytes of a row over both panels
};
// K/V ring depth: 3 stages of 128-key tiles (96 KB at D = 64, 120 KB at 80); 4 of 64-key
// tiles (64 / 80 KB); 96-key tiles 4 stages at D = 64 (96 KB; with the 96x96 grid's
// projections 215,112 B) and 3 at D = 80 (90 KB; 213,048 B), within the 232,448 a block
// may use.
template <int D, int BK>
struct GStages {
  static constexpr int NS = D == 64 ? (BK == 128 ? 3 : 4) : (BK == 64 ? 4 : 3);
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

// The same for a 32B-swizzled 16-column panel (rows of 32 bytes, 8-row groups 256 bytes
// apart: the stride offset 16; layout type 3 in bits 62-63; 256-byte aligned): K-major
// it is one 16-wide k-step of Q or K; MN-major (V) it is 16 columns of p.v, 16-key k-steps
// 512 bytes apart. One 32-byte span holds all 16 columns, so the leading offset (the
// next span's) is never read.
__device__ __forceinline__ uint64_t sw32_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (16ull << 32) |
         (3ull << 62);
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

// d (64 x 16, f32) (+)= A (64 x 16, bf16 registers) . B (16 x 16, shared; TB as above)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, %14;\n}\n"
      : WG_ACC8(0)
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

// d (64 x 96, f32) (+)= A (64 x 16, bf16 registers) . B (16 x 96, shared, K-major)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,"
      "%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,"
      "%44,%45,%46,%47}, {%48,%49,%50,%51}, %52, p, 1, 1, 0;\n}\n"
      : WG_ACC32(0), WG_ACC8(32), WG_ACC8(40)
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
    if (kk < 4)  // the 64-column panel
      ldsm_x4(a[kk], sQ + row * 128 + ((chunk ^ (row & 7)) << 4));
    else  // the 16-column panel
      ldsm_x4(a[kk], sQ + GQ * 128 + row * 32 + (((chunk & 1) ^ ((row >> 2) & 1)) << 4));
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
// Row tiles (GW > 0, a grid of gw == GW): each tile is BK / GW whole grid rows (GW 64: two
// rows of 64 keys at BK 128, or one at BK 64 for head dim 80; GW 96: one row of 96 keys),
// so a key's rel-w term is the register rw[j % (GW / 8)][e] for the whole loop, folded into
// the FFMA, and the rel-h term h of key row u is one shared read per tile that never
// touches a score: the row max of key row u is max(s') + h, and p = ex2(s' - (m - h)). A
// key row past the grid (the half-empty last tile when BK = 128) has h = -inf. Otherwise
// (GW = 0) each column's (ky, kx) is derived once per tile by a reciprocal multiply and
// both terms are shared reads; MASK (the last tile when S % BK != 0) sets pad keys to
// -inf. This part leaves the probabilities in s and returns the rescale factors of o and l
// in a; global_finish rescales o and packs p once the p.v product of the previous tile no
// longer writes o.
template <int GW>
constexpr int RW_GROUPS = GW > 0 ? GW / 8 : 1;  // a row's 8-key groups (rel-w registers)

template <int BK, bool HAS_BIAS, int GW, bool MASK>
__device__ __forceinline__ void global_softmax(float (&s)[BK / 2], float (&m)[2],
                                               float (&l)[2], float (&a)[2],
                                               const float (&rw0)[RW_GROUPS<GW>][2],
                                               const float (&rw1)[RW_GROUPS<GW>][2],
                                               const GRows& rows, int kt) {
  static_assert(GW == 0 || BK % GW == 0, "a row tile holds whole grid rows");
  constexpr bool ROW = GW > 0;
  constexpr int NU = ROW ? BK / GW : 1;          // grid rows of the tile (parts)
  constexpr int JG = ROW ? GW / 8 : BK / 8;      // 8-key groups a part
  const int t = threadIdx.x & 3;
  float h0[NU], h1[NU], mx0[NU], mx1[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    h0[u] = h1[u] = 0.f;
    mx0[u] = mx1[u] = -INFINITY;
    if (HAS_BIAS && ROW) {
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
      if (HAS_BIAS && ROW) {
        v0 = fmaf(s[4 * j + e], rows.scale_log2, rw0[j % JG][e]);
        v1 = fmaf(s[4 * j + 2 + e], rows.scale_log2, rw1[j % JG][e]);
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
      mx0[j / JG] = fmaxf(mx0[j / JG], v0);
      mx1[j / JG] = fmaxf(mx1[j / JG], v1);
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
    const float c0 = mn0 - h0[j / JG], c1 = mn1 - h1[j / JG];  // folded per part
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

// A wgmma accumulator's rows g and g + 8 scaled by a[0] and a[1].
template <int N>
__device__ __forceinline__ void rescale(float (&x)[N], const float (&a)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    x[4 * j] *= a[0];
    x[4 * j + 1] *= a[0];
    x[4 * j + 2] *= a[1];
    x[4 * j + 3] *= a[1];
  }
}

// o: columns 0-63 in the m64n64 accumulator layout; ot: columns 64-79 at D = 80 (m64n16).
template <int D, int BK>
__device__ __forceinline__ void global_finish(const float (&s)[BK / 2], float (&o)[32],
                                              float (&ot)[8], uint32_t (&p)[BK / 16][4],
                                              const float (&a)[2]) {
  rescale(o, a);
  if constexpr (GPanels<D>::TW > 0) rescale(ot, a);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// s = q . k^T of one tile for this warpgroup's 64 rows: A = Q from the registers qa
// (loaded once), B = K from shared memory: k-steps 0-3 from the 64-column panel (32 bytes
// apart in its rows), k-step 4 (D = 80) from the 16-column panel.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2],
                                         const uint32_t (&qa)[GPanels<D>::KS][4],
                                         const unsigned char* sK) {
#pragma unroll
  for (int kk = 0; kk < GPanels<D>::KS; ++kk) {
    const uint64_t b = kk < 4 ? sw128_desc(sK) + kk * 2 : sw32_desc(sK + BK * 128);
    if constexpr (BK == 64)
      wgmma_rs_n64<0>(s, qa[kk], b, kk > 0);
    else if constexpr (BK == 96)
      wgmma_rs_n96(s, qa[kk], b, kk > 0);
    else
      wgmma_rs_n128(s, qa[kk], b, kk > 0);
  }
}

// o += p . v of one tile (A = p from registers, B = V shared through the transpose bit):
// per 16-key k-step one m64n64k16 over the 64-column panel and, at D = 80, one m64n16k16
// over the 16-column panel, so p.v performs exactly the D columns it needs.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[32], float (&ot)[8],
                                         const uint32_t (&p)[BK / 16][4],
                                         const unsigned char* sV) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs_n64<1>(o, p[kk], sw128_desc(sV + kk * 16 * 128), 1);
    if constexpr (GPanels<D>::TW > 0)
      wgmma_rs_n16<1>(ot, p[kk], sw32_desc(sV + BK * 128 + kk * 16 * 32), 1);
  }
}

// Dynamic shared memory of the global kernel: alignment slack, Q, the K/V ring, its
// mbarriers and, with the bias, the (GQ, gh | 1) and (GQ, gw | 1) f32 projections.
template <int D, int BK, bool HAS_BIAS>
size_t global_smem(int gh, int gw) {
  return 1024 + (size_t)GQ * GPanels<D>::ROW +
         (size_t)GStages<D, BK>::NS * 2 * BK * GPanels<D>::ROW +
         (size_t)(1 + 2 * GStages<D, BK>::NS) * 8 +
         (HAS_BIAS ? (size_t)GQ * ((gh | 1) + (gw | 1)) * 4 : 0);
}

// The TMA maps of q, k and v: a box of the 64-column panel (128B-swizzled) each and, at
// D = 80, one of the 16-column panel (32B-swizzled) each.
template <int D>
struct GMaps {
  CUtensorMap q, k, v;
};
template <>
struct GMaps<80> {
  CUtensorMap q, k, v, q16, k16, v16;
};

// One CTA per (128 query rows, batch*head): q/k/v/out (BH, S, D) bf16, S = gh * gw; rph
// (2gh - 1, D) and rpw (2gw - 1, D) f32, the compact rel-pos tables (null without bias).
// Warpgroup 0 is the producer: one thread issues Q's TMA, then keeps the ring of K/V tiles
// full (full/empty mbarriers). Warpgroups 1 and 2 each own 64 query rows: they make their
// bias projections in shared memory while the first tiles land, then run q.k (wgmma),
// the softmax, and p.v (wgmma) per tile; with the bias they take turns at the tensor cores
// through two named barriers (one issues q.k of tile kt and p.v of tile kt-1 while the
// other runs its softmax). GW > 0: the grid's rows are GW tokens and each tile is whole
// rows of it (global_softmax); GW = 0: any grid.
template <int D, int BK, bool HAS_BIAS, int GW>
__global__ void __launch_bounds__(G_THREADS, 1)
    global_attn_kernel(const __grid_constant__ GMaps<D> tm, const float* __restrict__ rph,
                       const float* __restrict__ rpw, __nv_bfloat16* __restrict__ out, int S,
                       int gh, int gw, int sth, int stw, float scale_log2) {
  constexpr int NS = GStages<D, BK>::NS, TW = GPanels<D>::TW;
  constexpr int QBYTES = GQ * GPanels<D>::ROW, KVBYTES = BK * GPanels<D>::ROW;
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
      tma_load_3d(sQ, &tm.q, qfull, 0, q0, bh);
      if constexpr (TW > 0) tma_load_3d(sQ + GQ * 128, &tm.q16, qfull, 64, q0, bh);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % NS, u = kt / NS;
        if (u) mbar_wait(&empty[s], (u - 1) & 1);
        unsigned char* sK = sKV + s * 2 * KVBYTES;
        mbar_expect_tx(&full[s], 2 * KVBYTES);
        tma_load_3d(sK, &tm.k, &full[s], 0, kt * BK, bh);
        tma_load_3d(sK + KVBYTES, &tm.v, &full[s], 0, kt * BK, bh);
        if constexpr (TW > 0) {
          tma_load_3d(sK + BK * 128, &tm.k16, &full[s], 64, kt * BK, bh);
          tma_load_3d(sK + KVBYTES + BK * 128, &tm.v16, &full[s], 64, kt * BK, bh);
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
    float rw0[RW_GROUPS<GW>][2], rw1[RW_GROUPS<GW>][2];
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
      if (GW > 0) {
#pragma unroll
        for (int j = 0; j < RW_GROUPS<GW>; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            rw0[j][e] = rows.rw0[8 * j + 2 * t + e];
            rw1[j][e] = rows.rw1[8 * j + 2 * t + e];
          }
        }
      }
    }
    float o[32], ot[8], s[BK / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ot[i] = 0.f;
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
    if (0 < nfull || GW > 0)
      global_softmax<BK, HAS_BIAS, GW, false>(s, m, l, a, rw0, rw1, rows, 0);
    else
      global_softmax<BK, HAS_BIAS, GW, true>(s, m, l, a, rw0, rw1, rows, 0);
    global_finish<D, BK>(s, o, ot, p, a);
    for (int kt = 1; kt < nk; ++kt) {
      const int st = kt % NS, prev = (kt - 1) % NS;
      mbar_wait(&full[st], (kt / NS) & 1);
      named_sync<TURNS>(me);
      wg_fence();
      // q.k of tile kt first: its softmax then runs while p.v of tile kt-1 is in flight
      issue_qk<D, BK>(s, qa, sKV + st * 2 * KVBYTES);
      wg_commit();
      issue_pv<D, BK>(o, ot, p, sKV + prev * 2 * KVBYTES + KVBYTES);
      wg_commit();
      named_arrive<TURNS>(other);
      wg_wait<1>();
      fence_regs(s);
      if (kt < nfull || GW > 0)
        global_softmax<BK, HAS_BIAS, GW, false>(s, m, l, a, rw0, rw1, rows, kt);
      else
        global_softmax<BK, HAS_BIAS, GW, true>(s, m, l, a, rw0, rw1, rows, kt);
      wg_wait<0>();
      fence_regs(o);
      if constexpr (TW > 0) fence_regs(ot);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
      global_finish<D, BK>(s, o, ot, p, a);
    }
    // the last tile's p.v; consumer 1 makes no arrive after its last turn, so each named
    // barrier gets as many arrivals as it has waits
    named_sync<TURNS>(me);
    wg_fence();
    issue_pv<D, BK>(o, ot, p, sKV + ((nk - 1) % NS) * 2 * KVBYTES + KVBYTES);
    wg_commit();
    if (c == 0) named_arrive<TURNS>(other);
    wg_wait<0>();
    fence_regs(o);
    if constexpr (TW > 0) fence_regs(ot);
    float l0 = l[0], l1 = l[1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float il0 = 1.f / l0, il1 = 1.f / l1;
    const int row0 = q0 + r0, row1 = q0 + r1;
    __nv_bfloat16* o0 = out + ((size_t)bh * S + row0) * D;
    __nv_bfloat16* o1 = out + ((size_t)bh * S + row1) * D;
    // one 8-column group of both rows: its accumulators (x0, x1) row g, (x2, x3) row g + 8
    auto put = [&](int col, float x0, float x1, float x2, float x3) {
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(x0 * il0, x1 * il0);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(x2 * il1, x3 * il1);
    };
#pragma unroll
    for (int j = 0; j < 8; ++j)
      put(8 * j + 2 * t, o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
    if constexpr (TW > 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        put(64 + 8 * j + 2 * t, ot[4 * j], ot[4 * j + 1], ot[4 * j + 2], ot[4 * j + 3]);
    }
  }
}


// ---- windowed attention at head dim 80: persistent warpgroups on wgmma -------------------

constexpr int WQ = 256;  // query rows staged per window-head: 4 strips of 64
constexpr int W_PROJ_WARPS = 3;  // warps 1-3 of warpgroup 0 make the projections

// Bytes of one projection buffer of the head-dim-80 windowed kernel: the (S, gh | 1) rel-h
// and (S, gw) rel-w f32 projections (x LOG2E), rounded up to 16.
__host__ __device__ __forceinline__ int window_wg_proj_bytes(int S, int gh, int gw) {
  return (S * ((gh | 1) + gw) * 4 + 15) & ~15;
}

// Its dynamic shared memory: alignment slack, Q (256 rows of 160 bytes), one stage of K and
// V (`slots` rows of 160 bytes each), 8 mbarriers and two projection buffers.
inline size_t window_wg_smem(int slots, int S, int gh, int gw) {
  return 1024 + (size_t)WQ * 160 + (size_t)2 * slots * 160 + 8 * 8 +
         2 * (size_t)window_wg_proj_bytes(S, gh, gw);
}

// The TMA maps of the head-dim-80 windowed kernel: Q as (BH, S, 80) in boxes of 256 rows;
// K and V as (BH, gh, gw, 80) in boxes of (NSLOT / gwp key rows, gwp slots), so TMA writes
// the key slots in grid-row order and zero-fills slots past the window's rows and columns.
// Each in two panels: 64 columns 128B-swizzled, 16 columns 32B-swizzled.
struct WMaps {
  CUtensorMap q, q16, k, k16, v, v16;
};

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// d (64 x N, f32) (+)= A (64 x 16, shared, K-major) . B (16 x N, shared, K-major)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<224>(float (&d)[112], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,"
      "%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,"
      "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,"
      "%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,"
      "%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,"
      "%105,%106,%107,%108,%109,%110,%111}, %112, %113, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(0), WG_ACC32(32), WG_ACC32(64), WG_ACC8(96), WG_ACC8(104)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,"
      "%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,"
      "%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,"
      "%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,"
      "%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,"
      "%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,"
      "%121,%122,%123,%124,%125,%126,%127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(0), WG_ACC32(32), WG_ACC32(64), WG_ACC32(96)
      : "l"(a), "l"(b), "r"(accumulate));
}

// One query strip's scores -> probabilities, in one pass over all NSLOT slots (the JAX
// kernel's one block of keys). s is the q.k accumulator: s[4j + e] row g, slot 8j + 2t + e;
// s[4j + 2 + e] row g + 8. Slot j is key row j / GWP, column j % GWP, so n-tile j is key row
// j / JG and this lane's columns 8 (j % JG) + 2t + {0, 1}: the bias of a score is the lane's
// rel-h value of that key row (one shared read a key row and query row; -inf past the
// window's rows) plus one of its rel-w registers (-inf past its columns), added with the
// scale in one FFMA. p is normalized before it is rounded to bf16, as the JAX kernel does
// (p / sum p, then the cast), and lands in the A fragments of the p.v wgmma.
template <int NSLOT, int GWP>
__device__ __forceinline__ void window_softmax(float (&s)[NSLOT / 2],
                                               uint32_t (&p)[NSLOT / 16][4],
                                               const float* rh0, const float* rh1,
                                               const float (&rw0)[GWP / 8][2],
                                               const float (&rw1)[GWP / 8][2], int gh,
                                               float scale_log2) {
  constexpr int JG = GWP / 8;
  float mx0 = -INFINITY, mx1 = -INFINITY, h0 = 0.f, h1 = 0.f;
#pragma unroll
  for (int j = 0; j < NSLOT / 8; ++j) {
    const int u = j / JG, jg = j % JG;
    if (jg == 0) {
      const float v0 = rh0[min(u, gh - 1)], v1 = rh1[min(u, gh - 1)];
      h0 = u < gh ? v0 : -INFINITY;
      h1 = u < gh ? v1 : -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = fmaf(s[4 * j + e], scale_log2, h0 + rw0[jg][e]);
      s[4 * j + 2 + e] = fmaf(s[4 * j + 2 + e], scale_log2, h1 + rw1[jg][e]);
      mx0 = fmaxf(mx0, s[4 * j + e]);
      mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NSLOT / 8; ++j) {
    s[4 * j] = ex2(s[4 * j] - mx0);
    s[4 * j + 1] = ex2(s[4 * j + 1] - mx0);
    s[4 * j + 2] = ex2(s[4 * j + 2] - mx1);
    s[4 * j + 3] = ex2(s[4 * j + 3] - mx1);
    l0 += s[4 * j] + s[4 * j + 1];
    l1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float il0 = 1.f / l0, il1 = 1.f / l1;
#pragma unroll
  for (int kk = 0; kk < NSLOT / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk] * il0, s[8 * kk + 1] * il0);
    p[kk][1] = pack_bf16(s[8 * kk + 2] * il1, s[8 * kk + 3] * il1);
    p[kk][2] = pack_bf16(s[8 * kk + 4] * il0, s[8 * kk + 5] * il0);
    p[kk][3] = pack_bf16(s[8 * kk + 6] * il1, s[8 * kk + 7] * il1);
  }
}

// The bias projections of one window-head for the head-dim-80 windowed kernel, made by its
// W_PROJ_WARPS projection warps one window-head ahead of the strips, f32 x LOG2E into a
// projection buffer, as window_projections makes them (q exact in bf16, the f32 table split
// into bf16 hi + lo terms, f32 sums). A window of up to 16x16 has gh + gw <= 32 units, each
// one grid row's (rel-h) or column's (rel-w) tokens: one 16-token tile, two 8-column n-tiles.
// The A fragments are read from q in device memory (that window-head's Q reaches shared
// memory only later), the B fragments from the tables (L2, or L1 where the staging leaves
// room). Warp w takes units w, w + 3, ..., two at a time, so that one trip to memory serves
// two units, and runs their eight product chains (hi and lo terms apart) side by side. Each
// k-step's 16 columns are permuted alike in A and B (the sum does not see the order), so
// that a lane's two column pairs of a row, 2t and 2t + 8, are the 4 adjacent columns
// 4t..4t + 3: one 8-byte load of q and one 16-byte load of a table row each.
__device__ __forceinline__ void window_projections_ahead(const __nv_bfloat16* q,
                                                         const float* rh, const float* rw,
                                                         float* sRH, float* sRW, int gh,
                                                         int gw, int sth, int stw, int pw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int units = gh + gw;
  for (int u0 = pw; u0 < units; u0 += 2 * W_PROJ_WARPS) {
    uint32_t a[2][5][4];
    float4 x[2][2][5];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int u = u0 + W_PROJ_WARPS * k;
      const bool live = u < units, is_h = u < gh;
      const int grp = is_h ? u : u - gh;
      // unit grp: tokens tok0 + i * tstep for i < nrows; output columns ncols
      const int nrows = is_h ? gw : gh, ncols = is_h ? gh : gw;
      const int tok0 = is_h ? grp * gw : grp, tstep = is_h ? 1 : gw;
      // pad rows repeat a real one; a dead unit reads nothing
      const __nv_bfloat16* q0 = q + (size_t)(tok0 + min(g, nrows - 1) * tstep) * 80 + 4 * t;
      const __nv_bfloat16* q1 = q + (size_t)(tok0 + min(g + 8, nrows - 1) * tstep) * 80 + 4 * t;
#pragma unroll
      for (int kk = 0; kk < 5; ++kk) {
        const uint2 r0 = live ? *reinterpret_cast<const uint2*>(q0 + 16 * kk) : make_uint2(0, 0);
        const uint2 r1 = live ? *reinterpret_cast<const uint2*>(q1 + 16 * kk) : make_uint2(0, 0);
        a[k][kk][0] = r0.x;  // row g, the k-step's columns 2t, 2t + 1 (permuted)
        a[k][kk][1] = r1.x;  // row g + 8
        a[k][kk][2] = r0.y;  // row g, columns 2t + 8, 2t + 9
        a[k][kk][3] = r1.y;
      }
      const float* tab = (is_h ? rh : rw) + (size_t)grp * ncols * 80;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * h + g;
        const float* brow = tab + (size_t)min(col, ncols - 1) * 80 + 4 * t;
        const bool ok = live && col < ncols;
#pragma unroll
        for (int kk = 0; kk < 5; ++kk)
          x[k][h][kk] = ok ? *reinterpret_cast<const float4*>(brow + kk * 16)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    // eight independent product chains of five: (unit, n-tile) x (hi, lo terms)
    float c[2][2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 5; ++kk) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hi0, lo0, hi1, lo1;
          split_bf16(x[k][h][kk].x, x[k][h][kk].y, hi0, lo0);
          split_bf16(x[k][h][kk].z, x[k][h][kk].w, hi1, lo1);
          mma_bf16(c[k][h][1], a[k][kk], lo0, lo1);
          mma_bf16(c[k][h][0], a[k][kk], hi0, hi1);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int u = u0 + W_PROJ_WARPS * k;
      if (u >= units) break;
      const bool is_h = u < gh;
      const int grp = is_h ? u : u - gh;
      const int nrows = is_h ? gw : gh, ncols = is_h ? gh : gw;
      const int tok0 = is_h ? grp * gw : grp, tstep = is_h ? 1 : gw;
      float* dst = is_h ? sRH : sRW;
      const int st = is_h ? sth : stw;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = 8 * h + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = g + 8 * r;
          if (i >= nrows) continue;
          float* row = dst + (tok0 + i * tstep) * st;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (c0 + j < ncols)
              row[c0 + j] = (c[k][h][1][2 * r + j] + c[k][h][0][2 * r + j]) * LOG2E;
        }
      }
    }
  }
}

// Persistent CTAs over window-heads, head dim 80: q/k/v/out (BH, S, 80) bf16, S = gh * gw
// <= 256 window tokens; rh (gh, gh, 80) and rw (gw, gw, 80) f32, the get_rel_pos tables.
// CTA b takes window-heads b, b + gridDim.x, ... < BH. In warpgroup 0, one thread of warp 0
// brings each Q as soon as the last q.k has read the one before, and K and V as soon as the
// last p.v has read theirs; warps 1-3 make the bias projections one window-head
// ahead, into two buffers in turn. Warpgroups 1 and 2 take query strips c and c + 2 of every
// window-head, with no barrier between them: per strip q.k (wgmma, A = Q and B = K from
// shared memory), the softmax, p.v (wgmma, A = p from registers, B = V through the
// transpose bit) and the store. Every warp has the launch's 168 registers.
template <int NSLOT, int GWP>
__global__ void __launch_bounds__(G_THREADS, 1)
    window_attn_kernel_wg(const __grid_constant__ WMaps tm, const __nv_bfloat16* __restrict__ q,
                          const float* __restrict__ rh, const float* __restrict__ rw,
                          __nv_bfloat16* __restrict__ out, int BH, int S, int gh, int gw,
                          float scale_log2) {
  constexpr int JG = GWP / 8, QBYTES = WQ * 160, KVBYTES = NSLOT * 160;
  const int sth = gh | 1, stw = gw;
  extern __shared__ unsigned char w_smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(w_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sKV = sQ + QBYTES;  // K, then V at KVBYTES
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + 2 * KVBYTES);
  uint64_t* qfull = bars;
  uint64_t* qempty = bars + 1;
  uint64_t* kvfull = bars + 2;   // K and V landed
  uint64_t* kvempty = bars + 3;  // K and V read
  uint64_t* pfull = bars + 4;    // [2]: a projection buffer written
  uint64_t* pempty = bars + 6;   // [2]: a projection buffer read
  float* sP = reinterpret_cast<float*>(bars + 8);
  const int pfloats = window_wg_proj_bytes(S, gh, gw) / 4;  // buffer b at sP + b * pfloats:
  // rel-h (S, sth) then rel-w (S, stw)
  const int warp = threadIdx.x >> 5, wg = warp >> 2, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 8);  // one arrive per consumer warp
    mbar_init(kvfull, 1);
    mbar_init(kvempty, 8);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&pfull[b], W_PROJ_WARPS);  // one arrive per projection warp
      mbar_init(&pempty[b], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto release = [lane](uint64_t* bar) {  // one arrive a warp
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  if (wg == 0) {
    if (warp == 0) {  // producer
      if (threadIdx.x == 0) {
        int i = 0;
        for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++i) {
          // Q first: it is free after the last q.k, K and V only after the last p.v
          if (i) mbar_wait(qempty, (i - 1) & 1);
          mbar_expect_tx(qfull, QBYTES);
          tma_load_3d(sQ, &tm.q, qfull, 0, 0, bh);
          tma_load_3d(sQ + WQ * 128, &tm.q16, qfull, 64, 0, bh);
          if (i) mbar_wait(kvempty, (i - 1) & 1);
          mbar_expect_tx(kvfull, 2 * KVBYTES);
          tma_load_4d(sKV, &tm.k, kvfull, 0, 0, 0, bh);
          tma_load_4d(sKV + NSLOT * 128, &tm.k16, kvfull, 64, 0, 0, bh);
          tma_load_4d(sKV + KVBYTES, &tm.v, kvfull, 0, 0, 0, bh);
          tma_load_4d(sKV + KVBYTES + NSLOT * 128, &tm.v16, kvfull, 64, 0, 0, bh);
        }
      }
    } else {  // projections, one window-head ahead of the strips
      int i = 0;
      for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++i) {
        const int b = i & 1;
        if (i >= 2) mbar_wait(&pempty[b], ((i >> 1) - 1) & 1);
        float* sRH = sP + b * pfloats;
        window_projections_ahead(q + (size_t)bh * S * 80, rh, rw, sRH, sRH + S * sth, gh, gw,
                                 sth, stw, warp - 1);
        release(&pfull[b]);
      }
    }
  } else {  // consumers
    const int c = wg - 1, g = lane >> 2, t = lane & 3;
    // each warpgroup takes strips c, c + 2, ...: nk of them, the same count for both (a
    // strip past the window's, where the count is odd, is computed and never stored), so
    // that no wgmma sits under a branch the compiler cannot prove uniform
    const int nk = (((S + 63) >> 6) + 1) >> 1;
    int i = 0;
    for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++i) {
      const int b = i & 1;
      const float* sRH = sP + b * pfloats;
      const float* sRW = sRH + S * sth;
      mbar_wait(qfull, i & 1);
      mbar_wait(&pfull[b], (i >> 1) & 1);
      mbar_wait(kvfull, i & 1);
      for (int k = 0; k < nk; ++k) {
        const int strip = c + 2 * k, r0 = strip * 64 + 16 * (warp & 3) + g, r1 = r0 + 8;
        const bool last = k == nk - 1;
        float s[NSLOT / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 5; ++kk) {
          const uint64_t a = kk < 4 ? sw128_desc(sQ + strip * 64 * 128) + kk * 2
                                    : sw32_desc(sQ + WQ * 128 + strip * 64 * 32);
          const uint64_t bk =
              kk < 4 ? sw128_desc(sKV) + kk * 2 : sw32_desc(sKV + NSLOT * 128);
          wgmma_ss<NSLOT>(s, a, bk, kk > 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        if (last) release(qempty);  // the last q.k of this window-head has read Q
        // rows past S (zero in Q, never stored) take row S - 1's projections; no branch
        // here (a register of the p.v wgmma set on a divergent path serializes its chain)
        const int q0 = min(r0, S - 1), q1 = min(r1, S - 1);
        float rw0[JG][2], rw1[JG][2];
#pragma unroll
        for (int jg = 0; jg < JG; ++jg) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * jg + 2 * t + e;
            const float v0 = sRW[q0 * stw + min(col, gw - 1)];
            const float v1 = sRW[q1 * stw + min(col, gw - 1)];
            rw0[jg][e] = col < gw ? v0 : -INFINITY;
            rw1[jg][e] = col < gw ? v1 : -INFINITY;
          }
        }
        uint32_t p[NSLOT / 16][4];
        window_softmax<NSLOT, GWP>(s, p, sRH + q0 * sth, sRH + q1 * sth, rw0, rw1, gh,
                                   scale_log2);
        if (last) release(&pempty[b]);  // this warpgroup's softmaxes have read the buffer
        float o[32], ot[8];
#pragma unroll
        for (int n = 0; n < 32; ++n) o[n] = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) ot[n] = 0.f;
        wg_fence();
        issue_pv<80, NSLOT>(o, ot, p, sKV + KVBYTES);
        wg_commit();
        wg_wait<0>();
        fence_regs(o);
        fence_regs(ot);
        if (last) release(kvempty);  // K and V of this window-head are read
        __nv_bfloat16* o0 = out + ((size_t)bh * S + r0) * 80;
        __nv_bfloat16* o1 = out + ((size_t)bh * S + r1) * 80;
        auto put = [&](int col, float x0, float x1, float x2, float x3) {
          if (r0 < S) *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(x0, x1);
          if (r1 < S) *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(x2, x3);
        };
#pragma unroll
        for (int j = 0; j < 8; ++j)
          put(8 * j + 2 * t, o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          put(64 + 8 * j + 2 * t, ot[4 * j], ot[4 * j + 1], ot[4 * j + 2], ot[4 * j + 3]);
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
constexpr size_t G_SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no link against libcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A (BH, S, D) bf16 tensor as a 3-D TMA map whose box is `cols` columns x `rows` rows of
// one batch*head, the wgmma operand layout: 64 columns 128B-swizzled, or 16 columns (the
// head-dim-80 tail panel) 32B-swizzled; reads past S are zero-filled.
int bf16_map(CUtensorMap* map, const void* ptr, int D, int S, int BH, int rows,
             int cols = 64) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return ERR_TENSOR_MAP;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

// A (BH, gh, gw, D) bf16 tensor as a 4-D TMA map whose box is `cols` columns x (rows key
// rows x gwp slots) of one batch*head, panels as bf16_map's; slots past gw and key rows past
// gh are zero-filled.
int bf16_map_4d(CUtensorMap* map, const void* ptr, int D, int gh, int gw, int BH, int rows,
                int gwp, int cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return ERR_TENSOR_MAP;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)gw, (cuuint64_t)gh, (cuuint64_t)BH};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)gw * D * 2,
                                 (cuuint64_t)gh * gw * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)gwp, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

template <typename K>
int launch_prep(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // reported here: not again by the next launch's check
      return (int)e;
    }
  }
  return 0;
}

template <int D, bool HAS_BIAS, int GW>
int launch_global(const void* q, const void* k, const void* v, const void* rph,
                  const void* rpw, void* out, int BH, int S, int gh, int gw, float scale,
                  cudaStream_t st) {
  // geometry mirrored by tmr_tpu_torch/ops/cuda_attn.py global_geometry: 128-key tiles
  // on 64-token grid rows (64-key tiles measured slower there), one 96-key tile a grid row
  // on 96-token rows (the 1536 bucket); without the bias 128 measured slower (at both head
  // dims), and the general bias path's per-column (ky, kx) does not fit the registers
  constexpr int BK = GW == 96 ? 96 : GW == 64 ? 128 : 64;
  GMaps<D> tm;
  int e;
  if ((e = bf16_map(&tm.q, q, D, S, BH, GQ)) || (e = bf16_map(&tm.k, k, D, S, BH, BK)) ||
      (e = bf16_map(&tm.v, v, D, S, BH, BK)))
    return e;
  if constexpr (GPanels<D>::TW > 0) {
    if ((e = bf16_map(&tm.q16, q, D, S, BH, GQ, 16)) ||
        (e = bf16_map(&tm.k16, k, D, S, BH, BK, 16)) ||
        (e = bf16_map(&tm.v16, v, D, S, BH, BK, 16)))
      return e;
  }
  const int sth = HAS_BIAS ? gh | 1 : 0, stw = HAS_BIAS ? gw | 1 : 0;
  const size_t smem = global_smem<D, BK, HAS_BIAS>(gh, gw);
  auto kernel = global_attn_kernel<D, BK, HAS_BIAS, GW>;
  if ((e = launch_prep(kernel, smem))) return e;
  kernel<<<dim3((S + GQ - 1) / GQ, BH), G_THREADS, smem, st>>>(
      tm, (const float*)rph, (const float*)rpw, (__nv_bfloat16*)out, S, gh, gw, sth,
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

// geometry mirrored by tmr_tpu_torch/ops/cuda_attn.py window_geometry: NSLOT slots in key
// rows of GWP, one K/V stage, one persistent CTA per SM (or per window-head, when there are
// fewer)
template <int NSLOT, int GWP>
int launch_window_wg(const void* q, const void* k, const void* v, const void* rh,
                     const void* rw, void* out, int BH, int S, int gh, int gw, float scale,
                     cudaStream_t st) {
  constexpr int ROWS = NSLOT / GWP;
  WMaps tm;
  int e;
  if ((e = bf16_map(&tm.q, q, 80, S, BH, WQ)) || (e = bf16_map(&tm.q16, q, 80, S, BH, WQ, 16)) ||
      (e = bf16_map_4d(&tm.k, k, 80, gh, gw, BH, ROWS, GWP, 64)) ||
      (e = bf16_map_4d(&tm.k16, k, 80, gh, gw, BH, ROWS, GWP, 16)) ||
      (e = bf16_map_4d(&tm.v, v, 80, gh, gw, BH, ROWS, GWP, 64)) ||
      (e = bf16_map_4d(&tm.v16, v, 80, gh, gw, BH, ROWS, GWP, 16)))
    return e;
  int dev, sms;
  cudaError_t ce;
  if ((ce = cudaGetDevice(&dev)) ||
      (ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return (int)ce;
  const size_t smem = window_wg_smem(NSLOT, S, gh, gw);
  auto kernel = window_attn_kernel_wg<NSLOT, GWP>;
  if ((e = launch_prep(kernel, smem))) return e;
  kernel<<<BH < sms ? BH : sms, G_THREADS, smem, st>>>(
      tm, (const __nv_bfloat16*)q, (const float*)rh, (const float*)rw, (__nv_bfloat16*)out,
      BH, S, gh, gw, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int global_entry(const void* q, const void* k, const void* v, const void* rph, const void* rpw,
                 void* out, int BH, int S, int gh, int gw, float scale, int has_bias,
                 cudaStream_t st) {
  if (!has_bias)
    return launch_global<D, false, 0>(q, k, v, nullptr, nullptr, out, BH, S, gh, gw, scale,
                                      st);
  if (gw == 64)
    return launch_global<D, true, 64>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, st);
  // 96-key row tiles where the projections leave them room (gh up to 129 at D = 64, 133
  // at D = 80)
  if (gw == 96 && global_smem<D, 96, true>(gh, gw) <= G_SMEM_LIMIT)
    return launch_global<D, true, 96>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, st);
  return launch_global<D, true, 0>(q, k, v, rph, rpw, out, BH, S, gh, gw, scale, st);
}

template <int D>
int window_entry(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                 void* out, int BH, int S, int gh, int gw, float scale, cudaStream_t st) {
  // head dim 80, windows up to 16x16: the wgmma kernel, key rows of 16 slots, 14 of them
  // (SAM's 14x14, and every window of up to 14 rows) or 16; pad slots fall out through -inf
  if constexpr (D == 80) {
    if (gh <= 16 && gw <= 16) {
      auto launch = gh <= 14 ? launch_window_wg<224, 16> : launch_window_wg<256, 16>;
      return launch(q, k, v, rh, rw, out, BH, S, gh, gw, scale, st);
    }
  }
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
