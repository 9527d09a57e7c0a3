// Greedy NMS for Hopper (sm_90a): a parallel IoU bitmask, then a short block scan.
//
// Replaces tmr_tpu/ops/pallas_nms.py _nms_kernel (nms_keep_mask_pallas): boxes arrive
// sorted by descending score (the caller sorts with torch.sort, as the JAX wrapper sorts
// with XLA); box i, while still kept, suppresses every later box j with IoU(i, j) > thr.
// Areas clamp at 0 and the union at 1e-12, as in the Pallas kernel. Invalid boxes are
// never kept and never suppress.
//
// What bounds it on an H100: latency. The function needs one IoU per (kept i, later j)
// pair, a few MFLOP, and 24 bytes per box; but the greedy recurrence is N dependent
// decisions. The Pallas kernel (and tmr_nms_sequential below) walks them one box at a
// time, each step an N-wide IoU behind a barrier, on one core per image. This design
// splits the work into a parallel part and a short serial one (tmr_nms, two launches on
// the caller's stream):
//
// 1. nms_mask_kernel, the IoU bitmask. One CTA of 64 threads per (column block cb, row
//    block rb, image), 64 boxes a side; only blocks rb <= cb work (the upper triangle;
//    the others return at once). The CTA stages its 64 column boxes and their areas in
//    shared memory; thread t owns row i = 64 rb + t and writes one 64-bit word,
//    mask[b][i][cb], whose bit u is set iff j = 64 cb + u > i, j < N and IoU(i, j) > thr
//    (a pair that does not intersect skips the divide: its IoU is +0). The mask is
//    (B, N, ceil(N / 64)) words in device memory (the wrapper's workspace, 512 KB per
//    image at N = 2000, so it stays in L2), and there is no cap on N beyond the memory
//    it takes. A word is read only for a kept row, and ORed only into removed bits: so
//    a CTA whose 64 columns are all invalid returns without writing, and so does the
//    thread of an invalid row (sorted order puts the invalid boxes last, so on the
//    detector's path most of the grid is such CTAs); the words they leave are never
//    read, or only ORed into bits that are set from the start.
// 2. nms_scan_kernel, the greedy decision. One CTA of 512 threads per image keeps the
//    "removed" bits, ceil(N / 64) words in shared memory, with the invalid boxes and the
//    slots past N set from the start, and walks the boxes in scan blocks of BW = 2 words
//    (128 boxes), one __syncthreads per block: step w resolves block w. Each warp has
//    one part, and nothing on the serial path waits on L2:
//    - warp 0 resolves block w from shared memory and registers alone. The block's
//      greedy answer is the one fixed point of kept = alive & ~OR(the block's words of
//      the kept rows); from kept = alive each warp-wide pass (lane l holds rows l + 32 m,
//      m < 4; two __reduce_or_sync a word, all issued together) settles at least one
//      more box, and a pass that changes nothing is done. A chain deeper than
//      FIXPOINT_PASSES passes falls back to 128 bit steps, box by box. The warp then ORs
//      the kept rows' words at block w + 1 into registers, which it adds to that block's
//      removed words in the next step, and publishes the kept rows.
//    - warp 1 writes block w - 1's keep flags and ORs its kept rows' words at blocks
//      w + 1 and w + 2 into removed.
//    - warps 2-3 bring block w + DEPTH's rows (their words at it and the next three
//      blocks; 0 left of a row's own word, which the mask kernel never writes) into a
//      ring with cp.async, DEPTH steps before they are read.
//    - warps 4-15 OR into removed the words they loaded two steps before (block w - 3's
//      kept rows at blocks w + 1 on), and load those of block w - 1 (blocks w + 3 on), a
//      column a worker and HELD of its rows, in one of two sets of registers (even and
//      odd steps); rows past those (N past ~2000) are loaded and ORed at once. A worker
//      ORs its rows' words first and then, if that is not 0, into removed with atomics.
//    So block k reaches block k + 1 through warp 0, k + 2 and k + 3 through warp 1, and
//    the rest through the workers, each by the step before that block is resolved.
//
// Every IoU is computed with explicitly rounded intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn), so nvcc cannot contract a*b - c into an FMA or approximate the
// divide: every decision then rounds exactly as the plain version does, and the keep
// masks agree bit for bit, ties at the threshold included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int BLK = 64;             // boxes a side of a mask block: one 64-bit word
constexpr int SCAN_THREADS = 512;   // warp 0 resolves, 1 finishes, 2-3 copy, 4-15 OR
constexpr int SCAN_WORKERS = SCAN_THREADS - 128;
constexpr int BW = 2;               // words of a scan block: a step resolves 64 BW boxes
constexpr int SB = BW * BLK;        // boxes of a scan block
constexpr int RPL = SB / 32;        // rows of a scan block a lane holds (warps 0 and 1)
constexpr int DEPTH = 2;            // a ring copy issued in step s is read from step s + DEPTH
constexpr int ROW_WORDS = 4 * BW;   // words of each row in the ring: its block's, the next 3
constexpr int RING = DEPTH + 2;     // blocks in the ring: w - 1 .. w + DEPTH
constexpr int HELD = 5 * BW;        // words a worker holds across two barriers
constexpr int FIXPOINT_PASSES = 8;  // warp-parallel passes before box by box
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// IoU of box a (area aa) with box b (area ab), rounded as the plain version rounds it.
// SKIP_DISJOINT: a pair that does not intersect returns +0 without the divide, which is
// what the divide gives (0 / union, union >= 1e-12), and costs it nothing
template <bool SKIP_DISJOINT>
__device__ __forceinline__ float iou_of(float4 a, float aa, float4 b, float ab) {
  const float iw = fmaxf(__fsub_rn(fminf(b.z, a.z), fmaxf(b.x, a.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(b.w, a.w), fmaxf(b.y, a.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  if (SKIP_DISJOINT && inter == 0.f) return 0.f;
  const float uni = __fsub_rn(__fadd_rn(ab, aa), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f));
}

__global__ void __launch_bounds__(BLK)
    nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                    u64* __restrict__ mask, int N, int W, float thr) {
  __shared__ float4 sB[BLK];
  __shared__ float sA[BLK];
  // column block cb against row block rb, at or above the diagonal only
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (rb > cb) return;
  const int t = threadIdx.x, i = rb * BLK + t, j = cb * BLK + t;
  const float4* bp = reinterpret_cast<const float4*>(boxes) + (size_t)blockIdx.z * N;
  const uint8_t* vp = valid + (size_t)blockIdx.z * N;
  int col_ok = 0;
  if (j < N) {
    const float4 bj = bp[j];
    sB[t] = bj;
    sA[t] = area_of(bj);
    col_ok = vp[j] != 0;
  }
  const bool row_ok = i < N && vp[i] != 0;
  const float4 bi = row_ok ? bp[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  // the barrier stages sB/sA; a CTA whose columns are all invalid writes nothing
  if (!__syncthreads_or(col_ok) || !row_ok) return;
  const float ai = area_of(bi);
  const int ncol = min(BLK, N - cb * BLK);
  u64 word = 0;
  for (int u = (cb == rb) ? t + 1 : 0; u < ncol; ++u)  // j > i
    if (iou_of<true>(bi, ai, sB[u], sA[u]) > thr) word |= 1ull << u;
  mask[((size_t)blockIdx.z * N + i) * W + cb] = word;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// the keep flags of scan block k's boxes from its kept bits, RPL a lane
__device__ __forceinline__ void store_keep(uint8_t* kp, int k, const u64 (&kept)[BW], int lane,
                                           int N) {
#pragma unroll
  for (int m = 0; m < RPL; ++m) {
    const int j = k * SB + lane + 32 * m;
    if (j < N) kp[j] = (uint8_t)((kept[m / 2] >> (lane + 32 * (m % 2))) & 1ull);
  }
}

// removed[c] |= v for a word others may OR into in the same step (a half that is 0 costs
// no atomic)
__device__ __forceinline__ void or_word(u64* word, u64 v) {
  unsigned* half = reinterpret_cast<unsigned*>(word);
  if ((unsigned)v) atomicOr(half, (unsigned)v);
  if ((unsigned)(v >> 32)) atomicOr(half + 1, (unsigned)(v >> 32));
}

// warps 0 and 1 hold a block's rows l + 32 m (m < RPL) in lane l; the bits of those rows
// in a block's bit words (BW of them, bit s of the block in word s / 64)
__device__ __forceinline__ unsigned rows_bits(const u64 (&bits)[BW], int m) {
  return (unsigned)(bits[m / 2] >> (32 * (m % 2)));
}

// the OR over the warp of word k of the rows set in rows, word m k of a lane's row m
template <int K>
__device__ __forceinline__ void warp_or_rows(const u64 (&rows)[BW], const u64 (&words)[RPL][K],
                                             unsigned lb, u64 (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    u64 c = 0;
#pragma unroll
    for (int m = 0; m < RPL; ++m)
      if (rows_bits(rows, m) & lb) c |= words[m][k];
    const unsigned lo = __reduce_or_sync(FULL, (unsigned)c);
    const unsigned hi = __reduce_or_sync(FULL, (unsigned)(c >> 32));
    out[k] = ((u64)hi << 32) | lo;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
    nms_scan_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int N, int W) {
  extern __shared__ u64 removed[];                      // the scan blocks' words
  __shared__ u64 ring[RING][ROW_WORDS][SB];             // block b's rows: words BW b on
  __shared__ u64 kword[2][BW];                          // block k's kept rows, as bits
  __shared__ int klist[2][SB];                          // and in order
  __shared__ int kcount[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lb = 1u << lane;
  const int NB = (W + BW - 1) / BW;  // scan blocks
  const u64* mp = mask + (size_t)blockIdx.x * N * W;
  const uint8_t* vp = valid + (size_t)blockIdx.x * N;
  uint8_t* kp = keep + (size_t)blockIdx.x * N;

  for (int c = warp; c < NB * BW; c += SCAN_THREADS / 32) {  // invalid, past N: removed
    const int j0 = c * BLK + lane, j1 = j0 + 32;
    const unsigned lo = __ballot_sync(FULL, j0 < N && vp[j0] != 0);
    const unsigned hi = __ballot_sync(FULL, j1 < N && vp[j1] != 0);
    if (lane == 0) removed[c] = ~(((u64)hi << 32) | lo);
  }
  // word j of row s of block b (the column word BW b + j); 0 past N, past the last word
  // and left of the row's own word, which the mask kernel never writes
  auto ring_word = [&](int b, int j, int s, bool& ok) {
    const int row = b * SB + s, col = b * BW + j;
    ok = row < N && col < W && j >= s / BLK;
    return mp + (ok ? (size_t)row * W + col : 0);
  };
  for (int e = tid; e < DEPTH * ROW_WORDS * SB; e += SCAN_THREADS) {  // blocks 0 .. DEPTH-1
    const int b = e / (ROW_WORDS * SB), j = (e / SB) % ROW_WORDS, sr = e % SB;
    bool ok;
    const u64* src = ring_word(b, j, sr, ok);
    ring[b][j][sr] = ok ? *src : 0ull;
  }
  __syncthreads();

  u64 next[BW];  // warp 0: block w - 1's kept rows' words at block w
#pragma unroll
  for (int k = 0; k < BW; ++k) next[k] = 0;
  // one step: block w resolved; the workers OR the words they loaded two steps before
  // (into held), then load block w - 1's into it
  auto step = [&](int w, u64(&held)[HELD], int& held_col) {
    if (warp == 0) {
      // block w: every contribution to its removed words is in (blocks <= w - 4 through
      // the workers, blocks w - 3 and w - 2 through warp 1, in removed; block w - 1 in
      // next)
      u64(*words)[SB] = ring[w % RING];
      u64 r[BW], alive[BW], kept[BW], any = 0;
#pragma unroll
      for (int k = 0; k < BW; ++k) {
        r[k] = removed[w * BW + k] | next[k];
        alive[k] = ~r[k];
        kept[k] = 0;
        any |= alive[k];
      }
      if (any) {
        // greedy over the block as a fixed point: kept = alive & ~OR(kept rows' block
        // words); from kept = alive, each pass settles at least one more box, and a pass
        // that changes nothing has reached the one fixed point, the greedy answer
        u64 d[RPL][BW];
#pragma unroll
        for (int m = 0; m < RPL; ++m)
#pragma unroll
          for (int k = 0; k < BW; ++k) d[m][k] = words[k][lane + 32 * m];
#pragma unroll
        for (int k = 0; k < BW; ++k) kept[k] = alive[k];
        bool settled = false;
        for (int it = 0; it < FIXPOINT_PASSES && !settled; ++it) {
          u64 sup[BW];
          warp_or_rows<BW>(kept, d, lb, sup);
          settled = true;
#pragma unroll
          for (int k = 0; k < BW; ++k) {
            const u64 nx = alive[k] & ~sup[k];
            settled &= nx == kept[k];
            kept[k] = nx;
          }
        }
        if (!settled) {  // a chain deeper than the passes: box by box
#pragma unroll
          for (int k = 0; k < BW; ++k) kept[k] = 0;
#pragma unroll
          for (int k = 0; k < BW; ++k) {
#pragma unroll 8
            for (int t = 0; t < BLK; ++t) {
              const u64 m = (r[k] & (1ull << t)) ? 0ull : ~0ull;
              kept[k] |= m & (1ull << t);
#pragma unroll
              for (int k2 = 0; k2 < BW; ++k2) r[k2] |= m & words[k2][k * BLK + t];
            }
          }
        }
      }
      // the kept rows' words at block w + 1
      u64 nw[RPL][BW];
#pragma unroll
      for (int m = 0; m < RPL; ++m)
#pragma unroll
        for (int k = 0; k < BW; ++k) nw[m][k] = words[BW + k][lane + 32 * m];
      warp_or_rows<BW>(kept, nw, lb, next);
      // publish the kept rows, in order
      int base = 0;
#pragma unroll
      for (int m = 0; m < RPL; ++m) {
        const unsigned bits = rows_bits(kept, m);
        if (bits & lb) klist[w & 1][base + __popc(bits & (lb - 1u))] = lane + 32 * m;
        base += __popc(bits);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < BW; ++k) kword[w & 1][k] = kept[k];
        kcount[w & 1] = base;
      }
    } else if (warp == 1) {
      // block w - 1: its keep flags, and its kept rows' words at blocks w + 1 and w + 2
      if (w >= 1) {
        u64 kept[BW];
#pragma unroll
        for (int k = 0; k < BW; ++k) kept[k] = kword[(w - 1) & 1][k];
        store_keep(kp, w - 1, kept, lane, N);
        u64(*words)[SB] = ring[(w - 1) % RING];
        u64 fw[RPL][2 * BW], v[2 * BW];
#pragma unroll
        for (int m = 0; m < RPL; ++m)
#pragma unroll
          for (int k = 0; k < 2 * BW; ++k) fw[m][k] = words[2 * BW + k][lane + 32 * m];
        warp_or_rows<2 * BW>(kept, fw, lb, v);
#pragma unroll
        for (int k = 0; k < 2 * BW; ++k) {
          const int c = (w + 1) * BW + k;
          if (lane == 0 && c < W) or_word(&removed[c], v[k]);
        }
      }
    } else if (warp < 4) {
      // block w + DEPTH's rows into the ring (read from step w + DEPTH)
      const int b = w + DEPTH;
      if (b < NB) {
        for (int e = tid - 64; e < ROW_WORDS * SB; e += 64) {
          const int j = e % ROW_WORDS, sr = e / ROW_WORDS;
          bool ok;
          const u64* src = ring_word(b, j, sr, ok);
          cp_async8(&ring[b % RING][j][sr], src, ok);
        }
      }
      cp_async_commit();
      cp_async_wait<DEPTH - 1>();
    } else {
      const int wt = tid - 128;
      // the words loaded two steps before (block w - 3's kept rows at one column)
      u64 v = 0;
#pragma unroll
      for (int u = 0; u < HELD; ++u) v |= held[u];
      if (v) or_word(&removed[held_col], v);
      // block w - 1's kept rows at the words of blocks w + 3 on: a worker takes one
      // column, c0 + wt % nc, and the kept rows q = wt / nc, + per, + 2 per, ...; HELD of
      // them loaded now and ORed two steps later, the rest loaded and ORed now
      const int c0 = (w + 3) * BW, nc = W - c0;
      const int nk = (w >= 1 && nc > 0) ? kcount[(w - 1) & 1] : 0;
#pragma unroll
      for (int u = 0; u < HELD; ++u) held[u] = 0;
      if (nk) {
        const int* list = klist[(w - 1) & 1];
        const size_t row0 = (size_t)(w - 1) * SB;
        const int per = SCAN_WORKERS / nc;  // workers per column (0: columns in turn)
        if (per) {
          const int q0 = wt / nc, c = c0 + (wt - q0 * nc);
          held_col = c;
          if (q0 < per) {
#pragma unroll
            for (int u = 0; u < HELD; ++u) {
              const int q = q0 + u * per;
              if (q < nk) held[u] = mp[(row0 + list[q]) * W + c];
            }
            u64 rest = 0;
            for (int q = q0 + HELD * per; q < nk; q += per)
              rest |= mp[(row0 + list[q]) * W + c];
            if (rest) or_word(&removed[c], rest);
          }
        } else {
          for (int c = c0 + wt; c < W; c += SCAN_WORKERS) {
            u64 rest = 0;
            for (int q = 0; q < nk; ++q) rest |= mp[(row0 + list[q]) * W + c];
            if (rest) or_word(&removed[c], rest);
          }
        }
      }
    }
    __syncthreads();
  };
  // two sets of held words, for the even and the odd steps
  u64 held0[HELD], held1[HELD];
  int col0 = 0, col1 = 0;
#pragma unroll
  for (int u = 0; u < HELD; ++u) held0[u] = held1[u] = 0;
  for (int w = 0; w < NB; w += 2) {
    step(w, held0, col0);
    if (w + 1 < NB) step(w + 1, held1, col1);
  }
  if (warp == 1) {
    u64 kept[BW];
#pragma unroll
    for (int k = 0; k < BW; ++k) kept[k] = kword[(NB - 1) & 1][k];
    store_keep(kp, NB - 1, kept, lane, N);
  }
  cp_async_wait<0>();
}

// The sequential kernel this design replaced: one CTA per image walks the boxes in
// order, one __syncthreads per box, every box in shared memory (so N <= ~9600). Kept as
// a yardstick; the port never calls it.
__global__ void __launch_bounds__(1024)
    nms_sequential_kernel(const float* __restrict__ boxes, const int32_t* __restrict__ valid,
                          int32_t* __restrict__ keep, int N, float thr) {
  extern __shared__ float smem[];
  float4* sB = reinterpret_cast<float4*>(smem);          // N boxes
  float* sA = smem + 4 * N;                              // N areas
  int32_t* sK = reinterpret_cast<int32_t*>(sA + N);      // N keep flags
  const float4* bp = reinterpret_cast<const float4*>(boxes) + (size_t)blockIdx.x * N;
  const int32_t* vp = valid + (size_t)blockIdx.x * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float4 b = bp[j];
    sB[j] = b;
    sA[j] = area_of(b);
    sK[j] = vp[j];
  }
  for (int i = 0; i < N; ++i) {
    __syncthreads();
    if (sK[i] == 0) continue;  // uniform: nobody writes sK[i] during step i
    const float4 bi = sB[i];
    const float ai = sA[i];
    for (int j = i + 1 + threadIdx.x; j < N; j += blockDim.x)
      if (iou_of<false>(bi, ai, sB[j], sA[j]) > thr) sK[j] = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += blockDim.x) keep[(size_t)blockIdx.x * N + j] = sK[j];
}

}  // namespace

extern "C" {

// boxes (B, N, 4) f32 xyxy sorted by descending score, valid (B, N) bool (one byte),
// keep (B, N) bool out, mask (B, N, ceil(N / 64)) 64-bit words of workspace (no initial
// contents), all contiguous. Two launches on the stream. Returns the CUDA error code (0 =
// launched); refuses B or N out of the grid's range and null pointers.
int tmr_nms(const void* boxes, const void* valid, void* keep, void* mask, int B, int N,
            float thr, void* stream) {
  if (B < 0 || N < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  if (!boxes || !valid || !keep || !mask) return (int)cudaErrorInvalidValue;
  const int W = (N + BLK - 1) / BLK;
  if (W > 65535) return (int)cudaErrorInvalidValue;  // the grid's y
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(W, W, B), BLK, 0, s>>>(
      (const float*)boxes, (const uint8_t*)valid, (u64*)mask, N, W, thr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)((W + BW - 1) / BW) * BW * sizeof(u64);  // removed
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_scan_kernel<<<B, SCAN_THREADS, smem, s>>>((const u64*)mask, (const uint8_t*)valid,
                                                (uint8_t*)keep, N, W);
  return (int)cudaGetLastError();
}

// the sequential yardstick, as the port called it before: valid and keep int32, no mask;
// N <= ~9600 (shared memory)
int tmr_nms_sequential(const void* boxes, const void* valid, void* keep, int B, int N,
                       float thr, void* stream) {
  if (B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)N * (4 + 1 + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(nms_sequential_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_sequential_kernel<<<B, 1024, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)boxes, (const int32_t*)valid, (int32_t*)keep, N, thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
