// SAME-padded depthwise cross-correlation for Hopper (sm_90a): f32, and int8 with an
// exact int32 sum.
//
// Replaces tmr_tpu/ops/pallas_xcorr.py _xcorr_kernel (xcorr_pallas): for every (image,
// channel) plane, out[y, x] = sum_{i,j < T} f[y + i - c, x + j - c] * t[i, j] with zero
// padding, c = T // 2, no kernel flip (correlation, not convolution). The int8 variant
// replaces the XLA integer grouped convolution of tmr_tpu/ops/xcorr.py _xcorr_int8dot:
// int8 feature and template, the sum exact in int32, then out = float(acc) * (fs * ts)
// with one f32 scale of each per plane.
//
// What bounds it on an H100: 2*T^2 operations per output on CUDA cores with no reduction
// over channels to feed a tensor core (73 GFLOP f32 at T = 33 on the 4 x 512 x 128^2
// matcher map: about 1.1 ms at the 67 TFLOP/s f32 peak). The int8 variant runs one int32
// IMAD per product, whose rate is half the f32 FMA rate, but its work is int8 products:
// at the 1979 TOP/s int8 peak it is bound by its bytes (the int8 map in, the f32 map
// out: about 0.05 ms at 3.35 TB/s), far below what CUDA-core IMADs can reach. The bytes
// are only the map in and out. Design: one CTA of 256
// threads per (plane, 32x32 output tile); the tile's input with its T-1 halo and the
// plane's T x T template sit in shared memory, each thread accumulates 4 outputs in
// registers (rows ty, ty+8, ty+16, ty+24 of its column), so every template tap is one
// broadcast read reused four times. T is a runtime argument (odd, <= 65), not an unroll.
// Not yet: register blocking along x, dp4a or tensor-core im2col (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;

__device__ __forceinline__ float finish(float acc, const float*, const float*, int) {
  return acc;
}

__device__ __forceinline__ float finish(int acc, const float* fs, const float* ts,
                                        int plane) {
  return __fmul_rn(__int2float_rn(acc), __fmul_rn(fs[plane], ts[plane]));
}

template <typename Elem, typename Acc>
__global__ void __launch_bounds__(256)
    xcorr_kernel(const Elem* __restrict__ f, const Elem* __restrict__ tmpl,
                 const float* __restrict__ fs, const float* __restrict__ ts,
                 float* __restrict__ out, int H, int W, int T, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int FS = TILE + T - 1;                   // staged input tile edge
  Elem* sF = reinterpret_cast<Elem*>(smem_raw);  // FS x FS
  Elem* sT = sF + FS * FS;                       // T x T
  const int plane = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TILE, tx0 = (blockIdx.x % tiles_x) * TILE;
  const int c = T / 2;
  const Elem* fp = f + (size_t)plane * H * W;
  const Elem* tp = tmpl + (size_t)plane * T * T;
  for (int i = threadIdx.x; i < FS * FS; i += blockDim.x) {
    const int r = i / FS, cc = i - r * FS;
    const int y = ty0 - c + r, x = tx0 - c + cc;
    sF[i] = (y >= 0 && y < H && x >= 0 && x < W) ? fp[(size_t)y * W + x] : Elem(0);
  }
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) sT[i] = tp[i];
  __syncthreads();
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  Acc acc[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
  for (int i = 0; i < T; ++i) {
    const Elem* row = sF + (ty + i) * FS + tx;
    const Elem* trow = sT + i * T;
    for (int j = 0; j < T; ++j) {
      const Acc w = trow[j];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] += Acc(row[r * 8 * FS + j]) * w;
    }
  }
  float* op = out + (size_t)plane * H * W;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int y = ty0 + ty + r * 8, x = tx0 + tx;
    if (y < H && x < W) op[(size_t)y * W + x] = finish(acc[r], fs, ts, plane);
  }
}

template <typename Elem, typename Acc>
int launch(const void* feature, const void* tmpl, const void* fs, const void* ts,
           void* out, int planes, int H, int W, int T, void* stream) {
  const int FS = TILE + T - 1;
  const size_t smem = (size_t)(FS * FS + T * T) * sizeof(Elem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(xcorr_kernel<Elem, Acc>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, planes);
  xcorr_kernel<Elem, Acc><<<grid, 256, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const Elem*)feature, (const Elem*)tmpl, (const float*)fs, (const float*)ts,
      (float*)out, H, W, T, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// feature (planes, H, W) f32, template (planes, T, T) f32, out (planes, H, W) f32; all
// contiguous, T odd. Returns the CUDA error code (0 = launched).
int tmr_xcorr(const void* feature, const void* tmpl, void* out, int planes, int H, int W,
              int T, void* stream) {
  return launch<float, float>(feature, tmpl, nullptr, nullptr, out, planes, H, W, T,
                              stream);
}

// feature (planes, H, W) int8, template (planes, T, T) int8, fs and ts (planes,) f32,
// out (planes, H, W) f32; all contiguous, T odd.
int tmr_xcorr_int8(const void* feature, const void* tmpl, const void* fs, const void* ts,
                   void* out, int planes, int H, int W, int T, void* stream) {
  return launch<int8_t, int>(feature, tmpl, fs, ts, out, planes, H, W, T, stream);
}

}  // extern "C"
