// SAME-padded depthwise cross-correlation for Hopper (sm_90a), f32.
//
// Replaces tmr_tpu/ops/pallas_xcorr.py _xcorr_kernel (xcorr_pallas): for every (image,
// channel) plane, out[y, x] = sum_{i,j < T} f[y + i - c, x + j - c] * t[i, j] with zero
// padding, c = T // 2, no kernel flip (correlation, not convolution).
//
// What bounds it on an H100: 2*T^2 flops per output on CUDA cores with no reduction over
// channels to feed a tensor core (73 GFLOP f32 at T = 33 on the 4 x 512 x 128^2 matcher map:
// about 1.1 ms at the 67 TFLOP/s f32 peak); the bytes are only the map in and out. Design:
// one CTA of 256 threads per (plane, 32x32 output tile); the tile's input with its T-1 halo
// and the plane's T x T template sit in shared memory, each thread accumulates 4 outputs in
// f32 registers (rows ty, ty+8, ty+16, ty+24 of its column), so every template tap is one
// broadcast read reused four times. T is a runtime argument (odd, <= 65), not an unroll.
// Not yet: register blocking along x, tensor-core im2col (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;

__global__ void __launch_bounds__(256)
    xcorr_kernel(const float* __restrict__ f, const float* __restrict__ tmpl,
                 float* __restrict__ out, int H, int W, int T, int tiles_x) {
  extern __shared__ float smem[];
  const int FS = TILE + T - 1;  // staged input tile edge
  float* sF = smem;             // FS x FS
  float* sT = smem + FS * FS;   // T x T
  const int plane = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TILE, tx0 = (blockIdx.x % tiles_x) * TILE;
  const int c = T / 2;
  const float* fp = f + (size_t)plane * H * W;
  const float* tp = tmpl + (size_t)plane * T * T;
  for (int i = threadIdx.x; i < FS * FS; i += blockDim.x) {
    const int r = i / FS, cc = i - r * FS;
    const int y = ty0 - c + r, x = tx0 - c + cc;
    sF[i] = (y >= 0 && y < H && x >= 0 && x < W) ? fp[(size_t)y * W + x] : 0.f;
  }
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) sT[i] = tp[i];
  __syncthreads();
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < T; ++i) {
    const float* row = sF + (ty + i) * FS + tx;
    const float* trow = sT + i * T;
    for (int j = 0; j < T; ++j) {
      const float w = trow[j];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] += row[r * 8 * FS + j] * w;
    }
  }
  float* op = out + (size_t)plane * H * W;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int y = ty0 + ty + r * 8, x = tx0 + tx;
    if (y < H && x < W) op[(size_t)y * W + x] = acc[r];
  }
}

}  // namespace

extern "C" {

// feature (planes, H, W) f32, template (planes, T, T) f32, out (planes, H, W) f32; all
// contiguous, T odd. Returns the CUDA error code (0 = launched).
int tmr_xcorr(const void* feature, const void* tmpl, void* out, int planes, int H, int W,
              int T, void* stream) {
  const int FS = TILE + T - 1;
  const size_t smem = (size_t)(FS * FS + T * T) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(xcorr_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, planes);
  xcorr_kernel<<<grid, 256, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)feature, (const float*)tmpl, (float*)out, H, W, T, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
