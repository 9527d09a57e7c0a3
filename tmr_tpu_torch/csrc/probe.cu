// Toolchain probe for Hopper (sm_90a): out = x + 1 on f32.
//
// Replaces scripts/gate_probe.py add1 (a trivial Pallas kernel that asked whether Mosaic
// lowers at all). Here it asks whether nvcc builds for sm_90a, ctypes binds the library
// and a kernel launches on PyTorch's stream: chip_smoke.py runs it before any other
// kernel. Bound by bytes (one read, one write per element); one thread per element.

#include <cuda_runtime.h>

namespace {

__global__ void add1_kernel(const float* __restrict__ x, float* __restrict__ out,
                            long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// x, out: n contiguous f32. Returns the CUDA error code (0 = launched).
int tmr_add1(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  add1_kernel<<<(unsigned)blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
