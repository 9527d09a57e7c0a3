// Sequential greedy NMS for Hopper (sm_90a).
//
// Replaces tmr_tpu/ops/pallas_nms.py _nms_kernel (nms_keep_mask_pallas): boxes arrive
// sorted by descending score (the caller sorts with torch.sort, as the JAX wrapper sorts
// with XLA); box i, while still kept, suppresses every later box j with IoU(i, j) > thr.
// Areas clamp at 0 and the union at 1e-12, as in the Pallas kernel.
//
// What bounds it on an H100: latency, not bytes or flops (2000 boxes = 32 KB per image):
// the greedy recurrence is 2000 dependent steps. Design: one CTA per image holds its boxes
// and keep flags in shared memory and walks the boxes in order, one __syncthreads per step;
// the 1024 threads evaluate the IoU of box i against all later boxes at once. The IoU is
// computed with explicitly rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn)
// so nvcc cannot contract a*b - c into an FMA: every decision then rounds exactly as the
// CPU version does, and the keep masks agree bit for bit, ties at the threshold included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float area_of(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
}

__global__ void __launch_bounds__(1024)
    nms_kernel(const float* __restrict__ boxes, const int32_t* __restrict__ valid,
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
    sA[j] = area_of(b.x, b.y, b.z, b.w);
    sK[j] = vp[j];
  }
  for (int i = 0; i < N; ++i) {
    __syncthreads();
    if (sK[i] == 0) continue;  // uniform: nobody writes sK[i] during step i
    const float4 bi = sB[i];
    const float ai = sA[i];
    for (int j = i + 1 + threadIdx.x; j < N; j += blockDim.x) {
      const float4 bj = sB[j];
      const float iw = fmaxf(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(sA[j], ai), inter);
      const float iou = __fdiv_rn(inter, fmaxf(uni, 1e-12f));
      if (iou > thr) sK[j] = 0;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += blockDim.x) keep[(size_t)blockIdx.x * N + j] = sK[j];
}

}  // namespace

extern "C" {

// boxes (B, N, 4) f32 xyxy sorted by descending score, valid (B, N) int32, keep (B, N) int32
// out, all contiguous. One CTA per image. Returns the CUDA error code (0 = launched).
int tmr_nms(const void* boxes, const void* valid, void* keep, int B, int N, float thr,
            void* stream) {
  const size_t smem = (size_t)N * (4 + 1 + 1) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(nms_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_kernel<<<B, 1024, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)boxes, (const int32_t*)valid, (int32_t*)keep, N, thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
