// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel accumulates in float32 and converts at its edges with the
// CUDA intrinsics, so the rounding of each conversion is explicit:
// float -> bfloat16 rounds to nearest even, as torch and XLA do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes shared with repro_torch/kernels/ops.py
enum DTypeCode { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// f(e) for this thread's share e = tid, tid + NT, .. of 0 .. COUNT - 1 (of
// NT threads), the trip count known at compile time.
template <int NT, int COUNT, typename F>
__device__ __forceinline__ void for_share(int tid, F&& f) {
#pragma unroll
  for (int e0 = 0; e0 < COUNT; e0 += NT) {
    const int e = e0 + tid;
    if (COUNT % NT == 0 || e < COUNT) f(e);
  }
}

// 16 bytes global -> shared by cp.async; `bytes` 16 copies, 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Until at most N of this thread's committed cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch (sm_90): let the next kernel of the stream
// start (launch_dependents), or wait until the kernel before is complete
// and its writes are visible (wait; at once when launched without the
// attribute).
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// Launch `kernel` on `stream` as the programmatic dependent of the kernel
// launched before it there.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
