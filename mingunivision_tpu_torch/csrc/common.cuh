// Shared helpers for the hand-written Hopper kernels of mingunivision_tpu_torch.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() so that a
// refused launch (too many threads, too much shared memory) is reported to the
// Python wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ float silu_f32(float v) { return v / (1.0f + __expf(-v)); }

__host__ __device__ __forceinline__ size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
static inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
