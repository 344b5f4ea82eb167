// Shared helpers for the port's CUDA kernels (built for sm_90a by
// ops/_build.py, bound to Python with ctypes).
//
// Every entry point has a plain C signature: tensors arrive as raw device
// pointers, the stream as a pointer-sized handle, and the return value is
// the cudaError_t of the launch (checked with cudaGetLastError() right after
// it), which the Python wrapper turns into an exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VIT_EXPORT extern "C" __attribute__((visibility("default")))

namespace vit {

typedef __nv_bfloat16 bf16;

// dtype codes shared with the Python wrappers (ops/_build.DTYPE_CODES).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two floats rounded to bf16 (round to nearest even, as XLA's convert) in one
// 32-bit word; `lo` lands in the low half, the element with the lower index.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Opt a kernel into more than 48 KB of dynamic shared memory (Hopper allows
// up to 227 KB per block).
template <typename Kernel>
__host__ inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace vit
