// Shared helpers of the port's kernels: float32 <-> storage-type
// conversion for the two dtypes the kernels take (float, bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
#define DISPATCH_DTYPE(code, T, ...)        \
  do {                                      \
    if ((code) == 0) {                      \
      using T = float;                      \
      __VA_ARGS__;                          \
    } else if ((code) == 1) {               \
      using T = __nv_bfloat16;              \
      __VA_ARGS__;                          \
    } else {                                \
      return (int)cudaErrorInvalidValue;    \
    }                                       \
  } while (0)
