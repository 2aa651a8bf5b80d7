// float32 / bfloat16 loads and stores for kernels that compute in float32
// and keep their inputs and outputs in the caller's type.
#pragma once

#include <cuda_bf16.h>

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T store_f(float v);
template <>
__device__ __forceinline__ float store_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
