// Shared by every kernel source: the exported C interface and the scalar
// activations the JAX reference uses (jax.nn.gelu's tanh form, logistic).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Each .cu builds into its own shared library, so this definition appears once
// per library.
REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // 0.5 * x * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x^3)))
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// max / min that propagate NaN, as jnp.maximum / jnp.minimum and
// torch.maximum / clamp do (fmaxf and fminf return the operand that is not
// NaN).  PTX max.NaN / min.NaN (sm_80+); on numbers they equal fmaxf / fminf.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
