// The element types of the port's kernels: float32 and bfloat16, with one
// dtype code for both in every C launch function (0 = float32,
// 1 = bfloat16). A kernel loads either as float32 (bf16 values are exact
// in float32), computes in float32 and rounds once at its store.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// v rounded to T's precision and read back as float32 (exact for float32),
// as the JAX package's `astype(input dtype)` of an intermediate.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
