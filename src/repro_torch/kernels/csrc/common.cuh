// Shared helpers for the hand-written Hopper kernels: dtype conversion,
// warp reductions and the dtype dispatch of the C launch functions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

// Finite "minus infinity" of the TPU kernels: a fully masked tile keeps
// exp(m_prev - m_new) == 1 instead of producing inf - inf.
#define RAP_NEG_INF (-2.0e38f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// dtype codes shared with repro_torch/kernels/build.py
#define RAP_DISPATCH(code, T, ...)                     \
  switch (code) {                                      \
    case 0: { using T = float; __VA_ARGS__; break; }   \
    case 1: { using T = __nv_bfloat16; __VA_ARGS__; break; } \
    case 2: { using T = __half; __VA_ARGS__; break; }  \
    default: return (int)cudaErrorInvalidValue;        \
  }
