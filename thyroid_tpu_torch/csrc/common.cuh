// Helpers shared by the kernels of thyroid_tpu_torch/csrc.
//
// Every kernel file exports a plain C interface: pointers and the stream
// arrive as void*, element types are chosen by an `is_bf16` flag, and every
// entry returns the cudaError_t of its launch (cudaGetLastError), which the
// Python wrapper raises on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TT_EXPORT extern "C" __attribute__((visibility("default")))

// Element load/store in the tensor's own type, arithmetic in float.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to the compute type T and back: the rounding the JAX
// kernels apply where they cast an intermediate to the model dtype.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

TT_EXPORT const char* tt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
