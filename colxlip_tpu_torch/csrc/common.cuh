// Helpers shared by the port's CUDA kernels (csrc/*.cu): element conversions
// for the two input types the kernels take (float32, bfloat16) and a warp
// reduction.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace colxlip {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and read back as float (the cast the TPU kernels apply
// before feeding a product in the input dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory one block may have on sm_90 (227 KB), above 48 KB as dynamic
// shared memory after cudaFuncSetAttribute.
constexpr size_t kMaxSharedBytes = 232448;

}  // namespace colxlip
