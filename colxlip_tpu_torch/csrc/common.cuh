// Helpers shared by the port's CUDA kernels (csrc/*.cu): element conversions
// for the two input types the kernels take (float32, bfloat16) and warp
// reductions.
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared-memory row stride, in elements, for rows of D values read by 32
// lanes at 32 different rows and the same column: an odd number of 32-bit
// words puts the 32 reads on 32 banks.
template <typename T, int D>
__host__ __device__ constexpr int odd_word_stride() { return sizeof(T) == 2 ? D + 2 : D + 1; }

}  // namespace colxlip
