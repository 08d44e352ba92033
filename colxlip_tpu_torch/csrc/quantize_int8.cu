// Stochastic-rounding int8 quantization of a [K, N] weight, one scale a
// column, for Hopper (sm_90a).
//
// Replaces: colxlip_tpu/ops/quantization.py `quantize_int8_pallas` (:52, body
// `_quant_kernel` :34). Same arithmetic, in fp32 whatever the input type:
//
//   scale[j]     = max(max_i |w[i, j]| / 127, 1e-8)
//   values[i, j] = clip(floor(w[i, j] / scale[j] + u[i, j]), -127, 127)
//   u[i, j]      = (bits >> 8) * 2^-24, uniform in [0, 1) from 24 random bits
//
// The TPU kernel draws its bits from the core's own generator, seeded with
// the seed plus the column block. Here the bits come from Philox4x32-10,
// written out below: key = the 64-bit seed, counter = (row, column / 4, 0, 0),
// and element (i, j) takes word j % 4 of that counter's four. So the noise of
// an element depends on the seed and its position alone, never on the grid,
// the block size or the width of the matrix, no two column blocks repeat a
// pattern, and ops/quantization.py `quantize_int8_plain` computes the same
// words with integer tensor arithmetic: the two are equal bit for bit. To keep
// them so, both divisions are IEEE divisions (__fdiv_rn, never a multiply by
// a reciprocal) and the add before the floor is one rounded add (__fadd_rn),
// which the compiler may not contract with anything.
//
// Two kernels behind one entry point: the column absmax (blocks tile rows as
// well as columns, so a tall narrow matrix still fills the card; partial
// maxima meet in an atomicMax on the bit pattern, which orders non-negative
// floats, so the result does not depend on the order), then the elementwise
// pass. A thread owns four neighbouring columns: one Philox call serves its
// four elements, and when N is a multiple of 4 and the pointers are aligned
// it loads them as one 16-byte (fp32) or 8-byte (bf16) word and stores four
// int8 as one 32-bit word. N is never padded.
//
// What bounds it on the H100: bytes. It must read K N elements and write K N
// bytes and N scales (at 768 x 3072 fp32: 11.8 MB, 3.5 us at 3.35 TB/s); the
// weight is read twice, the second time mostly from the 50 MB L2. The Philox
// rounds are about 70 integer operations for four elements.

#include "common.cuh"

#include <stdint.h>

namespace {

using colxlip::to_f;

constexpr int kGroupsX = 32;        // threads along the columns, 4 columns each
constexpr int kLanesY = 8;          // threads along the rows
constexpr int kRowsPerBlock = 64;   // rows a block walks, kLanesY at a time
constexpr int kColsPerBlock = 4 * kGroupsX;

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011): ten rounds on the counter (c0, c1, c2, c3) under the key
// (k0, k1), the key bumped by the Weyl constants between rounds.
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1, uint32_t (&out)[4]) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// Four neighbouring elements of row `row` starting at column `col` (a
// multiple of 4), as fp32; columns past n read as 0.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ w, size_t row, int col, int n,
                                      float (&x)[4]) {
  const T* p = w + row * size_t(n) + col;
  if constexpr (VEC && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (VEC) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    x[0] = __low2float(a); x[1] = __high2float(a);
    x[2] = __low2float(b); x[3] = __high2float(b);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = col + c < n ? to_f(p[c]) : 0.f;
  }
}

// amax_bits[j] = bit pattern of max_i |w[i, j]| (zeroed before the launch).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kGroupsX * kLanesY)
absmax_kernel(const T* __restrict__ w, uint32_t* __restrict__ amax_bits, int k, int n) {
  __shared__ float red[kLanesY][kGroupsX][4];
  const int col = (blockIdx.x * kGroupsX + threadIdx.x) * 4;
  const int row0 = blockIdx.y * kRowsPerBlock;
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < n) {
    for (int r = threadIdx.y; r < kRowsPerBlock && row0 + r < k; r += kLanesY) {
      float x[4];
      load4<T, VEC>(w, size_t(row0 + r), col, n, x);
#pragma unroll
      for (int c = 0; c < 4; ++c) m[c] = fmaxf(m[c], fabsf(x[c]));
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) red[threadIdx.y][threadIdx.x][c] = m[c];
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = m[c];
      for (int y = 1; y < kLanesY; ++y) v = fmaxf(v, red[y][threadIdx.x][c]);
      // |x| >= 0, and non-negative floats order as their bit patterns
      if (col + c < n) atomicMax(amax_bits + col + c, __float_as_uint(v));
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kGroupsX * kLanesY)
quantize_kernel(const T* __restrict__ w, const uint32_t* __restrict__ amax_bits,
                int8_t* __restrict__ values, float* __restrict__ scales, int k, int n,
                uint32_t seed_lo, uint32_t seed_hi) {
  const int col = (blockIdx.x * kGroupsX + threadIdx.x) * 4;
  if (col >= n) return;
  const int row0 = blockIdx.y * kRowsPerBlock;
  float scale[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float amax = col + c < n ? __uint_as_float(amax_bits[col + c]) : 0.f;
    scale[c] = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
    if (blockIdx.y == 0 && threadIdx.y == 0 && col + c < n) scales[col + c] = scale[c];
  }
  for (int r = threadIdx.y; r < kRowsPerBlock && row0 + r < k; r += kLanesY) {
    const size_t row = size_t(row0 + r);
    float x[4];
    load4<T, VEC>(w, row, col, n, x);
    uint32_t bits[4];
    philox4x32_10(uint32_t(row), uint32_t(col >> 2), 0u, 0u, seed_lo, seed_hi, bits);
    int8_t q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float u = float(bits[c] >> 8) * (1.0f / 16777216.0f);   // exact: 24 bits
      const float rounded = floorf(__fadd_rn(__fdiv_rn(x[c], scale[c]), u));
      q[c] = int8_t(fminf(fmaxf(rounded, -127.0f), 127.0f));
    }
    int8_t* out = values + row * size_t(n) + col;
    if constexpr (VEC) {
      *reinterpret_cast<char4*>(out) = make_char4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < n) out[c] = q[c];
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch(const void* w, void* values, void* scales, void* amax, int k, int n,
                   uint32_t seed_lo, uint32_t seed_hi, cudaStream_t stream) {
  const dim3 block(kGroupsX, kLanesY);
  const dim3 grid((n + kColsPerBlock - 1) / kColsPerBlock, (k + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaError_t err = cudaMemsetAsync(amax, 0, size_t(n) * sizeof(uint32_t), stream);
  if (err != cudaSuccess) return err;
  absmax_kernel<T, VEC><<<grid, block, 0, stream>>>(static_cast<const T*>(w),
                                                    static_cast<uint32_t*>(amax), k, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const uint32_t*>(amax), static_cast<int8_t*>(values),
      static_cast<float*>(scales), k, n, seed_lo, seed_hi);
  return cudaGetLastError();
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// w [K, N] float32 (dtype 0) or bfloat16 (dtype 1), contiguous; values [K, N]
// int8; scales [N] float32; amax [N] 32-bit scratch. Returns the cudaError_t
// of the launches (0 = launched).
extern "C" int colxlip_quantize_int8(const void* w, void* values, void* scales, void* amax,
                                     int k, int n, uint32_t seed_lo, uint32_t seed_hi, int dtype,
                                     void* stream) {
  if (k < 1 || n < 1 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  if ((k + kRowsPerBlock - 1) / kRowsPerBlock > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 0 ? 4 : 2;
  const bool vec = n % 4 == 0 && aligned(w, 4 * elem) && aligned(values, 4);
  if (dtype == 0)
    return int(vec ? launch<float, true>(w, values, scales, amax, k, n, seed_lo, seed_hi, s)
                   : launch<float, false>(w, values, scales, amax, k, n, seed_lo, seed_hi, s));
  return int(vec ? launch<__nv_bfloat16, true>(w, values, scales, amax, k, n, seed_lo, seed_hi, s)
                 : launch<__nv_bfloat16, false>(w, values, scales, amax, k, n, seed_lo, seed_hi, s));
}
