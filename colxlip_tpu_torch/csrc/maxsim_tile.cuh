// The MaxSim similarity tile, shared by the forward kernel (maxsim.cu) and
// the backward's routing kernel (maxsim_bwd.cu), so both see the same fp32
// similarities bit for bit.
//
// One block of 16 x 16 threads holds the [Lt, Li] similarity tile of one
// (text m, image k) pair in registers: thread (tx, ty) holds rows
// ty + 16 r (r < 5) and columns tx + 16 c (c < CPT). The tile is a small
// register-tiled GEMM of T[m] (Lt x D) against I[k] (Li x D), fed from
// shared-memory chunks of 32 features stored feature-major with odd row
// strides (conflict-free stores and broadcast loads).
#pragma once

#include "common.cuh"

namespace colxlip {
namespace maxsim_tile {

constexpr int kTX = 16;              // threads along image tokens
constexpr int kTY = 16;              // threads along text tokens
constexpr int kRPT = 5;              // text rows per thread
constexpr int kRows = kTY * kRPT;    // 80 >= Lt = 77
constexpr int kDC = 32;              // feature chunk staged in shared memory
constexpr int kThreads = kTX * kTY;
constexpr int kMaxCols = 16 * kTX;   // Li <= 256
constexpr float kEps = 1e-8f;

template <int CPT>
struct Smem {
  float ts[kDC][kRows + 1];
  float is[kDC][kTX * CPT + 1];
  float rowmax[kRows];
};

// acc[r][c] = <T[m, ty + 16 r], I[k, tx + 16 c]> in fp32 (0 outside the
// tile), then smem.rowmax[n] = max over the Li columns, for n < Lt.
template <typename T, int CPT>
__device__ __forceinline__ void sim_tile(const T* __restrict__ tm, const T* __restrict__ ik,
                                         int lt, int li, int d, Smem<CPT>& sm,
                                         float (&acc)[kRPT][CPT]) {
  constexpr int kCols = kTX * CPT;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int r = 0; r < kRPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kDC) {
    for (int idx = threadIdx.x; idx < kRows * kDC; idx += blockDim.x) {
      const int row = idx / kDC, dd = idx - row * kDC;
      sm.ts[dd][row] = (row < lt && d0 + dd < d) ? to_f(tm[size_t(row) * d + d0 + dd]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kCols * kDC; idx += blockDim.x) {
      const int col = idx / kDC, dd = idx - col * kDC;
      sm.is[dd][col] = (col < li && d0 + dd < d) ? to_f(ik[size_t(col) * d + d0 + dd]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < kDC; ++dd) {
      float a[kRPT], bv[CPT];
#pragma unroll
      for (int r = 0; r < kRPT; ++r) a[r] = sm.ts[dd][ty + kTY * r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) bv[c] = sm.is[dd][tx + kTX * c];
#pragma unroll
      for (int r = 0; r < kRPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (tx + kTX * c < li) mx = fmaxf(mx, acc[r][c]);
    // the 16 tx lanes of one ty sit in one half-warp
#pragma unroll
    for (int o = kTX / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (tx == 0) sm.rowmax[ty + kTY * r] = mx;
  }
  __syncthreads();
}

// Weight of text token n in the masked mean: 0 'nonzero' (max != 0),
// 1 'plain' (all ones), 2 'valid' (text_mask[m, n]).
__device__ __forceinline__ float token_weight(int mask_mode, float rowmax, const float* mask_row,
                                              int n) {
  return mask_mode == 0 ? (rowmax != 0.f ? 1.f : 0.f) : mask_mode == 1 ? 1.f : mask_row[n];
}

}  // namespace maxsim_tile
}  // namespace colxlip
