// Tile code shared by the fp32 CE kernels (csrc/fused_ce.cu), which stream
// one matrix past a block's own rows: a [rows, cols] tile of dot products
// held in registers, and the second product that adds a tile in shared
// memory times the streamed matrix's rows into the block's owned rows. Its
// second pass of a reduction across blocks, reduce_partials, also serves
// csrc/fused_ln.cu and csrc/fused_mlp.cu.
//
// Every product runs as fp32 FMAs on the CUDA cores. A 16 x 16 thread block
// holds the tile of raw dots in registers, fed from shared-memory chunks of
// 32 features stored feature-major with odd row strides (conflict-free
// stores, broadcast loads), as csrc/maxsim_tile.cuh does. In the second
// product each warp owns 4 output rows and all D features of them in
// registers, reads the tile as a warp-wide broadcast and the streamed rows
// through L1/L2 with lanes on consecutive features.
#pragma once

#include "common.cuh"

namespace colxlip {
namespace stream_tile {

constexpr int kTX = 16;            // threads along tile columns (rows of b)
constexpr int kTY = 16;            // threads along tile rows (rows of a)
constexpr int kThreads = kTX * kTY;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;            // feature chunk staged in shared memory
constexpr int kOwn = 32;           // output rows a block owns in the second product
constexpr int kStream = 64;        // rows of the streamed matrix per tile
constexpr int kOwnPerWarp = kOwn / kWarps;
constexpr int kMaxD = 768;

template <int RPT, int CPT>
struct Stage {
  float as[kKC][kTY * RPT + 1];
  float bs[kKC][kTX * CPT + 1];
};

// acc[r][c] = <a[i0 + ty + 16 r], b[j0 + tx + 16 c]> in fp32, 0 where the row
// or the column lies outside [0, m) x [0, n). Ends with __syncthreads().
template <typename T, int RPT, int CPT>
__device__ __forceinline__ void raw_tile(const T* __restrict__ a, const T* __restrict__ b, int i0,
                                         int j0, int m, int n, int d, Stage<RPT, CPT>& st,
                                         float (&acc)[RPT][CPT]) {
  constexpr int BM = kTY * RPT, BN = kTX * CPT;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kKC) {
    for (int idx = threadIdx.x; idx < BM * kKC; idx += kThreads) {
      const int row = idx / kKC, dd = idx - row * kKC;
      st.as[dd][row] =
          (i0 + row < m && d0 + dd < d) ? to_f(a[size_t(i0 + row) * d + d0 + dd]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < BN * kKC; idx += kThreads) {
      const int col = idx / kKC, dd = idx - col * kKC;
      st.bs[dd][col] =
          (j0 + col < n && d0 + dd < d) ? to_f(b[size_t(j0 + col) * d + d0 + dd]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < kKC; ++dd) {
      float av[RPT], bv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) av[r] = st.as[dd][ty + kTY * r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) bv[c] = st.bs[dd][tx + kTX * c];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
}

// The 16 tx lanes that share a tile row sit in one half-warp.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kTX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[r][c] += sum over the tile's `count` streamed rows s of
// z[4 warp + r][s] * rows[s, lane + 32 c]: each warp owns 4 output rows and
// all d features of them, and reads z as a warp-wide broadcast.
template <typename T, int DPT>
__device__ __forceinline__ void accumulate(const float (&z)[kOwn][kStream + 1],
                                           const T* __restrict__ rows, int count, int d,
                                           float (&out)[kOwnPerWarp][DPT]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = 0; s < count; ++s) {
    float zr[kOwnPerWarp];
#pragma unroll
    for (int r = 0; r < kOwnPerWarp; ++r) zr[r] = z[kOwnPerWarp * warp + r][s];
    const T* row = rows + size_t(s) * d;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        const float v = to_f(row[col]);
#pragma unroll
        for (int r = 0; r < kOwnPerWarp; ++r) out[r][c] = fmaf(zr[r], v, out[r][c]);
      }
    }
  }
}

template <int DPT>
__device__ __forceinline__ void zero_owned(float (&out)[kOwnPerWarp][DPT]) {
#pragma unroll
  for (int r = 0; r < kOwnPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < DPT; ++c) out[r][c] = 0.f;
}

// scale * out -> dst[first + 4 warp + r, :d] (fp32) for the owned rows
// below `limit`.
template <int DPT>
__device__ __forceinline__ void store_owned(const float (&out)[kOwnPerWarp][DPT],
                                            float* __restrict__ dst, int first, int limit, int d,
                                            float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kOwnPerWarp; ++r) {
    const int row = first + kOwnPerWarp * warp + r;
    if (row >= limit) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = lane + 32 * c;
      if (col < d) dst[size_t(row) * d + col] = scale * out[r][c];
    }
  }
}

// out[i] = sum over s < splits of partials[s * n + i] in a fixed order: the
// second pass of a reduction across blocks (no atomics, so two runs agree
// bit for bit). Few partial rows (splits <= kRedGroups): one thread a column
// adds them in order. Many (the LayerNorm's dgamma / dbeta, the MLP's db1 and
// db2: 100-300 rows): one block per 32 columns, row group r (of kRedGroups)
// adds rows r, r + kRedGroups, ... in order, then the groups add up in order.
// Where splits <= kRedGroups both orders are the same, so the choice moves
// time and no bit: at 264 rows the sliced form takes the LN's and the MLP's
// bias reduces from 0.009 to 0.002-0.005 ms, at the fp32 MLP's 8 rows of
// H x D it is ten times slower than the serial one (0.61 against 0.065 ms;
// H100, PERF.md). A `Finish` applies once to each total, after the whole
// sum: times *scale (the CE dA's logit scale, read on the device), then
// + bias[i % period] (the fp32 MLP forward's b2); without one the total is
// stored as it is.
constexpr int kRedGroups = 32;

struct Finish {
  const float* scale = nullptr;
  const float* bias = nullptr;
  int period = 1;
};

__device__ __forceinline__ float finish(float total, int i, const Finish& f) {
  if (f.scale != nullptr) total = *f.scale * total;
  if (f.bias != nullptr) total += f.bias[i % f.period];
  return total;
}

template <int kUnused = 0>
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int splits, int n, Finish f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float total = 0.f;
  for (int s = 0; s < splits; ++s) total += partials[size_t(s) * n + i];
  out[i] = finish(total, i, f);
}

template <int kUnused = 0>
__global__ void __launch_bounds__(32 * kRedGroups)
reduce_partials_sliced_kernel(const float* __restrict__ partials, float* __restrict__ out,
                              int splits, int n, Finish f) {
  __shared__ float acc[kRedGroups][32];
  const int lane = threadIdx.x & 31, group = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float total = 0.f;
  if (col < n) {
#pragma unroll 4
    for (int s = group; s < splits; s += kRedGroups) total += partials[size_t(s) * n + col];
  }
  acc[group][lane] = total;
  __syncthreads();
  if (group == 0 && col < n) {
    float sum = acc[0][lane];
#pragma unroll
    for (int r = 1; r < kRedGroups; ++r) sum += acc[r][lane];
    out[col] = finish(sum, col, f);
  }
}

inline cudaError_t reduce_partials(const float* partials, float* out, int splits, int n,
                                   cudaStream_t stream, Finish f = Finish()) {
  if (splits <= kRedGroups)
    reduce_partials_kernel<><<<(n + 255) / 256, 256, 0, stream>>>(partials, out, splits, n, f);
  else
    reduce_partials_sliced_kernel<><<<(n + 31) / 32, 32 * kRedGroups, 0, stream>>>(
        partials, out, splits, n, f);
  return cudaGetLastError();
}

}  // namespace stream_tile
}  // namespace colxlip
