// Tile code shared by the fp32 CE kernels (csrc/fused_ce.cu), which stream
// one matrix past a block's own rows: a [rows, cols] tile of dot products
// held in registers, and the second product that adds a tile in shared
// memory times the streamed matrix's rows into the block's owned rows. Its
// second pass of a reduction across blocks, reduce_partials, also serves
// csrc/fused_ln.cu and csrc/fused_mlp.cu.
//
// Every product runs as fp32 FMAs on the CUDA cores, and every sum keeps one
// order whatever the tiling: raw_ij is one fmaf chain over the features in
// order from zero, and each output element of the second product one fmaf
// chain over the streamed rows in order. So the forward's lse and the
// backward's p = exp(scale raw - lse) meet on the same bits of raw, and any
// tiling of these sums gives the same bits as any other.
//
// raw_tile: a 16 x 16 thread block holds the tile, thread (tx, ty) rows
// ty + 16 r and columns tx + 16 c (the epilogues' row reductions run over the
// 16 tx lanes of a half-warp). The features arrive in chunks of kKC = 32
// through a ring of two shared-memory stages filled by cp.async, so chunk
// c + 1 is in flight under chunk c's products. A chunk is staged row-major,
// row stride kKS = kKC + 4 floats: every row starts on 16 bytes and eight
// consecutive rows fall in eight bank groups, so a half-warp's 16 float4
// reads of b's rows take two wavefronts and its reads of one a row are a
// broadcast. A thread reads float4 along the features: RPT + CPT 16-byte
// loads feed 4 RPT CPT fmaf.
//
// accumulate: the streamed tile's rows arrive in shared memory by cp.async
// too, a few rows at a time through a ring of two stages, and are never
// read through L1/L2 in the loop. A thread owns 8 output rows x DPT
// features (DPT / 4 float4 columns, 64 columns apart), so for each streamed
// row it reads its 8 dz values as two float4 broadcasts and its features as
// DPT / 4 float4 loads for 8 DPT fmaf. A block holds at most 64 DPT = 768
// features of each row (DPT = 12); wider rows are cut into feature slices
// along the grid's z axis (feature_slice), each block recomputing raw.
#pragma once

#include "common.cuh"
#include "mma_tile.cuh"   // cp.async

namespace colxlip {
namespace stream_tile {

constexpr int kTX = 16;            // threads along tile columns
constexpr int kTY = 16;            // threads along tile rows
constexpr int kThreads = kTX * kTY;
constexpr int kKC = 32;            // features a staged chunk of raw_tile
constexpr int kKS = kKC + 4;       // its row stride (floats)
constexpr int kOwn = 32;           // output rows a block owns in the second product
constexpr int kStream = 64;        // rows of the streamed matrix per tile
constexpr int kZS = kOwn + 4;      // row stride of the dz tile [kStream][kZS]
constexpr int kAccRows = 8;        // output rows a thread holds in the second product
constexpr int kAccCols = 64;       // float4 columns of a row the block's threads cover
constexpr int kSliceD = 768;       // features of a row one block holds (DPT = 12)

// The two stages of raw_tile: a's rows, then b's, chunk-major.
template <int RPT, int CPT>
struct RawStages {
  float as[2][kTY * RPT][kKS];
  float bs[2][kTX * CPT][kKS];
};

// Streamed rows a stage of accumulate holds, and its row width.
template <int DPT>
struct AccShape {
  static constexpr int kRows = DPT <= 8 ? 8 : 4;
  static constexpr int kWidth = kAccCols * DPT;
};

template <int DPT>
using AccStages = float[2][AccShape<DPT>::kRows][AccShape<DPT>::kWidth];

// The backward kernels' shared memory: raw_tile's stages and accumulate's
// share their bytes (each function ends with a barrier, and the other's
// first copies go out after it), the dz tile [streamed row][own row] apart.
template <int RPT, int CPT, int DPT>
struct BwdShared {
  union {
    RawStages<RPT, CPT> raw;
    AccStages<DPT> rows;
  } u;
  float zt[kStream][kZS];
};

// The width of each of `slices` feature slices of a d-feature row: a
// multiple of 4, so that a slice of 16-byte aligned rows starts on 16 bytes.
__host__ __device__ __forceinline__ int slice_width(int d, int slices) {
  return ((d + slices - 1) / slices + 3) & ~3;
}

struct Slice {
  int f0, f1;   // features [f0, f1) of the block's slice (blockIdx.z)
};

__device__ __forceinline__ Slice feature_slice(int d) {
  const int w = slice_width(d, gridDim.z);
  const int f0 = blockIdx.z * w;
  return {f0, min(d, f0 + w)};
}

// Rows r0 .. r0 + ROWS - 1 of a row-major [rows, d] fp32 matrix, features
// f0 .. f0 + W - 1 of each, into dst[r][f] (row stride RS floats): zeros past
// `rows` and from feature f1 on. 16 bytes a copy where vec (d a multiple of 4
// on a 16-byte base, f0 and f1 multiples of 4), else 4. The caller commits.
template <int ROWS, int W, int RS>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int r0,
                                           int rows, int f0, int f1, int d, bool vec) {
  constexpr int Q = W / 4;   // 16-byte pieces a row
  static_assert(ROWS * Q % kThreads == 0, "whole pieces a thread");
#pragma unroll
  for (int i = 0; i < ROWS * Q / kThreads; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    const int r = idx / Q, f = (idx - r * Q) * 4;
    const bool row_live = r0 + r < rows;
    float* to = dst + r * RS + f;
    if (vec) {
      const bool live = row_live && f0 + f < f1;
      mma::cp_async_16(to, live ? src + size_t(r0 + r) * d + f0 + f : src, live);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = row_live && f0 + f + e < f1;
        mma::cp_async_4(to + e, live ? src + size_t(r0 + r) * d + f0 + f + e : src, live);
      }
    }
  }
}

template <int RPT, int CPT>
__device__ __forceinline__ void stage_chunk(RawStages<RPT, CPT>& st, int buf,
                                            const float* __restrict__ a,
                                            const float* __restrict__ b, int i0, int j0, int m,
                                            int n, int k0, int d, bool vec) {
  stage_rows<kTY * RPT, kKC, kKS>(&st.as[buf][0][0], a, i0, m, k0, min(d, k0 + kKC), d, vec);
  stage_rows<kTX * CPT, kKC, kKS>(&st.bs[buf][0][0], b, j0, n, k0, min(d, k0 + kKC), d, vec);
}

// raw_tile's first chunk into stage 0, committed: issued before raw_tile
// (after the barrier that ends the shared memory's last use), so that it is
// in flight under whatever the caller does in between.
template <int RPT, int CPT>
__device__ __forceinline__ void raw_prefetch(RawStages<RPT, CPT>& st,
                                             const float* __restrict__ a,
                                             const float* __restrict__ b, int i0, int j0, int m,
                                             int n, int d, bool vec) {
  stage_chunk<RPT, CPT>(st, 0, a, b, i0, j0, m, n, 0, d, vec);
  mma::cp_async_commit();
}

// acc[r][c] = <a[i0 + ty + 16 r], b[j0 + tx + 16 c]> in fp32, one fmaf chain
// over the features in order from zero; 0 where the row or the column lies
// outside [0, m) x [0, n). The first chunk must have been issued by
// raw_prefetch with the same arguments. Ends with __syncthreads().
template <int RPT, int CPT>
__device__ __forceinline__ void raw_tile(const float* __restrict__ a, const float* __restrict__ b,
                                         int i0, int j0, int m, int n, int d, bool vec,
                                         RawStages<RPT, CPT>& st, float (&acc)[RPT][CPT]) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  const int chunks = (d + kKC - 1) / kKC;
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    // chunk ch has landed, and every thread is done with the stage the next
    // chunk takes (chunk ch - 1's)
    mma::cp_async_wait<0>();
    __syncthreads();
    if (ch + 1 < chunks) {
      stage_chunk<RPT, CPT>(st, buf ^ 1, a, b, i0, j0, m, n, (ch + 1) * kKC, d, vec);
      mma::cp_async_commit();
    }
#pragma unroll
    for (int k = 0; k < kKC; k += 4) {
      float4 av[RPT], bv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        av[r] = *reinterpret_cast<const float4*>(&st.as[buf][ty + kTY * r][k]);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        bv[c] = *reinterpret_cast<const float4*>(&st.bs[buf][tx + kTX * c][k]);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
          acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
          acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
          acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
        }
    }
  }
  __syncthreads();   // every thread is done with the stages
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

// The thread's first output row of the block's kOwn, and its first float4
// column of the slice: rows 8 (warp / 2) .. + 7, columns
// 32 (warp % 2) + lane + 64 q, q < DPT / 4.
__device__ __forceinline__ int acc_row0() { return kAccRows * (threadIdx.x >> 6); }
__device__ __forceinline__ int acc_col0() { return threadIdx.x & 63; }

// accumulate's first stage of the tile's `count` streamed rows (`rows`
// points at the first), committed; issued after raw_tile's closing barrier.
template <int DPT>
__device__ __forceinline__ void acc_prefetch(AccStages<DPT>& st, const float* __restrict__ rows,
                                             int count, int d, bool vec) {
  using S = AccShape<DPT>;
  const Slice fs = feature_slice(d);
  stage_rows<S::kRows, S::kWidth, S::kWidth>(&st[0][0][0], rows, 0, count, fs.f0, fs.f1, d, vec);
  mma::cp_async_commit();
}

// out[r][4 q + e] += sum over the tile's `count` streamed rows s, in order,
// of zt[s][acc_row0() + r] * rows[s, f0 + 4 (acc_col0() + 64 q) + e]: one
// fmaf chain an element. The first stage must have been issued by
// acc_prefetch with the same arguments; zt is read after the first barrier.
// Ends with __syncthreads().
template <int DPT>
__device__ __forceinline__ void accumulate(const float (&zt)[kStream][kZS],
                                           const float* __restrict__ rows, int count, int d,
                                           bool vec, AccStages<DPT>& st,
                                           float (&out)[kAccRows][DPT]) {
  using S = AccShape<DPT>;
  const Slice fs = feature_slice(d);
  const int row0 = acc_row0(), col0 = acc_col0();
  const int chunks = (count + S::kRows - 1) / S::kRows;
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    mma::cp_async_wait<0>();
    __syncthreads();
    if (ch + 1 < chunks) {
      stage_rows<S::kRows, S::kWidth, S::kWidth>(&st[buf ^ 1][0][0], rows, (ch + 1) * S::kRows,
                                                 count, fs.f0, fs.f1, d, vec);
      mma::cp_async_commit();
    }
    const int here = min(S::kRows, count - ch * S::kRows);
#pragma unroll
    for (int s = 0; s < S::kRows; ++s) {
      if (s >= here) break;
      const float* zrow = &zt[ch * S::kRows + s][row0];
      const float4 z0 = *reinterpret_cast<const float4*>(zrow);
      const float4 z1 = *reinterpret_cast<const float4*>(zrow + 4);
      const float z[kAccRows] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int q = 0; q < DPT / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&st[buf][s][4 * (col0 + kAccCols * q)]);
#pragma unroll
        for (int r = 0; r < kAccRows; ++r) {
          out[r][4 * q] = fmaf(z[r], v.x, out[r][4 * q]);
          out[r][4 * q + 1] = fmaf(z[r], v.y, out[r][4 * q + 1]);
          out[r][4 * q + 2] = fmaf(z[r], v.z, out[r][4 * q + 2]);
          out[r][4 * q + 3] = fmaf(z[r], v.w, out[r][4 * q + 3]);
        }
      }
    }
  }
  __syncthreads();   // every thread is done with the stages and with zt
}

template <int DPT>
__device__ __forceinline__ void zero_owned(float (&out)[kAccRows][DPT]) {
#pragma unroll
  for (int r = 0; r < kAccRows; ++r)
#pragma unroll
    for (int c = 0; c < DPT; ++c) out[r][c] = 0.f;
}

// scale * out -> dst[first + acc_row0() + r, feature] (fp32) for the owned
// rows below `limit` and the features of the block's slice.
template <int DPT>
__device__ __forceinline__ void store_owned(const float (&out)[kAccRows][DPT],
                                            float* __restrict__ dst, int first, int limit, int d,
                                            float scale) {
  const Slice fs = feature_slice(d);
  const int row0 = first + acc_row0(), col0 = acc_col0();
#pragma unroll
  for (int r = 0; r < kAccRows; ++r) {
    const int row = row0 + r;
    if (row >= limit) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = fs.f0 + 4 * (col0 + kAccCols * (c / 4)) + c % 4;
      if (col < fs.f1) dst[size_t(row) * d + col] = scale * out[r][c];
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
// sum: times *scale (the CE dA's and dB's logit scale, read on the device),
// then + bias[i % period] (the fp32 MLP forward's b2); without one the total
// is stored as it is.
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
