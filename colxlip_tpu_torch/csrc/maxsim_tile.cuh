// The MaxSim similarity tile, shared by the forward kernel (maxsim.cu) and
// the backward's route pass (maxsim_bwd.cu), so both compute the same fp32
// similarities bit for bit from the same code.
//
// The tile is the Pallas kernel's shape (colxlip_tpu/ops/maxsim_pallas.py
// `_sim_tile`): one matrix product [rows, D] . [Li, D]^T with fp32
// accumulation, where the rows are the flattened text tokens r = m * Lt + n
// and the columns one image's tokens. A block owns 128 rows (8 warps of 16)
// against one image k; a warp holds its 16 rows across a group of 16 * NP
// columns in mma.sync.m16n8k16 accumulators (2 NP n-tiles of 8, 8 NP fp32
// registers a thread; the layouts are in mma_tile.cuh). D walks past in
// chunks of 64 features through a ring of shared-memory stages (three for
// bf16, two for fp32): rows whose 16-byte pieces are aligned go by cp.async,
// with the copies in flight under the products; any other input is staged by
// plain loads and stores.
//
// fp32 inputs keep fp32 products on the CUDA cores (`chunk_fma`), written
// into the same accumulator layout, so every epilogue is shared: a thread
// holds rows g and g + 8 and columns 8 nt + 2t, 2t + 1 of its warp's tile, as
// the m16n8 C fragment does, and takes each similarity as fmaf over the
// features in order. A split-bf16 product (hi.hi + hi.lo + lo.hi on the
// tensor cores) met the forward's 1e-5 but not the backward: its 2e-7 rms
// error moves the argmax of the rows whose top two similarities lie closer
// than that (a few dozen of 5 M at the training shape), and each such row
// sends its cotangent to another image token (PERF.md).
//
// Columns: an image of Li <= 256 tokens is one group (NP = 4, 8, 13 or 16
// pairs of n-tiles: 64, 128, 208 or 256 columns); above that the columns go
// in `groups` groups of 16 * NP, walked in order with a running row max
// (exact, so the order changes nothing). Columns past Li, the zero-filled
// padding of the last group, are set to -inf before any max or tie test: a
// zero there would be the max of a row whose live similarities are all
// negative. Rows past M * Lt are zero-filled and never written.
#pragma once

#include <stdint.h>

#include "mma_tile.cuh"

namespace colxlip {
namespace maxsim_tile {

using mma::bf16;
using colxlip::from_f;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * 16;  // flattened text rows a block
constexpr int kDC = 64;                  // features a chunk
constexpr int kMaxPairs = 16;            // a group is at most 256 columns
constexpr float kEps = 1e-8f;

// How the columns of an image of Li tokens are walked: `groups` groups of
// 16 * np columns; group gi holds columns gi * 16 * np ... The forward and
// the route pass take the same plan, so their similarities agree bit for bit.
struct Plan {
  int np;
  int groups;
};

__host__ __device__ inline Plan plan(int li) {
  const int groups = (li + 16 * kMaxPairs - 1) / (16 * kMaxPairs);
  const int pairs = ((li + groups - 1) / groups + 15) / 16;
  return {pairs <= 4 ? 4 : pairs <= 8 ? 8 : pairs <= 13 ? 13 : 16, groups};
}

// Shared memory of one block: kStages stages, each the text tile [128, RS]
// and the image tile [16 NP, RS] in the input type (bf16 rows padded to 72
// elements for conflict-free ldmatrix, fp32 rows to 68 for conflict-free
// float4 reads).
template <typename T, int NP>
struct Layout {
  static constexpr bool kMma = sizeof(T) == 2;
  static constexpr int kRS = kMma ? kDC + 8 : kDC + 4;
  static constexpr int kStages = kMma ? 3 : 2;
  static constexpr int kA = kBlockRows * kRS;
  static constexpr int kB = 16 * NP * kRS;
  static constexpr int kStage = kA + kB;
  static constexpr size_t kBytes = size_t(kStages) * kStage * sizeof(T);
};

// Whether rows of d elements from these bases split into aligned 16-byte
// pieces (the cp.async path).
template <typename T>
__host__ inline bool async16(const void* text, const void* image, int d) {
  return (size_t(d) * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(text) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(image) & 15) == 0;
}

// Rows row0 .. row0 + ROWS - 1 of a [n, d] operand (rows d elements apart),
// features d0 .. d0 + 63, into a tile of row stride RS, by the THREADS
// threads of the block. Rows past n and features past d are zeros. `async`:
// every 16-byte piece is either wholly live or wholly dead (async16 above).
template <typename T, int ROWS, int RS, int THREADS = kThreads>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, int row0, int n,
                                           int d, int d0, bool async) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte piece
  if (async) {
    for (int idx = threadIdx.x; idx < ROWS * (kDC / V); idx += THREADS) {
      const int r = idx / (kDC / V), c = (idx - r * (kDC / V)) * V;
      const bool live = row0 + r < n && d0 + c < d;
      mma::cp_async_16(dst + r * RS + c, live ? src + size_t(row0 + r) * d + d0 + c : src, live);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * kDC; idx += THREADS) {
    const int r = idx / kDC, c = idx - r * kDC;
    dst[r * RS + c] = row0 + r < n && d0 + c < d ? src[size_t(row0 + r) * d + d0 + c]
                                                 : from_f<T>(0.f);
  }
}

// The products of one chunk of 64 features into the warp's accumulators,
// bf16 on the tensor cores: acc[nt] is the n-tile of group columns
// 8 nt .. 8 nt + 7. `a` points at the warp's 16 rows of the text tile, `b`
// at the image tile.
template <int NP>
__device__ __forceinline__ void chunk_products(float (&acc)[2 * NP][4], const bf16* a,
                                               const bf16* b, int lane) {
  constexpr int RS = kDC + 8;
  const bf16* pa = a + (lane & 15) * RS + (lane >> 4) * 8;
  const bf16* pb = b + ((lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kDC / 16; ++kk) {
    uint32_t af[4];
    mma::ldmatrix_x4(af, pa + kk * 16);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t bf[4];
      mma::ldmatrix_x4(bf, pb + np * 16 * RS + kk * 16);
      mma::mma_16816(acc[2 * np], af, bf[0], bf[1]);
      mma::mma_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// The same for fp32 on the CUDA cores, in the same accumulator layout: lane
// (g, t) takes rows g, g + 8 and columns 8 nt + 2t, 2t + 1, one fmaf a
// feature, features in order (float4 reads of rows 68 floats apart: the
// eight rows g, and the four columns 2t, lie in distinct banks).
template <int NP>
__device__ __forceinline__ void chunk_fma(float (&acc)[2 * NP][4], const float* a,
                                          const float* b, int lane) {
  constexpr int RS = kDC + 4;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const float* a0 = a + g * RS;
  const float* a1 = a0 + 8 * RS;
  const float* b0 = b + t2 * RS;
#pragma unroll 1
  for (int dd = 0; dd < kDC; dd += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + dd);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + dd);
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt) {
      const float4 y0 = *reinterpret_cast<const float4*>(b0 + 8 * nt * RS + dd);
      const float4 y1 = *reinterpret_cast<const float4*>(b0 + (8 * nt + 1) * RS + dd);
      float(&c)[4] = acc[nt];
      c[0] = fmaf(x0.w, y0.w, fmaf(x0.z, y0.z, fmaf(x0.y, y0.y, fmaf(x0.x, y0.x, c[0]))));
      c[1] = fmaf(x0.w, y1.w, fmaf(x0.z, y1.z, fmaf(x0.y, y1.y, fmaf(x0.x, y1.x, c[1]))));
      c[2] = fmaf(x1.w, y0.w, fmaf(x1.z, y0.z, fmaf(x1.y, y0.y, fmaf(x1.x, y0.x, c[2]))));
      c[3] = fmaf(x1.w, y1.w, fmaf(x1.z, y1.z, fmaf(x1.y, y1.y, fmaf(x1.x, y1.x, c[3]))));
    }
  }
}

// acc = sim[rows row0 + 16 warp .. +15, columns col0 .. col0 + 16 NP - 1] of
// text [rows, d] against one image ik [li, d], fp32, with columns at or past
// li set to -inf. Every thread of the block takes part (barriers inside).
template <typename T, int NP>
__device__ __forceinline__ void sim_group(float (&acc)[2 * NP][4], T* smem,
                                          const T* __restrict__ text, const T* __restrict__ ik,
                                          int rows, int row0, int li, int col0, int d,
                                          bool async) {
  using L = Layout<T, NP>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (d + kDC - 1) / kDC;
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  auto stage = [&](int c) {
    T* s = smem + (c % L::kStages) * L::kStage;
    stage_rows<T, kBlockRows, L::kRS>(s, text, row0, rows, d, c * kDC, async);
    stage_rows<T, 16 * NP, L::kRS>(s + L::kA, ik, col0, li, d, c * kDC, async);
  };
  // every warp is done with the stages of the previous group (or epilogue)
  __syncthreads();
#pragma unroll
  for (int c = 0; c < L::kStages - 1; ++c) {
    if (c < chunks) stage(c);
    mma::cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    // chunk c has arrived, and every warp is done with the stage that chunk
    // c + kStages - 1 now takes (it read it in the step before): one barrier
    mma::cp_async_wait<L::kStages - 2>();
    __syncthreads();
    if (c + L::kStages - 1 < chunks) stage(c + L::kStages - 1);
    mma::cp_async_commit();
    const T* s = smem + (c % L::kStages) * L::kStage;
    if constexpr (L::kMma)
      chunk_products<NP>(acc, s + warp * 16 * L::kRS, s + L::kA, lane);
    else
      chunk_fma<NP>(acc, s + warp * 16 * L::kRS, s + L::kA, lane);
  }
  // dead columns: -inf before any max or tie test
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt) {
    const int col = col0 + 8 * nt + t2;
    if (col >= li) acc[nt][0] = acc[nt][2] = -INFINITY;
    if (col + 1 >= li) acc[nt][1] = acc[nt][3] = -INFINITY;
  }
}

// Running max of the thread's two rows (g and g + 8) over its columns; the
// quad's four lanes hold the rest of each row (quad_max at the end).
template <int NP>
__device__ __forceinline__ void row_max(const float (&acc)[2 * NP][4], float& m0, float& m1) {
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt) {
    m0 = fmaxf(m0, fmaxf(acc[nt][0], acc[nt][1]));
    m1 = fmaxf(m1, fmaxf(acc[nt][2], acc[nt][3]));
  }
}

// Index of max_sim / coef [M, K, Lt] for flattened text row r and image k.
__device__ __forceinline__ size_t mkn(int r, int lt, int num_k, int k) {
  const int m = r / lt;
  return (size_t(m) * num_k + k) * lt + (r - m * lt);
}

// Weight of text token n in the masked mean: 0 'nonzero' (max != 0),
// 1 'plain' (all ones), 2 'valid' (text_mask[m, n]).
__device__ __forceinline__ float token_weight(int mask_mode, float rowmax, const float* mask_row,
                                              int n) {
  return mask_mode == 0 ? (rowmax != 0.f ? 1.f : 0.f) : mask_mode == 1 ? 1.f : mask_row[n];
}

}  // namespace maxsim_tile
}  // namespace colxlip
