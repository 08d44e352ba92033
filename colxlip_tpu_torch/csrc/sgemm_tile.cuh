// The fp32 GEMM tile of the fused MLP's float32 backward (csrc/fused_mlp.cu):
// every product of that backward runs through this one main loop on the
// CUDA cores, with an epilogue chosen by the caller. fp32 FMAs only: no TF32
// and no split-bf16 product, which would not keep fp32's sums
// (maxsim_tile.cuh says why).
//
// A block of 8 warps computes a C tile of kBM x kBN (128 x 128) of
//   C[m, n] = sum over k of A(m, k) B(k, n)
// as register blocks: the warps stand 4 (along M) x 2 (along N), a warp owns
// 32 x 64 outputs, and each thread 8 x 8 in four 4 x 4 pieces, rows
// 4 (lane / 8) + {0..3, 16..19} and columns 4 (lane % 8) + {0..3, 32..35} of
// its warp's. K walks past in steps of kBK (16) through a ring of kStages
// (3) shared-memory stages filled by cp.async, the copies of the next two
// steps in flight under the products of this one. Each k of a step is one
// outer product: four float4 reads from shared memory (two of A's column,
// two of B's row) feed 64 fmaf, so shared memory serves a quarter of what
// the FMA units could take.
//
// Both operands are staged k-major, [kBK][kRS] floats, the row stride kRS =
// 128 + 4 so that every row starts on 16 bytes: a warp's float4 reads of one
// k are 4 distinct addresses of A (64 contiguous bytes, broadcast) and 8 of B
// (128 contiguous bytes), one wavefront each. Three operand layouts, one for
// each shape of product the MLP has (mlp_gemm.cuh's):
//   kNT  A [M, K] row-major, B [N, K] row-major   x W1^T, dy W2^T
//   kNN  A [M, K] row-major, B [K, N] row-major   dh W1
//   kTN  A [K, M] row-major, B [K, N] row-major   a^T dy, dh^T x
// A k-major operand (A of kTN, B of kNN and kTN) is copied as it lies, 16
// bytes a copy where its rows allow (VEC: columns and row stride multiples
// of 4 floats, the base on 16 bytes), else 4 bytes a copy. A row-major one is
// transposed on the way, one 4-byte copy an element: lane l of warp w copies
// k = (l % 8) + 8 (i / 4) of row 4 w + l / 8 + 32 (i % 4), i = 0..7, so a
// warp reads 32 contiguous bytes of each of four rows, and its 32 stores fall
// in 32 banks ((4 k + row) mod 32). Pieces past M, N or K are zero-filled,
// never read, so M, N and K need not be multiples of anything.
//
// Every output element is one fmaf chain over K in ascending order, from
// zero: two runs agree bit for bit, and a product cut into K slices (the
// caller's split) sums each slice in the same order.
#pragma once

#include <stdint.h>

#include "mma_tile.cuh"   // cp.async

namespace colxlip {
namespace sgemm {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 128;      // rows of C a block
constexpr int kBN = 128;      // columns of C a block
constexpr int kBK = 16;       // k a stage
constexpr int kStages = 3;
constexpr int kPad = 4;       // floats of padding a staged row
constexpr int kRS = kBM + kPad;                  // row stride of a staged operand
constexpr int kOperandElems = kBK * kRS;
constexpr int kStageElems = 2 * kOperandElems;   // A then B
constexpr size_t kBytes = size_t(kStages) * kStageElems * sizeof(float);
constexpr int kWarpsM = 4, kWarpsN = 2;
constexpr int kWM = kBM / kWarpsM;               // 32 rows a warp
constexpr int kWN = kBN / kWarpsN;               // 64 columns a warp
constexpr int kThreadRows = 8, kThreadCols = 8;   // outputs a thread, each way

static_assert(kBM == kBN, "A and B share the staged row stride");
static_assert(kThreads * 8 == kBM * kBK, "one transposed stage: 8 copies a thread");
static_assert(kThreads * 2 * 4 == kBN * kBK, "one k-major stage: 2 float4 a thread");

enum Layout { kNT = 0, kNN = 1, kTN = 2 };

// One product's operands: A and B as stored, rows lda / ldb floats apart.
struct Operands {
  const float* a;
  const float* b;
  int lda, ldb;
  int m, n, k;
};

// Row (of the block's 128) of the thread's acc[i][.], and column of acc[.][j].
__device__ __forceinline__ int tile_row(int i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / kWarpsN) * kWM + (lane >> 3) * 4 + (i & 3) + 16 * (i >> 2);
}
__device__ __forceinline__ int tile_col(int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % kWarpsN) * kWN + (lane & 7) * 4 + (j & 3) + 32 * (j >> 2);
}

// Rows r0 .. r0 + 127 of a row-major operand [rows, k] (ld apart), elements
// k0 .. k0 + 15 of each, into s[k][row].
__device__ __forceinline__ void stage_transposed(float* s, const float* __restrict__ src, int ld,
                                                 int r0, int rows, int k0, int k) {
  const int r = threadIdx.x >> 3, kk = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r + 32 * (i & 3), kc = kk + 8 * (i >> 2);
    const bool live = r0 + row < rows && k0 + kc < k;
    mma::cp_async_4(s + kc * kRS + row, live ? src + size_t(r0 + row) * ld + k0 + kc : src,
                    live);
  }
}

// Rows k0 .. k0 + 15 of a k-major operand [k, cols] (ld apart), columns
// c0 .. c0 + 127 of each, into s[k][col].
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* s, const float* __restrict__ src, int ld,
                                           int k0, int k, int c0, int cols) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = threadIdx.x + kThreads * i;
    const int kr = p >> 5, c = (p & 31) * 4;
    const bool krow = k0 + kr < k;
    float* dst = s + kr * kRS + c;
    if constexpr (VEC) {
      const bool live = krow && c0 + c < cols;
      mma::cp_async_16(dst, live ? src + size_t(k0 + kr) * ld + c0 + c : src, live);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = krow && c0 + c + j < cols;
        mma::cp_async_4(dst + j, live ? src + size_t(k0 + kr) * ld + c0 + c + j : src, live);
      }
    }
  }
}

// Stage k-step k0 of the block's tile (m0, n0); the caller commits.
template <int L, bool VEC>
__device__ __forceinline__ void load_stage(float* s, const Operands& p, int m0, int n0, int k0) {
  if constexpr (L == kTN)
    stage_rows<VEC>(s, p.a, p.lda, k0, p.k, m0, p.m);
  else
    stage_transposed(s, p.a, p.lda, m0, p.m, k0, p.k);
  if constexpr (L == kNT)
    stage_transposed(s + kOperandElems, p.b, p.ldb, n0, p.n, k0, p.k);
  else
    stage_rows<VEC>(s + kOperandElems, p.b, p.ldb, k0, p.k, n0, p.n);
}

// The kBK outer products of one stage into the thread's accumulators.
__device__ __forceinline__ void stage_products(float (&acc)[kThreadRows][kThreadCols],
                                               const float* s) {
  const float* as = s + tile_row(0);
  const float* bs = s + kOperandElems + tile_col(0);
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kRS);
    const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kRS + 16);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kRS);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kRS + 32);
    const float a[kThreadRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[kThreadCols] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < kThreadRows; ++i)
#pragma unroll
      for (int j = 0; j < kThreadCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] = C[m0 + tile_row(i), n0 + tile_col(j)], fp32, k summed in
// ascending order. Every thread of the block takes part; `smem` holds
// kStages stages (kBytes, 16-byte aligned).
template <int L, bool VEC>
__device__ __forceinline__ void mainloop(float (&acc)[kThreadRows][kThreadCols], float* smem,
                                         const Operands& p, int m0, int n0) {
#pragma unroll
  for (int i = 0; i < kThreadRows; ++i)
#pragma unroll
    for (int j = 0; j < kThreadCols; ++j) acc[i][j] = 0.f;

  const int steps = p.k > 0 ? (p.k + kBK - 1) / kBK : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage<L, VEC>(smem + s * kStageElems, p, m0, n0, s * kBK);
    mma::cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    // step ks has arrived, and every warp is done with the stage that step
    // ks + kStages - 1 now takes (it was read in the step before)
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = ks + kStages - 1;
    if (next < steps)
      load_stage<L, VEC>(smem + (next % kStages) * kStageElems, p, m0, n0, next * kBK);
    mma::cp_async_commit();
    stage_products(acc, smem + (ks % kStages) * kStageElems);
  }
  mma::cp_async_wait<0>();
}

}  // namespace sgemm
}  // namespace colxlip
