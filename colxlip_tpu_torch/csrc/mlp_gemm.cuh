// The bf16 GEMM tile of the fused MLP (csrc/fused_mlp.cu): every product of
// the MLP's forward and backward runs through this one main loop, with an
// epilogue chosen by the caller.
//
// A block computes a C tile of kBM x BN (128 x 128 or 128 x 64) of
//   C[m, n] = sum over k of A(m, k) B(k, n)
// with 8 warps, each owning kWM rows and kWarpN (32) columns in
// mma.sync.m16n8k16 accumulators (bf16 operands, fp32 sums; the fragment
// layouts are in mma_tile.cuh). K walks past in steps of kBK (64) through a
// ring of kStages (3) shared-memory stages filled by 16-byte cp.async; the
// copies of the next two steps are in flight under the products of this one.
// Pieces past M, N or K are zero-filled, never read.
//
// Three operand layouts, one for each shape of product the MLP has:
//   kNT  A [M, K] row-major, B [N, K] row-major   x W1^T, dy W2^T
//   kNN  A [M, K] row-major, B [K, N] row-major   a W2, dh W1
//   kTN  A [K, M] row-major, B [K, N] row-major   a^T dy, dh^T x
// A row-major operand is staged as it lies ([rows][kBK + 8]); a k-major one
// as [kBK][cols + 8]. The padding puts the eight 16-byte rows of one
// ldmatrix phase in eight different bank groups (144 or 272 bytes a row).
// The k-major A of kTN is read with ldmatrix.trans (mma_tile.cuh
// ldm_a_trans), as the k-major B of kNN and kTN is.
//
// Every row of every operand must start on 16 bytes: M, N and K need not be
// multiples of anything, but the row lengths as stored (lda, ldb) must be
// multiples of 8 elements and the bases 16-byte aligned, and a k-major
// operand's M or N must be a multiple of 8 (a 16-byte piece is wholly live or
// wholly past the end).
#pragma once

#include <stdint.h>

#include "mma_tile.cuh"

namespace colxlip {
namespace mlp_gemm {

using mma::bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 128;     // rows of C a block
constexpr int kBK = 64;      // k a stage
constexpr int kStages = 3;
constexpr int kWarpN = 32;   // columns of C a warp
constexpr int kPad = 8;      // elements of padding a staged row

enum Layout { kNT = 0, kNN = 1, kTN = 2 };

template <int L, int BN>
struct Tile {
  static_assert(BN == 64 || BN == 128, "a block is 128 x 64 or 128 x 128");
  static constexpr bool kAKMajor = L == kTN;
  static constexpr bool kBKMajor = L != kNT;
  static constexpr int kARS = kAKMajor ? kBM + kPad : kBK + kPad;   // row strides
  static constexpr int kBRS = kBKMajor ? BN + kPad : kBK + kPad;
  static constexpr int kAElems = kAKMajor ? kBK * kARS : kBM * kARS;
  static constexpr int kBElems = kBKMajor ? kBK * kBRS : BN * kBRS;
  static constexpr int kStage = kAElems + kBElems;
  static constexpr size_t kBytes = size_t(kStages) * kStage * sizeof(bf16);
  static constexpr int kWarpsN = BN / kWarpN;          // 4 or 2
  static constexpr int kWarpsM = kWarps / kWarpsN;     // 2 or 4
  static constexpr int kWM = kBM / kWarpsM;            // rows a warp: 64 or 32
  static constexpr int kMI = kWM / 16;                 // m16 tiles a warp
  static constexpr int kNI = kWarpN / 8;               // n8 tiles a warp
};

// One product's operands: A and B as stored, rows lda / ldb elements apart.
struct Operands {
  const bf16* a;
  const bf16* b;
  int lda, ldb;
  int m, n, k;
};

// Rows r0 .. r0 + ROWS - 1 of a row-major operand [*, ld], elements
// c0 .. c0 + COLS - 1 of each, into a tile of row stride RS. A piece is live
// if its row is below `rows` and its first element below `cols`.
template <int ROWS, int COLS, int RS>
__device__ __forceinline__ void stage_piece_rows(bf16* dst, const bf16* __restrict__ src, int ld,
                                                 int r0, int rows, int c0, int cols) {
  constexpr int P = COLS / 8;
#pragma unroll
  for (int i = 0; i < ROWS * P / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / P, c = (idx - r * P) * 8;
    const bool live = r0 + r < rows && c0 + c < cols;
    mma::cp_async_16(dst + r * RS + c, live ? src + size_t(r0 + r) * ld + c0 + c : src, live);
  }
}

// Stage k-step k0 of the block's tile (m0, n0); the caller commits.
template <int L, int BN>
__device__ __forceinline__ void load_stage(bf16* s, const Operands& p, int m0, int n0, int k0) {
  using T = Tile<L, BN>;
  if constexpr (T::kAKMajor)
    stage_piece_rows<kBK, kBM, T::kARS>(s, p.a, p.lda, k0, p.k, m0, p.m);
  else
    stage_piece_rows<kBM, kBK, T::kARS>(s, p.a, p.lda, m0, p.m, k0, p.k);
  if constexpr (T::kBKMajor)
    stage_piece_rows<kBK, BN, T::kBRS>(s + T::kAElems, p.b, p.ldb, k0, p.k, n0, p.n);
  else
    stage_piece_rows<BN, kBK, T::kBRS>(s + T::kAElems, p.b, p.ldb, n0, p.n, k0, p.k);
}

// The products of one stage into the warp's accumulators: acc[mi][ni] is the
// m16 x n8 tile at rows wm * kWM + 16 mi, columns wn * 32 + 8 ni of the block;
// the mma accumulates in place.
template <int L, int BN>
__device__ __forceinline__ void stage_products(float (&acc)[Tile<L, BN>::kMI][4][4],
                                               const bf16* s, int wm, int wn, int lane) {
  using T = Tile<L, BN>;
  const bf16* as = s;
  const bf16* bs = s + T::kAElems;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t af[T::kMI][4];
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi) {
      const int m = wm * T::kWM + mi * 16;
      if constexpr (T::kAKMajor)
        mma::ldm_a_trans(af[mi], as + kk * 16 * T::kARS + m, T::kARS, lane);
      else
        mma::ldm_a(af[mi], as + m * T::kARS + kk * 16, T::kARS, lane);
    }
#pragma unroll
    for (int nj = 0; nj < T::kNI / 2; ++nj) {
      const int n = wn * kWarpN + nj * 16;
      uint32_t bf[4];
      if constexpr (T::kBKMajor)
        mma::ldm_b_trans(bf, bs + kk * 16 * T::kBRS + n, T::kBRS, lane);
      else
        mma::ldm_b(bf, bs + n * T::kBRS + kk * 16, T::kBRS, lane);
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi) {
        mma::mma_16816(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
        mma::mma_16816(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

// acc = the warp's part of C[m0 .. m0 + 127, n0 .. n0 + BN - 1], fp32, with
// k summed in steps of kBK in ascending order. Every thread of the block
// takes part; `smem` holds kStages stages (Tile::kBytes).
template <int L, int BN>
__device__ __forceinline__ void mainloop(float (&acc)[Tile<L, BN>::kMI][4][4], bf16* smem,
                                         const Operands& p, int m0, int n0) {
  using T = Tile<L, BN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;

  const int steps = (p.k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage<L, BN>(smem + s * T::kStage, p, m0, n0, s * kBK);
    mma::cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    // step ks has arrived, and every warp is done with the stage that step
    // ks + kStages - 1 now takes (it was read in the step before)
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = ks + kStages - 1;
    if (next < steps) load_stage<L, BN>(smem + (next % kStages) * T::kStage, p, m0, n0, next * kBK);
    mma::cp_async_commit();
    stage_products<L, BN>(acc, smem + (ks % kStages) * T::kStage, wm, wn, lane);
  }
  mma::cp_async_wait<0>();
}

}  // namespace mlp_gemm
}  // namespace colxlip
