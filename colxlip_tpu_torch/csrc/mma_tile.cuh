// bf16 tensor-core tiles for the port's CUDA kernels (sm_80 instructions,
// which Hopper runs): 16-byte cp.async staging into padded shared-memory
// tiles, ldmatrix fragment loads and mma.sync.m16n8k16 products with fp32
// accumulation. Written once here because every product of the attention
// kernels (and of any later tile kernel) is one of two shapes:
//
//   mma_abt:  C[16, 64] = A[16, D] . B[64, D]^T   both operands row-major,
//                                                 rows of D contiguous values
//   mma_pb:   C[16, D] += P[16, 64] . B[64, D]    P in registers, B row-major
//
// Shared-memory tile: kTileRows (64) rows of D bf16 values, each row padded to
// D + 8 elements. The row stride is then 16 bytes past a multiple of 32 or 128
// bytes (144 at D = 64, 80 at D = 32), so the eight 16-byte rows one ldmatrix
// phase reads lie in eight different 16-byte bank groups: no conflicts. The
// padding columns are never read.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// with g = lane / 4 (0..7) and t = lane % 4 (0..3); a 32-bit register holds
// two bf16 values, the lower column (or k) index in the low half:
//
//   A [16 x 16], row-major, 4 registers:
//     a0 = A[g    ][2t, 2t+1]      a1 = A[g + 8][2t, 2t+1]
//     a2 = A[g    ][2t+8, 2t+9]    a3 = A[g + 8][2t+8, 2t+9]
//   B [16 x 8] (k x n), "col": 2 registers:
//     b0 = B[k = 2t, 2t+1][n = g]  b1 = B[k = 2t+8, 2t+9][n = g]
//   C [16 x 8], 4 fp32 registers:
//     c0 = C[g][2t]  c1 = C[g][2t+1]  c2 = C[g + 8][2t]  c3 = C[g + 8][2t+1]
//
// So a thread's C values belong to rows g and g + 8, and a row's values are
// spread over the four lanes of a quad: a row reduction is the thread's own
// values, then __shfl_xor 1 and 2 (quad_max, quad_sum). Two adjacent n-tiles
// of C (columns 16j .. 16j+15) are, rounded to bf16 and packed in pairs,
// exactly the A fragment of k-step j of the next product (pack_a).
//
// ldmatrix.x4 loads four 8 x 8 matrices; lane l supplies the address of row
// l % 8 of matrix l / 8 and receives, in register j, the pair at row g,
// columns 2t, 2t+1 of matrix j (with .trans: rows 2t, 2t+1 of column g).
//   A from a row-major tile: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7),
//     (rows 0-7, k 8-15), (rows 8-15, k 8-15): lane address row l % 16,
//     column 8 * (l / 16).
//   B of mma_abt (B[k][n] = tile[n][k], n-major with k contiguous, no .trans):
//     matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15,
//     k 8-15) give b0, b1 of two n-tiles: lane address row
//     l % 8 + 8 * (l / 16), column 8 * ((l / 8) % 2).
//   B of mma_pb (B[k][n] = tile[k][n], k-major with n contiguous, .trans):
//     matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15,
//     n 8-15) give b0, b1 of two n-tiles: lane address row l % 16, column
//     8 * (l / 16).
//   A from a k-major tile (A[m][k] = tile[k][m], m contiguous, .trans): with
//     .trans register j holds tile rows 2t, 2t+1 of column g of matrix j,
//     which is A[g][2t, 2t+1] of that matrix. So matrices (k 0-7, m 0-7),
//     (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15) give a0 .. a3: lane
//     address row (k) l % 8 + 8 * (l / 16), column (m) 8 * ((l / 8) % 2),
//     the address pattern of B of mma_abt on the transposed tile.
//
// The four loaders below (ldm_a, ldm_a_trans, ldm_b, ldm_b_trans) take any
// row stride and are what the MLP GEMM tile (mlp_gemm.cuh) uses;
// mma_tile_check.cu holds each against torch.matmul.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace colxlip {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;

template <int D> __host__ __device__ constexpr int row_stride() { return D + 8; }
// elements in one shared-memory tile
template <int D> __host__ __device__ constexpr int tile_elems() { return kTileRows * (D + 8); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of 16 bytes from device memory to shared memory (both
// 16-byte aligned), bypassing L1. When `live` is false nothing is read and
// the 16 bytes are filled with zeros (`src` must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool live) {
  const int bytes = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}

// The same for one 4-byte word.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool live) {
  const int bytes = live ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b for one 16 x 8 x 16 tile, bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment loaders with a row stride `rs` (elements; rows 16-byte aligned).
// A of one 16 x 16 step from a row-major tile: `p` at (m0, k0).
__device__ __forceinline__ void ldm_a(uint32_t (&a)[4], const bf16* p, int rs, int lane) {
  ldmatrix_x4(a, p + (lane & 15) * rs + (lane >> 4) * 8);
}

// A of one 16 x 16 step from a k-major tile (tile[k][m]): `p` at (k0, m0).
__device__ __forceinline__ void ldm_a_trans(uint32_t (&a)[4], const bf16* p, int rs, int lane) {
  ldmatrix_x4_trans(a, p + ((lane & 7) + ((lane >> 4) << 3)) * rs + ((lane >> 3) & 1) * 8);
}

// B of two n-tiles (16 columns) of one k-step from an n-major tile
// (tile[n][k], k contiguous): `p` at (n0, k0); b[0], b[1] are n-tile 0's
// b0, b1 and b[2], b[3] n-tile 1's.
__device__ __forceinline__ void ldm_b(uint32_t (&b)[4], const bf16* p, int rs, int lane) {
  ldmatrix_x4(b, p + ((lane & 7) + ((lane >> 4) << 3)) * rs + ((lane >> 3) & 1) * 8);
}

// The same from a k-major tile (tile[k][n], n contiguous): `p` at (k0, n0).
__device__ __forceinline__ void ldm_b_trans(uint32_t (&b)[4], const bf16* p, int rs, int lane) {
  ldmatrix_x4_trans(b, p + (lane & 15) * rs + (lane >> 4) * 8);
}

// c += a . b, with a . b taken by one mma from a zero accumulator and added
// by fp32 adds that round to nearest. An mma that accumulates into c truncates
// the products to c's last bit, so over a long K its sums drift from an IEEE
// fp32 sum's by up to a step of c a k-step; taken from zero, the products
// lose bits only against each other. On the H100 this cut the MLP outputs
// that differ from an fp32 sgemm's 3.5 times (a W2 at the vision shape).
__device__ __forceinline__ void mma_16816_rn(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage rows row0 .. row0 + 63 of a [n, D] operand, whose rows lie `stride`
// elements apart in device memory, into a tile. Rows at or past n are filled
// with zeros, never left stale: a masked probability of 0 times an Inf or NaN
// bit pattern would be NaN inside an mma. Every thread of the block takes
// part; the caller commits the group.
template <int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, size_t stride, int row0,
                                          int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < kTileRows * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool live = row0 + r < n;
    cp_async_16(tile + r * row_stride<D>() + c * 8,
                src + size_t(live ? row0 + r : 0) * stride + c * 8, live);
  }
}

// A fragments of 16 tile rows (rows points at the first), every k-step.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* rows, int lane) {
  const bf16* p = rows + (lane & 15) * row_stride<D>() + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(a[kk], p + kk * 16);
}

template <int D, bool WHOLE>
__device__ __forceinline__ void mma_abt_groups(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                               const bf16* b, int lane, int lo, int hi) {
  const bf16* p = b + ((lane & 7) + ((lane >> 4) << 3)) * row_stride<D>() + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (!WHOLE && (np < lo || np >= hi)) continue;
      uint32_t r[4];
      ldmatrix_x4(r, p + np * 16 * row_stride<D>() + kk * 16);
      mma_16816(c[2 * np], a[kk], r[0], r[1]);
      mma_16816(c[2 * np + 1], a[kk], r[2], r[3]);
    }
  }
}

// c[16, 64] = A[16, D] . B[64, D]^T: c[nt] is the n-tile of columns
// 8 nt .. 8 nt + 7 (rows of the B tile). Only the column groups of 16
// lo .. hi - 1 (of 0 .. 3) are computed, the rest of c is 0: a caller that
// knows which rows of B are dead for this warp (past N, or masked) skips
// their products. lo and hi must be the same in every lane. The whole tile
// (the common case) is one branch-free block of 8 D / 16 mma that the compiler
// schedules freely; a partial tile tests each group.
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* b, int lane, int lo = 0, int hi = 4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
  if (lo == 0 && hi == 4)
    mma_abt_groups<D, true>(c, a, b, lane, lo, hi);
  else
    mma_abt_groups<D, false>(c, a, b, lane, lo, hi);
}

// The [16, 64] accumulator of mma_abt, rounded to bf16, as the A fragments of
// the four k-steps of mma_pb.
__device__ __forceinline__ void pack_a(uint32_t (&p)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    p[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    p[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    p[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

template <int D, bool WHOLE>
__device__ __forceinline__ void mma_pb_steps(float (&c)[D / 8][4], const uint32_t (&p)[4][4],
                                             const bf16* b, int lane, int lo, int hi) {
  const bf16* q = b + (lane & 15) * row_stride<D>() + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!WHOLE && (j < lo || j >= hi)) continue;
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, q + j * 16 * row_stride<D>() + np * 16);
      mma_16816(c[2 * np], p[j], r[0], r[1]);
      mma_16816(c[2 * np + 1], p[j], r[2], r[3]);
    }
  }
}

// c[16, D] += P[16, 64] . B[64, D]: c[nt] is the n-tile of columns
// 8 nt .. 8 nt + 7 (columns of the B tile). Only the k-steps lo .. hi - 1
// (groups of 16 columns of P and rows of B, of 0 .. 3) are multiplied: where
// P is 0 by construction the caller skips them.
template <int D>
__device__ __forceinline__ void mma_pb(float (&c)[D / 8][4], const uint32_t (&p)[4][4],
                                       const bf16* b, int lane, int lo = 0, int hi = 4) {
  if (lo == 0 && hi == 4)
    mma_pb_steps<D, true>(c, p, b, lane, lo, hi);
  else
    mma_pb_steps<D, false>(c, p, b, lane, lo, hi);
}

// Rows g and g + 8 of a [16, D] accumulator to device memory as bf16: `row`
// points at column 0 of row g, `stride8` elements on to row g + 8; `live0`,
// `live1` say which of the two rows exist.
template <int D>
__device__ __forceinline__ void store_rows(bf16* row, size_t stride8, const float (&c)[D / 8][4],
                                           bool live0, bool live1, int lane) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (live0)
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8 + col) =
          __floats2bfloat162_rn(c[nt][0], c[nt][1]);
    if (live1)
      *reinterpret_cast<__nv_bfloat162*>(row + stride8 + nt * 8 + col) =
          __floats2bfloat162_rn(c[nt][2], c[nt][3]);
  }
}

}  // namespace mma
}  // namespace colxlip
