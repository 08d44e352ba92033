// Tile code the attention kernels share. bf16: the score tile both kernels
// that own query rows compute (the forward and the backward's dQ pass),
// S = scale * Q . K^T for a warp's 16 query rows against one key tile of 64,
// with dead pairs at -inf. fp32 (`attn32`): the register-blocked CUDA-core
// tile of all three fp32 kernels, described below.
#pragma once

#include "mma_tile.cuh"

namespace colxlip {
namespace mma {

// How many groups of 16 keys of the tile starting at key0 some row of the
// warp (query rows wrow .. wrow + 15) can see: none past n, none after the
// warp's last row under the causal mask, and none at all for a warp whose
// rows all lie past n. The products of the other groups are skipped.
__device__ __forceinline__ int live_key_groups(int key0, int wrow, int n, int causal) {
  int live = min(n - key0, kTileRows);
  if (causal) live = min(live, wrow + 16 - key0);
  return wrow < n ? (live + 15) >> 4 : 0;
}

// sc[16, 64] = scale * Q . K^T for the warp's Q fragments and the key tile
// at key0; pairs whose key is past n or, under the causal mask, after the
// query are -inf. The element test runs only in a tile that has such pairs.
template <int D>
__device__ __forceinline__ void score_tile(float (&sc)[8][4], const uint32_t (&qf)[D / 16][4],
                                           const bf16* ktile, int lane, int key0, int wrow,
                                           int n, int causal, float scale, int groups) {
  mma_abt<D>(sc, qf, ktile, lane, 0, groups);
  if (key0 + kTileRows > n || (causal && key0 + kTileRows - 1 > wrow)) {
    const int r0 = wrow + (lane >> 2), r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = key0 + nt * 8 + 2 * (lane & 3) + (i & 1);
        const bool dead = col >= n || (causal && col > (i < 2 ? r0 : r1));
        sc[nt][i] = dead ? -INFINITY : sc[nt][i] * scale;
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] *= scale;
  }
}

}  // namespace mma
}  // namespace colxlip

// ---- fp32: register-blocked CUDA-core tiles ---------------------------------
//
// The float32 attention kernels (the forward and both backward passes) share
// one tile shape: a block of kThreads (128) threads owns 64 rows (queries in
// the forward and the dQ pass, keys in the dK/dV pass) and walks the other
// side past in tiles of 64 rows, staged row-major in shared memory by 16-byte
// cp.async copies (rows past n zero-filled), each row padded to D + 4 floats.
// Thread (tx = threadIdx.x % 16, ty = threadIdx.x / 16) holds a register block
// of 8 rows x 4 columns of every 64 x 64 score tile:
//   rows     own_row(i) = 4 ty + (i % 4) + 32 (i / 4),   i = 0..7
//   columns  own_col(c) = tx + 16 c,                     c = 0..3
// so the 16 threads that share a row are one half-warp (row reductions are
// four xor shuffles, in a fixed pattern), and a group of 16 columns is one c.
//   abt:  C[64, 64] = A . B^T, both row-major [64, D] tiles: for each 4 k,
//         eight float4 of A (two distinct addresses a warp: one wavefront
//         each) and four float4 of B (16 rows whose strides put them on eight
//         bank groups: two wavefronts) feed 128 fmaf.
//   pb:   C[64, D] += A . B with A stored transposed, [64 k][64 rows] (kTS
//         apart), and B row-major [64 k, D]: for each k, two float4 of A (the
//         thread's rows) and one float4 (float2 at D = 32) of B (columns
//         (D / 16) tx ..) feed 32 fmaf (16).
// Each output element of either product is one fmaf chain in ascending k,
// from zero: two runs give the same bits. The transposed tile a thread reads
// in pb holds only rows of its own half-warp, written by that half-warp: it
// needs a __syncwarp, not a block barrier, between the write and the read.
namespace colxlip {
namespace attn32 {

constexpr int kRows = 64;
constexpr int kThreads = 128;
constexpr int kPad = 4;
constexpr int kTS = kRows + kPad;           // row stride of a transposed tile
constexpr int kTransposedFloats = kRows * kTS;

template <int D> __host__ __device__ constexpr int row_stride() { return D + kPad; }
template <int D> __host__ __device__ constexpr int tile_floats() { return kRows * row_stride<D>(); }

__device__ __forceinline__ int tx() { return threadIdx.x & 15; }
__device__ __forceinline__ int ty() { return threadIdx.x >> 4; }
__device__ __forceinline__ int own_row(int i) { return 4 * ty() + (i & 3) + 32 * (i >> 2); }
__device__ __forceinline__ int own_col(int c) { return tx() + 16 * c; }
// the smallest row of the warp's (rows 8 w .. 8 w + 7 and 32 + 8 w .. 32 + 8 w + 7)
__device__ __forceinline__ int warp_first_row() { return 8 * (threadIdx.x >> 5); }
__device__ __forceinline__ int warp_last_row() { return 32 + 8 * (threadIdx.x >> 5) + 7; }

// Rows row0 .. row0 + 63 of a [n, D] fp32 operand whose rows lie `stride`
// floats apart (16-byte aligned rows) into a row-major tile; rows at or past
// n are zero-filled. Every thread takes part; the caller commits.
template <int D>
__device__ __forceinline__ void stage_rows(float* tile, const float* src, size_t stride, int row0,
                                           int n) {
  constexpr int kVecs = D / 4;
  for (int idx = threadIdx.x; idx < kRows * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = idx - r * kVecs;
    const bool live = row0 + r < n;
    mma::cp_async_16(tile + r * row_stride<D>() + 4 * c,
                     src + size_t(live ? row0 + r : 0) * stride + 4 * c, live);
  }
}

// c = A . B^T over the thread's rows and its first G column groups (the
// others are left at zero).
template <int D, int G>
__device__ __forceinline__ void abt_groups(float (&c)[8][4], const float* a, const float* b) {
  constexpr int RS = row_stride<D>();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  const float* ar = a + (4 * ty()) * RS;
  const float* br = b + tx() * RS;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 av[8], bv[G];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(ar + ((i & 3) + 32 * (i >> 2)) * RS + k);
#pragma unroll
    for (int j = 0; j < G; ++j) bv[j] = *reinterpret_cast<const float4*>(br + 16 * j * RS + k);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        c[i][j] = fmaf(av[i].x, bv[j].x, c[i][j]);
        c[i][j] = fmaf(av[i].y, bv[j].y, c[i][j]);
        c[i][j] = fmaf(av[i].z, bv[j].z, c[i][j]);
        c[i][j] = fmaf(av[i].w, bv[j].w, c[i][j]);
      }
  }
}

// abt for the column groups 0 .. groups - 1 (1..4) that some row of the warp
// meets; a whole tile, the common case, runs the four-group body.
template <int D>
__device__ __forceinline__ void abt(float (&c)[8][4], const float* a, const float* b, int groups) {
  if (groups >= 4)
    abt_groups<D, 4>(c, a, b);
  else if (groups == 3)
    abt_groups<D, 3>(c, a, b);
  else if (groups == 2)
    abt_groups<D, 2>(c, a, b);
  else
    abt_groups<D, 1>(c, a, b);
}

// c[i][j] += sum over k in [k0, k1) of at[k][own_row(i)] * b[k][(D / 16) tx + j].
template <int D>
__device__ __forceinline__ void pb(float (&c)[8][D / 16], const float* at, const float* b, int k0,
                                   int k1) {
  constexpr int RS = row_stride<D>();
  const float* ar = at + 4 * ty();
  const float* br = b + (D / 16) * tx();
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(ar + k * kTS);
    const float4 a1 = *reinterpret_cast<const float4*>(ar + k * kTS + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    if constexpr (D == 64) {
      const float4 bv = *reinterpret_cast<const float4*>(br + k * RS);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i][0] = fmaf(a[i], bv.x, c[i][0]);
        c[i][1] = fmaf(a[i], bv.y, c[i][1]);
        c[i][2] = fmaf(a[i], bv.z, c[i][2]);
        c[i][3] = fmaf(a[i], bv.w, c[i][3]);
      }
    } else {
      const float2 bv = *reinterpret_cast<const float2*>(br + k * RS);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i][0] = fmaf(a[i], bv.x, c[i][0]);
        c[i][1] = fmaf(a[i], bv.y, c[i][1]);
      }
    }
  }
}

// Column c of the thread's block into the transposed tile: at[own_col(c)][own rows].
__device__ __forceinline__ void store_transposed(float* at, const float (&v)[8][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float* dst = at + own_col(c) * kTS + 4 * ty();
    *reinterpret_cast<float4*>(dst) = make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
    *reinterpret_cast<float4*>(dst + 32) = make_float4(v[4][c], v[5][c], v[6][c], v[7][c]);
  }
}

// Reductions over the 16 threads of a row (a half-warp), xor 1, 2, 4, 8:
// every thread ends with the same bits.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// How many column groups of the tile starting at col0 some row of the warp
// meets, for a block whose rows start at row0: none past n, none past the
// warp's last row under the causal mask (the columns are keys), none for a
// warp whose rows all lie past n.
__device__ __forceinline__ int live_cols(int col0, int row0, int n, int causal) {
  if (row0 + warp_first_row() >= n) return 0;
  int live = min(n - col0, kRows);
  if (causal) live = min(live, row0 + warp_last_row() + 1 - col0);
  return live;
}

// s = scale * raw with the dead pairs of the (query rows at row0, key columns
// at col0) tile at -inf: key past n, or key after query under the causal mask.
// The element test runs only in a tile that has such pairs.
__device__ __forceinline__ void scale_scores(float (&s)[8][4], int row0, int col0, int n,
                                             int causal, float scale) {
  if (col0 + kRows > n || (causal && col0 + kRows - 1 > row0)) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = col0 + own_col(c);
        const bool dead = key >= n || (causal && key > row0 + own_row(i));
        s[i][c] = dead ? -INFINITY : s[i][c] * scale;
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] *= scale;
  }
}

// The thread's 8 rows of a [64, D] fp32 result into rows row0.. of a
// row-major [n, .] array (rows `stride` floats apart); rows past n are
// not stored.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, size_t stride, int row0, int n,
                                           const float (&v)[8][D / 16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + own_row(i);
    if (r >= n) continue;
    float* p = dst + size_t(r) * stride + (D / 16) * tx();
    if constexpr (D == 64)
      *reinterpret_cast<float4*>(p) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(v[i][0], v[i][1]);
  }
}

}  // namespace attn32
}  // namespace colxlip
