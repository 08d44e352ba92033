// The score tile both attention kernels that own query rows compute (the
// forward and the backward's dQ pass): S = scale * Q . K^T for a warp's 16
// query rows against one key tile of 64, with dead pairs at -inf.
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
