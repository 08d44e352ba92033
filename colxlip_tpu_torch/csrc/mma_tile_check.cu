// A bare 64 x 64 x 64 product through the building blocks of mma_tile.cuh, so
// that the fragment layouts written down there can be held against
// torch.matmul on the card before any kernel built from them is trusted.
//
// One block of four warps, a warp owns 16 rows of A. From A [64, 64] and
// B [64, 64] (bf16, row-major) it writes
//   c_abt = A . B^T                      (load_tile, load_a, mma_abt), and
//   c_pb  = bf16(A . B^T) . B            (pack_a, mma_pb), and
//   c_tn  = A^T . B                      (ldm_a_trans, ldm_b_trans: the tile
//                                         read k-major, as the MLP's weight-
//                                         gradient products read theirs),
// all [64, 64] fp32. `rows` (1..64) says how many rows of A and B exist: the
// rest must arrive as zeros (load_tile's zero fill).

#include "mma_tile.cuh"

namespace {

namespace mma = colxlip::mma;
using mma::bf16;

constexpr int D = 64;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mma_tile_check_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                      float* __restrict__ c_abt, float* __restrict__ c_pb,
                      float* __restrict__ c_tn, int rows) {
  __shared__ __align__(16) bf16 as[mma::tile_elems<D>()];
  __shared__ __align__(16) bf16 bs[mma::tile_elems<D>()];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  mma::load_tile<D, kThreads>(as, a, D, 0, rows);
  mma::load_tile<D, kThreads>(bs, b, D, 0, rows);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  uint32_t af[D / 16][4];
  float c[8][4];
  mma::load_a<D>(af, as + warp * 16 * mma::row_stride<D>(), lane);
  mma::mma_abt<D>(c, af, bs, lane);
  uint32_t pf[4][4];
  mma::pack_a(pf, c);
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
  mma::mma_pb<D>(o, pf, bs, lane);

  // rows warp * 16 .. + 15 of A^T . B: the k-steps walk the tiles' rows
  float tn[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) tn[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t at[4];
    mma::ldm_a_trans(at, as + kk * 16 * mma::row_stride<D>() + warp * 16, mma::row_stride<D>(),
                     lane);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bt[4];
      mma::ldm_b_trans(bt, bs + kk * 16 * mma::row_stride<D>() + np * 16, mma::row_stride<D>(),
                       lane);
      mma::mma_16816(tn[2 * np], at, bt[0], bt[1]);
      mma::mma_16816(tn[2 * np + 1], at, bt[2], bt[3]);
    }
  }

  const int r0 = warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i < 2 ? 0 : 8), col = nt * 8 + 2 * t + (i & 1);
      c_abt[row * D + col] = c[nt][i];
      c_pb[row * D + col] = o[nt][i];
      c_tn[row * D + col] = tn[nt][i];
    }
  }
}

}  // namespace

// a, b: bf16 [64, 64] (16-byte aligned); c_abt, c_pb, c_tn: float32 [64, 64].
// Returns a cudaError_t (0 = launched).
extern "C" int colxlip_mma_tile_check(const void* a, const void* b, void* c_abt, void* c_pb,
                                      void* c_tn, int rows, void* stream) {
  if (rows < 1 || rows > 64) return cudaErrorInvalidValue;
  mma_tile_check_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(c_abt),
      static_cast<float*>(c_pb), static_cast<float*>(c_tn), rows);
  return cudaGetLastError();
}
