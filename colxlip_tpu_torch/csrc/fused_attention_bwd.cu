// Packed-QKV multi-head self-attention, backward, for Hopper (sm_90a).
//
// Replaces: colxlip_tpu/ops/fused_attention.py `_bwd_call` (:387), whose TPU
// body is the Pallas `_bwd_kernel` (:115), and `_bwd_call_heads` (:308), the
// same function on a head-pair grid. Same contract: the only residual is qkv
// [B, N, 3*H*D]; dout is [B, N, H*D]; dqkv comes out packed as
// [B, N, 3*H*D] (dQ | dK | dV), ready for the in_proj backward. P is
// recomputed from Q and K: no [B, H, N, N] tensor in device memory.
//
// Numerics follow the TPU kernel: s = Q.K^T * scale in fp32 (causal mask
// col <= row), p = softmax(s) normalised in fp32, dp = dO.V^T in fp32,
// delta = rowsum(p * dp), dz = p * (dp - delta) * scale rounded to the input
// dtype, dV = p (rounded to the input dtype)^T . dO, dQ = dz . K,
// dK = dz^T . Q, each accumulated in fp32 and rounded to the input dtype once.
//
// What bounds it on the H100: the function needs five N^2 D products a
// (batch row, head) against 4 N D values in and 3 N D out. At the vision
// shape (B=256, N=197, H=12, D=64, bf16) that is 76 GFLOP (77 us at the
// tensor cores' 989 TFLOP/s) over 0.54 GB (162 us at 3.35 TB/s): bound by
// bytes if the products run on the tensor cores, and by operations (over a
// millisecond) if they run on the CUDA cores.
//
// Design, bf16 inputs: every product is an mma.sync.m16n8k16 tile
// (csrc/mma_tile.cuh holds the layouts and the two product shapes), operands
// staged by 16-byte cp.async copies into double-buffered padded shared-memory
// tiles of 64 rows, so there is no limit on N. Two kernels on the stream and
// a [3, B, H, N] fp32 scratch between them; no atomics anywhere, so two runs
// give the same bits.
//   1. `attn_bwd_dq_mma_kernel`, one block of four warps per (query tile of
//      64, head, batch row), a warp owns 16 query rows and holds their Q and
//      dO fragments. K and V walk past in key tiles, three times:
//        sweep 1: S                      -> row max m;
//        sweep 2: S and dP = dO . V^T    -> e = expf(s - m), l += e,
//                                           u += e * dp; then delta = u / l;
//        sweep 3: S and dP               -> dz = bf16(e / l * (dp - delta)
//                                           * scale), dQ += dz . K.
//      Six N^2 D products. It stores m, 1 / l and delta of its rows.
//   2. `attn_bwd_dkv_mma_kernel`, one block per (key tile of 64, head, batch
//      row), a warp owns 16 keys; Q, dO and the three statistics walk past in
//      query tiles (from the diagonal tile on when causal). It computes the
//      transposed tiles S^T = K . Q^T and dP^T = V . dO^T, so that bf16(p)^T
//      and dz^T come out of the accumulators in the A-operand layout of
//      dV += bf16(p)^T . dO and dK += dz^T . Q. Four products.
// Ten N^2 D products instead of the function's five: 152 GFLOP at the vision
// shape, a sixth of a millisecond at the tensor cores' peak, which buys a
// kernel that keeps nothing but 64-row tiles on the chip and rounds where the
// contract rounds. Rows of a tile past N are zero-filled in shared memory (a
// masked 0 times a stale NaN pattern would be NaN); dead pairs (key or query
// past N, or key > query under the causal mask) get p = dz = 0 by selection,
// not by multiplication; rows past N are computed and not stored. As in the
// forward kernel a warp multiplies only the groups of 16 keys (dQ pass) or
// queries (dK/dV pass) that its rows meet, a whole tile runs branch-free, and
// one barrier a step serves arrival and reuse. Both passes hold 168-170
// registers a thread (two or three 16 x 64 fp32 tiles and an accumulator or
// two), so three blocks of four warps are resident an SM; forcing four spills
// 300-400 bytes and measured 31% slower. wgmma and TMA are not used, for the
// reason given in fused_attention.cu.
//
// Design, fp32 inputs: the bf16 path's two passes and scratch, on the
// register-blocked CUDA-core tile of attention_tile.cuh `attn32` (8 x 4
// elements of each 64 x 64 score tile a thread, float4 reads of row-major
// tiles; fp32 FMAs only, for the reason given in fused_attention.cu). Both
// stream 64-row tiles, so there is no limit on N; no atomics, so two runs
// give the same bits.
//   1. `attn_bwd_dq_fp32_kernel`, one block of 128 threads per (query tile of
//      64, head, batch row); Q and dO staged once, K and V double-buffered,
//      swept twice:
//        sweep A: S and dP = dO . V^T -> the online max m, l and
//                 u = sum e dp, both rescaled by expf(m_old - m_new) as in
//                 the forward; at its end 1 / l and delta = u / l;
//        sweep B: S and dP again -> p = expf(s - m) / l,
//                 dz = p (dp - delta) scale, dQ += dz . K.
//      Five N^2 D products. dz^T goes through the V tile the step has just
//      read (one barrier more a step), which keeps two blocks an SM.
//   2. `attn_bwd_dkv_fp32_kernel`, one block per (key tile of 64, head, batch
//      row); K and V staged once, Q, dO and the statistics streamed one tile
//      at a time (from the diagonal tile when causal): S^T = K . Q^T and
//      dP^T = V . dO^T, p and dz rebuilt from the statistics (0 for dead
//      pairs by selection), dV += p^T . dO and dK += dz^T . Q. Four products.
// Nine N^2 D products against the function's five (the bf16 path runs ten).
// Shared memory 104,448 and 105,216 bytes at D = 64, two blocks of four warps
// an SM; 230 and 254 registers, no spills. What limits it as measured on the
// H100 (PERF.md section 6): the passes run at 41% and 42% of the fp32 FMA peak
// at ViT-L's 257 tokens, counting the ragged tiles they multiply, held back
// as the forward is. One buffer of K and V in the dQ pass (three blocks an
// SM, 168 registers) spilled 120 bytes and measured 3-6% slower. Partial dQ
// tiles written by the dK/dV pass would take two products off, for scratch
// of N / 64 copies of dQ: not built. Each entry point returns
// cudaGetLastError() so a refused launch is reported.

#include "attention_tile.cuh"

namespace {

namespace mma = colxlip::mma;
using mma::bf16;

constexpr int kRowsPerBlock = 64;

// ---- bf16: tensor-core tiles -------------------------------------------------

// four warps of 16 rows, as in the forward kernel (fused_attention.cu says why)
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;

// dQ pass: Q and dO tiles, two K and two V tiles.
template <int D>
constexpr size_t smem_dq_mma() { return 6 * size_t(mma::tile_elems<D>()) * sizeof(bf16); }

// dK/dV pass: K and V tiles, two Q and two dO tiles, two sets of the three
// statistics of 64 query rows.
template <int D>
constexpr size_t smem_dkv_mma() {
  return smem_dq_mma<D>() + 2 * 3 * kRowsPerBlock * sizeof(float);
}

// Pass 1: dQ and the per-row statistics (max, 1 / sum, delta).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
attn_bwd_dq_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                       bf16* __restrict__ dqkv, float* __restrict__ stats, int n, int heads,
                       int causal, float scale) {
  constexpr int RS = mma::row_stride<D>();
  constexpr int TILE = mma::tile_elems<D>();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int hd = heads * D;
  const size_t tok = 3 * size_t(hd);
  const bf16* qg = qkv + size_t(b) * n * tok + h * D;
  const bf16* kg = qg + hd;
  const bf16* vg = qg + 2 * hd;
  const bf16* dog = dout + size_t(b) * n * hd + h * D;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + TILE;
  bf16* ks = dos + TILE;     // two buffers
  bf16* vs = ks + 2 * TILE;  // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = causal ? blockIdx.x + 1 : (n + mma::kTileRows - 1) / mma::kTileRows;
  const int steps = 3 * tiles;

  mma::load_tile<D, kMmaThreads>(qs, qg, tok, row0, n);
  mma::load_tile<D, kMmaThreads>(dos, dog, hd, row0, n);
  mma::load_tile<D, kMmaThreads>(ks, kg, tok, 0, n);
  mma::cp_async_commit();

  const int wrow = row0 + warp * 16;           // the warp's first query row
  const int r0 = wrow + g, r1 = r0 + 8;        // this thread's two query rows
  uint32_t qf[D / 16][4], dof[D / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
  float il0 = 0.f, il1 = 0.f, delta0 = 0.f, delta1 = 0.f;
  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[nt][i] = 0.f;

  int sweep = 0, tile = 0;
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    // This step's tiles have arrived, and every warp is done with the other
    // buffer (it read it in the step before): one barrier serves both, then
    // the next tiles' copies run under this step's products.
    mma::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < steps) {
      const int next = tile + 1 < tiles ? tile + 1 : 0;
      const bool next_v = sweep > 0 || tile + 1 == tiles;  // sweeps 2 and 3 read V
      mma::load_tile<D, kMmaThreads>(ks + (buf ^ 1) * TILE, kg, tok, next * mma::kTileRows, n);
      if (next_v)
        mma::load_tile<D, kMmaThreads>(vs + (buf ^ 1) * TILE, vg, tok, next * mma::kTileRows, n);
      mma::cp_async_commit();
    }
    if (s == 0) {
      mma::load_a<D>(qf, qs + warp * 16 * RS, lane);
      mma::load_a<D>(dof, dos + warp * 16 * RS, lane);
    }

    const int key0 = tile * mma::kTileRows;
    const int groups = mma::live_key_groups(key0, wrow, n, causal);
    if (groups > 0) {
      float sc[8][4];
      mma::score_tile<D>(sc, qf, ks + buf * TILE, lane, key0, wrow, n, causal, scale, groups);
      if (sweep == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          m0 = fmaxf(m0, fmaxf(sc[nt][0], sc[nt][1]));
          m1 = fmaxf(m1, fmaxf(sc[nt][2], sc[nt][3]));
        }
      } else {
        float dp[8][4];
        mma::mma_abt<D>(dp, dof, vs + buf * TILE, lane, 0, groups);
        if (sweep == 1) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float e0 = expf(sc[nt][i] - m0), e1 = expf(sc[nt][2 + i] - m1);
              l0 += e0;
              l1 += e1;
              u0 = fmaf(e0, dp[nt][i], u0);
              u1 = fmaf(e1, dp[nt][2 + i], u1);
            }
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float p0 = expf(sc[nt][i] - m0) * il0, p1 = expf(sc[nt][2 + i] - m1) * il1;
              sc[nt][i] = p0 * (dp[nt][i] - delta0) * scale;
              sc[nt][2 + i] = p1 * (dp[nt][2 + i] - delta1) * scale;
            }
          }
          uint32_t zf[4][4];
          mma::pack_a(zf, sc);
          mma::mma_pb<D>(dq, zf, ks + buf * TILE, lane, 0, groups);
        }
      }
    }
    if (++tile == tiles) {  // end of a sweep, whether or not this warp saw its last tile
      if (sweep == 0) {
        m0 = mma::quad_max(m0);
        m1 = mma::quad_max(m1);
      } else if (sweep == 1) {
        il0 = 1.f / mma::quad_sum(l0);
        il1 = 1.f / mma::quad_sum(l1);
        delta0 = mma::quad_sum(u0) * il0;
        delta1 = mma::quad_sum(u1) * il1;
      }
      tile = 0;
      ++sweep;
    }
  }

  bf16* dqrow = dqkv + (size_t(b) * n + r0) * tok + h * D;
  mma::store_rows<D>(dqrow, 8 * tok, dq, r0 < n, r1 < n, lane);
  if (t == 0) {
    const size_t plane = size_t(gridDim.z) * heads * n;
    float* row_max = stats + (size_t(b) * heads + h) * n;
    if (r0 < n) {
      row_max[r0] = m0;
      row_max[plane + r0] = il0;
      row_max[2 * plane + r0] = delta0;
    }
    if (r1 < n) {
      row_max[r1] = m1;
      row_max[plane + r1] = il1;
      row_max[2 * plane + r1] = delta1;
    }
  }
}

// Pass 2: dK and dV from p and dz rebuilt with pass 1's statistics.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
attn_bwd_dkv_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                        bf16* __restrict__ dqkv, const float* __restrict__ stats, int n,
                        int heads, int causal, float scale) {
  constexpr int RS = mma::row_stride<D>();
  constexpr int TILE = mma::tile_elems<D>();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * kRowsPerBlock;
  const int hd = heads * D;
  const size_t tok = 3 * size_t(hd);
  const bf16* qg = qkv + size_t(b) * n * tok + h * D;
  const bf16* kg = qg + hd;
  const bf16* vg = qg + 2 * hd;
  const bf16* dog = dout + size_t(b) * n * hd + h * D;
  const size_t plane = size_t(gridDim.z) * heads * n;
  const float* row_stats = stats + (size_t(b) * heads + h) * n;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE;
  bf16* qs = vs + TILE;       // two buffers
  bf16* dos = qs + 2 * TILE;  // two buffers
  float* st = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][3][64]: max, 1 / sum, delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (n + mma::kTileRows - 1) / mma::kTileRows;
  // a key j only meets queries i >= j when causal: start at the diagonal tile
  const int first = causal ? blockIdx.x : 0;

  // query tile `tile` into buffer `buf`: Q, dO and the statistics (zeros for
  // rows past n, which the selection below never uses)
  auto load_queries = [&](int tile, int buf) {
    const int q0 = tile * mma::kTileRows;
    mma::load_tile<D, kMmaThreads>(qs + buf * TILE, qg, tok, q0, n);
    mma::load_tile<D, kMmaThreads>(dos + buf * TILE, dog, hd, q0, n);
    for (int idx = threadIdx.x; idx < 3 * mma::kTileRows; idx += kMmaThreads) {
      const int which = idx / mma::kTileRows, q = q0 + idx - which * mma::kTileRows;
      const bool live = q < n;
      mma::cp_async_4(st + buf * 3 * mma::kTileRows + idx,
                      row_stats + which * plane + (live ? q : 0), live);
    }
  };

  mma::load_tile<D, kMmaThreads>(ks, kg, tok, col0, n);
  mma::load_tile<D, kMmaThreads>(vs, vg, tok, col0, n);
  load_queries(first, 0);
  mma::cp_async_commit();

  const int wkey = col0 + warp * 16;           // the warp's first key
  const int k0 = wkey + g, k1 = k0 + 8;        // this thread's two keys
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nt][i] = dv[nt][i] = 0.f;

  for (int tile = first; tile < tiles; ++tile) {
    const int buf = (tile - first) & 1;
    // one barrier a tile, as in the dQ pass
    mma::cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < tiles) {
      load_queries(tile + 1, buf ^ 1);
      mma::cp_async_commit();
    }

    const int q0 = tile * mma::kTileRows;
    const float* ms = st + buf * 3 * mma::kTileRows;
    const float* ils = ms + mma::kTileRows;
    const float* deltas = ils + mma::kTileRows;
    // queries of this tile that some key of the warp meets, in groups of 16:
    // none past n and, under the causal mask, none before the warp's first key
    const int hi = wkey < n ? (min(n - q0, mma::kTileRows) + 15) >> 4 : 0;
    const int lo = causal && wkey > q0 ? (wkey - q0) >> 4 : 0;
    if (lo < hi) {
      uint32_t af[D / 16][4];
      float sc[8][4], dp[8][4];
      mma::load_a<D>(af, ks + warp * 16 * RS, lane);
      mma::mma_abt<D>(sc, af, qs + buf * TILE, lane, lo, hi);   // S^T: [16 keys, 64 queries]
      mma::load_a<D>(af, vs + warp * 16 * RS, lane);
      mma::mma_abt<D>(dp, af, dos + buf * TILE, lane, lo, hi);  // dP^T
      // dead pairs exist only in a ragged query or key tile and where a key of
      // the warp comes after a query of the tile
      const bool edge = q0 + mma::kTileRows > n || wkey + 16 > n || (causal && wkey + 15 > q0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = nt * 8 + 2 * t + (i & 1);
          const int q = q0 + c;
          const int key = i < 2 ? k0 : k1;
          const bool dead = edge && (q >= n || key >= n || (causal && key > q));
          const float p = dead ? 0.f : expf(sc[nt][i] * scale - ms[c]) * ils[c];
          sc[nt][i] = p;
          dp[nt][i] = dead ? 0.f : p * (dp[nt][i] - deltas[c]) * scale;
        }
      }
      uint32_t pf[4][4];
      mma::pack_a(pf, sc);
      mma::mma_pb<D>(dv, pf, dos + buf * TILE, lane, lo, hi);
      mma::pack_a(pf, dp);
      mma::mma_pb<D>(dk, pf, qs + buf * TILE, lane, lo, hi);
    }
  }

  bf16* krow = dqkv + (size_t(b) * n + k0) * tok + h * D + hd;
  mma::store_rows<D>(krow, 8 * tok, dk, k0 < n, k1 < n, lane);
  mma::store_rows<D>(krow + hd, 8 * tok, dv, k0 < n, k1 < n, lane);
}

template <int D>
cudaError_t launch_mma(const void* qkv, const void* dout, void* dqkv, void* stats, int b, int n,
                       int heads, int causal, float scale, cudaStream_t stream) {
  constexpr size_t s1 = smem_dq_mma<D>(), s2 = smem_dkv_mma<D>();
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      attn_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      attn_bwd_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s2));
  if (attr1 != cudaSuccess) return attr1;
  if (attr2 != cudaSuccess) return attr2;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(dout);
  bf16* out = static_cast<bf16*>(dqkv);
  float* st = static_cast<float*>(stats);
  attn_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, s1, stream>>>(q, g, out, st, n, heads, causal,
                                                              scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, s2, stream>>>(q, g, out, st, n, heads, causal,
                                                               scale);
  return cudaGetLastError();
}

// ---- fp32: register-blocked CUDA-core tiles (attention_tile.cuh attn32) ------

namespace a32 = colxlip::attn32;

// dQ pass: Q and dO tiles, two K and two V tiles. dz^T goes into the V tile
// its step has read where a transposed tile fits there (D = 64: two blocks
// an SM), else into a tile of its own.
template <int D>
__host__ __device__ constexpr bool z_in_v() {
  return a32::tile_floats<D>() >= a32::kTransposedFloats;
}

template <int D>
constexpr size_t smem_dq_fp32() {
  return (6 * size_t(a32::tile_floats<D>()) + (z_in_v<D>() ? 0 : a32::kTransposedFloats)) *
         sizeof(float);
}

// dK/dV pass: K, V, Q and dO tiles, the transposed p and dz tiles, the three
// statistics of 64 query rows.
template <int D>
constexpr size_t smem_dkv_fp32() {
  return (4 * size_t(a32::tile_floats<D>()) + 2 * a32::kTransposedFloats + 3 * a32::kRows) *
         sizeof(float);
}

// Pass 1: the statistics (max, 1 / sum, delta) and dQ.
template <int D>
__global__ void __launch_bounds__(a32::kThreads, 2)
attn_bwd_dq_fp32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                        float* __restrict__ dqkv, float* __restrict__ stats, int n, int heads,
                        int causal, float scale) {
  constexpr int TILE = a32::tile_floats<D>();
  constexpr int CW = D / 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * a32::kRows;
  const int hd = heads * D;
  const size_t tok = 3 * size_t(hd);
  const float* qg = qkv + size_t(b) * n * tok + h * D;
  const float* kg = qg + hd;
  const float* vg = qg + 2 * hd;
  const float* dog = dout + size_t(b) * n * hd + h * D;

  extern __shared__ __align__(16) float smem32[];
  float* qs = smem32;
  float* dos = qs + TILE;
  float* ks = dos + TILE;     // two buffers
  float* vs = ks + 2 * TILE;  // two buffers
  float* zs = vs + 2 * TILE;  // dz^T [key][query row], unless it goes into V

  const int tiles = causal ? blockIdx.x + 1 : (n + a32::kRows - 1) / a32::kRows;
  const int steps = 2 * tiles;
  a32::stage_rows<D>(qs, qg, tok, row0, n);
  a32::stage_rows<D>(dos, dog, hd, row0, n);
  a32::stage_rows<D>(ks, kg, tok, 0, n);
  a32::stage_rows<D>(vs, vg, tok, 0, n);
  mma::cp_async_commit();

  // sweep A: the running max m, l and u = sum e dp, both rescaled as the max
  // grows; at its end l becomes 1 / l and u becomes delta = u / l
  float m[8], l[8], u[8], dq[8][CW];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = u[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) dq[i][j] = 0.f;
  }

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const bool second = s >= tiles;  // sweep B: dz and dQ
    const int tile = second ? s - tiles : s;
    // this step's tiles have arrived, and every warp is done with the other
    // buffers (read in the step before): one barrier serves both
    mma::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < steps) {
      const int next = (tile + 1) % tiles;
      a32::stage_rows<D>(ks + (buf ^ 1) * TILE, kg, tok, next * a32::kRows, n);
      a32::stage_rows<D>(vs + (buf ^ 1) * TILE, vg, tok, next * a32::kRows, n);
      mma::cp_async_commit();
    }
    const int key0 = tile * a32::kRows;
    const int live = a32::live_cols(key0, row0, n, causal);
    float sc[8][4], dp[8][4];
    if (live > 0) {
      const int groups = (live + 15) >> 4;
      a32::abt<D>(sc, qs, ks + buf * TILE, groups);
      a32::scale_scores(sc, row0, key0, n, causal, scale);
      a32::abt<D>(dp, dos, vs + buf * TILE, groups);
      if (!second) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float mt =
              a32::row_max(fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3])));
          const float mn = fmaxf(m[i], mt);
          const float ref = mn == -INFINITY ? 0.f : mn;
          const float a = expf(m[i] - ref);
          m[i] = mn;
          float rs = 0.f, ru = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e = expf(sc[i][c] - ref);
            rs += e;
            ru = fmaf(e, dp[i][c], ru);
          }
          l[i] = l[i] * a + rs;
          u[i] = u[i] * a + ru;
        }
      } else {
        // dead pairs: s = -inf, so p = 0 and dz = 0
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = expf(sc[i][c] - m[i]) * l[i];
            sc[i][c] = p * (dp[i][c] - u[i]) * scale;
          }
      }
    }
    if (second) {
      float* zt = z_in_v<D>() ? vs + buf * TILE : zs;
      if (z_in_v<D>()) __syncthreads();  // every warp is done reading V for dP
      if (live > 0) {
        a32::store_transposed(zt, sc);
        __syncwarp();
        a32::pb<D>(dq, zt, ks + buf * TILE, 0, live);
      }
    }
    if (s == tiles - 1) {  // end of sweep A, whether or not this warp saw the last tile
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        l[i] = 1.f / a32::row_sum(l[i]);
        u[i] = a32::row_sum(u[i]) * l[i];
      }
    }
  }

  a32::store_rows<D>(dqkv + size_t(b) * n * tok + h * D, tok, row0, n, dq);
  if (a32::tx() == 0) {
    const size_t plane = size_t(gridDim.z) * heads * n;
    float* row_max = stats + (size_t(b) * heads + h) * n;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + a32::own_row(i);
      if (r < n) {
        row_max[r] = m[i];
        row_max[plane + r] = l[i];
        row_max[2 * plane + r] = u[i];
      }
    }
  }
}

// Pass 2: dK and dV from p and dz rebuilt with pass 1's statistics. The
// block's rows are its 64 keys, the columns the queries of a streamed tile.
template <int D>
__global__ void __launch_bounds__(a32::kThreads, 2)
attn_bwd_dkv_fp32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                         float* __restrict__ dqkv, const float* __restrict__ stats, int n,
                         int heads, int causal, float scale) {
  constexpr int TILE = a32::tile_floats<D>();
  constexpr int CW = D / 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * a32::kRows;
  const int hd = heads * D;
  const size_t tok = 3 * size_t(hd);
  const float* qg = qkv + size_t(b) * n * tok + h * D;
  const float* kg = qg + hd;
  const float* vg = qg + 2 * hd;
  const float* dog = dout + size_t(b) * n * hd + h * D;
  const size_t plane = size_t(gridDim.z) * heads * n;
  const float* row_stats = stats + (size_t(b) * heads + h) * n;

  extern __shared__ __align__(16) float smem32[];
  float* ks = smem32;
  float* vs = ks + TILE;
  float* qs = vs + TILE;
  float* dos = qs + TILE;
  float* ps = dos + TILE;                    // p^T: [query][key]
  float* zs = ps + a32::kTransposedFloats;   // dz^T
  float* st = zs + a32::kTransposedFloats;   // [3][64]: max, 1 / sum, delta

  const int tiles = (n + a32::kRows - 1) / a32::kRows;
  const int first = causal ? blockIdx.x : 0;  // a key j only meets queries i >= j
  a32::stage_rows<D>(ks, kg, tok, col0, n);
  a32::stage_rows<D>(vs, vg, tok, col0, n);

  float dk[8][CW], dv[8][CW];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int wkey = col0 + a32::warp_first_row();  // the warp's first key

  for (int tile = first; tile < tiles; ++tile) {
    const int q0 = tile * a32::kRows;
    // one buffer: every warp is done with the last tile before the copies
    if (tile > first) __syncthreads();
    a32::stage_rows<D>(qs, qg, tok, q0, n);
    a32::stage_rows<D>(dos, dog, hd, q0, n);
    for (int idx = threadIdx.x; idx < 3 * a32::kRows; idx += a32::kThreads) {
      const int which = idx / a32::kRows, q = q0 + idx - which * a32::kRows;
      const bool live = q < n;
      mma::cp_async_4(st + idx, row_stats + which * plane + (live ? q : 0), live);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();

    // queries of the tile that some key of the warp meets: none past n and,
    // under the causal mask, none before the warp's first key
    const int hi = wkey < n ? min(n - q0, a32::kRows) : 0;
    const int lo = causal ? max(0, wkey - q0) : 0;
    if (lo >= hi) continue;  // warp-uniform
    float sc[8][4], dp[8][4];
    const int groups = (hi + 15) >> 4;
    a32::abt<D>(sc, ks, qs, groups);   // S^T = K . Q^T, unscaled
    a32::abt<D>(dp, vs, dos, groups);  // dP^T = V . dO^T
    // dead pairs exist only in a ragged tile and where a key comes after a query
    const bool edge = q0 + a32::kRows > n || col0 + a32::kRows > n ||
                      (causal && col0 + a32::kRows - 1 > q0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qc = a32::own_col(c);
      const int q = q0 + qc;
      const float qm = st[qc], qil = st[a32::kRows + qc], qdelta = st[2 * a32::kRows + qc];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = col0 + a32::own_row(i);
        const bool dead = edge && (q >= n || key >= n || (causal && key > q));
        const float p = dead ? 0.f : expf(sc[i][c] * scale - qm) * qil;
        sc[i][c] = p;
        dp[i][c] = dead ? 0.f : p * (dp[i][c] - qdelta) * scale;
      }
    }
    a32::store_transposed(ps, sc);
    a32::store_transposed(zs, dp);
    __syncwarp();
    a32::pb<D>(dv, ps, dos, lo, hi);
    a32::pb<D>(dk, zs, qs, lo, hi);
  }

  float* krows = dqkv + size_t(b) * n * tok + h * D + hd;
  a32::store_rows<D>(krows, tok, col0, n, dk);
  a32::store_rows<D>(krows + hd, tok, col0, n, dv);
}

template <int D>
cudaError_t launch_fp32(const void* qkv, const void* dout, void* dqkv, void* stats, int b, int n,
                        int heads, int causal, float scale, cudaStream_t stream) {
  constexpr size_t s1 = smem_dq_fp32<D>(), s2 = smem_dkv_fp32<D>();
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      attn_bwd_dq_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      attn_bwd_dkv_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s2));
  if (attr1 != cudaSuccess) return attr1;
  if (attr2 != cudaSuccess) return attr2;
  const dim3 grid((n + a32::kRows - 1) / a32::kRows, heads, b);
  const float* q = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  float* out = static_cast<float*>(dqkv);
  float* st = static_cast<float*>(stats);
  attn_bwd_dq_fp32_kernel<D><<<grid, a32::kThreads, s1, stream>>>(q, g, out, st, n, heads,
                                                                  causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_fp32_kernel<D><<<grid, a32::kThreads, s2, stream>>>(q, g, out, st, n, heads,
                                                                   causal, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, N, 3*H*D], dout [B, N, H*D], dqkv [B, N, 3*H*D] (all of one dtype:
// 0 = float32, 1 = bfloat16; 16-byte aligned pointers), stats: float32
// scratch of 3*B*H*N. Returns a cudaError_t (0 = launched).
extern "C" int colxlip_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                     int b, int n, int heads, int head_dim, int causal,
                                     int dtype, float scale, void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dqkv)) & 15)
    return cudaErrorMisalignedAddress;
  if (dtype == 0 && head_dim == 32)
    return launch_fp32<32>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch_fp32<64>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 32)
    return launch_mma<32>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_mma<64>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  return cudaErrorInvalidValue;
}
