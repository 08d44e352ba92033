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
// fp32 inputs keep the first version's CUDA-core kernels (bf16 or TF32
// operands cannot meet a 1e-5 tolerance, and no main path runs fp32
// attention): the dQ pass stages all of K_h and V_h in shared memory with one
// warp per query row, the dK/dV pass all of Q_h and dO_h with one warp per
// key row, rebuilding p and dz from the stored max, sum and delta. Their N is
// bounded by the 232,448 bytes of shared memory a block can have (the
// launcher refuses above). Each entry point returns cudaGetLastError() so a
// refused launch is reported.

#include "attention_tile.cuh"

namespace {

using colxlip::align16;
using colxlip::from_f;
using colxlip::round_to;
using colxlip::to_f;
using colxlip::warp_max;
using colxlip::warp_sum;
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

// ---- fp32: CUDA cores, whole operands of a head in shared memory -------------

constexpr int kWarps = 8;

// Both passes stage two [rows, D] operands of the (batch row, head) in
// shared memory, plus per-warp fp32 rows of D and of N values.
template <typename T, int D>
__host__ __device__ inline size_t pair_bytes(int rows) {
  return align16(2 * size_t(rows) * colxlip::odd_word_stride<T, D>() * sizeof(T));
}

template <typename T, int D>
size_t smem_dq(int n) {
  return pair_bytes<T, D>(n) + size_t(kWarps) * (2 * D + 2 * n) * sizeof(float);
}

template <typename T, int D>
size_t smem_dkv(int n) {
  return pair_bytes<T, D>(n) + 3 * size_t(n) * sizeof(float) +
         size_t(kWarps) * (2 * D + 2 * n) * sizeof(float);
}

// Pass 1: dQ and the per-row statistics (max, sum, delta).
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_dq_fp32_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                   T* __restrict__ dqkv, float* __restrict__ stats, int n, int heads,
                   int causal, float scale) {
  constexpr int KS = colxlip::odd_word_stride<T, D>();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int hd = heads * D;
  const size_t tok = 3 * size_t(hd);
  const T* base = qkv + size_t(b) * n * tok;
  const T* dbase = dout + size_t(b) * n * hd;
  T* gbase = dqkv + size_t(b) * n * tok;
  const size_t plane = size_t(gridDim.z) * heads * n;
  float* row_max = stats + (size_t(b) * heads + h) * n;
  float* row_sum = row_max + plane;
  float* row_delta = row_max + 2 * plane;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + size_t(n) * KS;
  float* qs = reinterpret_cast<float*>(smem + pair_bytes<T, D>(n));
  float* dos = qs + kWarps * D;
  float* ps = dos + kWarps * D;
  float* dps = ps + kWarps * n;

  const int nk = causal ? min(n, row0 + kRowsPerBlock) : n;
  for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - j * D;
    const T* t = base + size_t(j) * tok + h * D + d;
    ks[j * KS + d] = t[hd];
    vs[j * KS + d] = t[2 * hd];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q = qs + warp * D;
  float* dov = dos + warp * D;
  float* p = ps + warp * n;
  float* dp = dps + warp * n;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int i = row0 + r;
    if (i >= n) break;
    const T* qrow = base + size_t(i) * tok + h * D;
    const T* dorow = dbase + size_t(i) * hd + h * D;
    for (int d = lane; d < D; d += 32) {
      q[d] = to_f(qrow[d]);
      dov[d] = to_f(dorow[d]);
    }
    __syncwarp();

    const int nkeys = causal ? i + 1 : n;
    float mx = -INFINITY;
    for (int j = lane; j < nkeys; j += 32) {
      const T* krow = ks + j * KS;
      const T* vrow = vs + j * KS;
      float s = 0.f, g = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q[d], to_f(krow[d]), s);
        g = fmaf(dov[d], to_f(vrow[d]), g);
      }
      s *= scale;
      p[j] = s;
      dp[j] = g;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nkeys; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < nkeys; j += 32) {
      const float pj = p[j] / sum;
      p[j] = pj;
      delta = fmaf(pj, dp[j], delta);
    }
    delta = warp_sum(delta);
    for (int j = lane; j < nkeys; j += 32) dp[j] = round_to<T>(p[j] * (dp[j] - delta) * scale);
    __syncwarp();

    float acc[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[c] = 0.f;
    for (int j = 0; j < nkeys; ++j) {
      const float dz = dp[j];
      const T* krow = ks + j * KS + lane;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[c] = fmaf(dz, to_f(krow[32 * c]), acc[c]);
    }
    T* dqrow = gbase + size_t(i) * tok + h * D + lane;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) dqrow[32 * c] = from_f<T>(acc[c]);
    if (lane == 0) {
      row_max[i] = mx;
      row_sum[i] = sum;
      row_delta[i] = delta;
    }
    __syncwarp();
  }
}

// Pass 2: dK and dV from p and dz rebuilt with pass 1's statistics.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_dkv_fp32_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                    T* __restrict__ dqkv, const float* __restrict__ stats, int n, int heads,
                    int causal, float scale) {
  constexpr int QS = colxlip::odd_word_stride<T, D>();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * kRowsPerBlock;
  const int hd = heads * D;
  const size_t tok = 3 * size_t(hd);
  const T* base = qkv + size_t(b) * n * tok;
  const T* dbase = dout + size_t(b) * n * hd;
  T* gbase = dqkv + size_t(b) * n * tok;
  const size_t plane = size_t(gridDim.z) * heads * n;
  const float* row_max = stats + (size_t(b) * heads + h) * n;

  extern __shared__ __align__(16) unsigned char smem[];
  // query rows i0..n-1: a key j only meets queries i >= j when causal
  const int i0 = causal ? col0 : 0;
  const int rows = n - i0;
  T* qsm = reinterpret_cast<T*>(smem);
  T* dosm = qsm + size_t(rows) * QS;
  float* ms = reinterpret_cast<float*>(smem + pair_bytes<T, D>(rows));
  float* ls = ms + rows;
  float* deltas = ls + rows;
  float* kf_all = deltas + rows;
  float* vf_all = kf_all + kWarps * D;
  float* pb_all = vf_all + kWarps * D;
  float* zb_all = pb_all + kWarps * n;

  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    qsm[r * QS + d] = base[size_t(i0 + r) * tok + h * D + d];
    dosm[r * QS + d] = dbase[size_t(i0 + r) * hd + h * D + d];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    ms[r] = row_max[i0 + r];
    ls[r] = row_max[plane + i0 + r];
    deltas[r] = row_max[2 * plane + i0 + r];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* kf = kf_all + warp * D;
  float* vf = vf_all + warp * D;
  float* pb = pb_all + warp * n;
  float* zb = zb_all + warp * n;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int j = col0 + r;
    if (j >= n) break;
    const T* tj = base + size_t(j) * tok + h * D;
    for (int d = lane; d < D; d += 32) {
      kf[d] = to_f(tj[hd + d]);
      vf[d] = to_f(tj[2 * hd + d]);
    }
    __syncwarp();

    // queries that see key j, as offsets into the staged rows
    const int first = (causal ? j : 0) - i0;
    for (int ri = first + lane; ri < rows; ri += 32) {
      const T* qrow = qsm + ri * QS;
      const T* dorow = dosm + ri * QS;
      float s = 0.f, g = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(to_f(qrow[d]), kf[d], s);
        g = fmaf(to_f(dorow[d]), vf[d], g);
      }
      s *= scale;
      const float pij = expf(s - ms[ri]) / ls[ri];
      pb[ri] = round_to<T>(pij);
      zb[ri] = round_to<T>(pij * (g - deltas[ri]) * scale);
    }
    __syncwarp();

    float acc_k[D / 32], acc_v[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc_k[c] = acc_v[c] = 0.f;
    for (int ri = first; ri < rows; ++ri) {
      const float pij = pb[ri], zij = zb[ri];
      const T* qrow = qsm + ri * QS + lane;
      const T* dorow = dosm + ri * QS + lane;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        acc_v[c] = fmaf(pij, to_f(dorow[32 * c]), acc_v[c]);
        acc_k[c] = fmaf(zij, to_f(qrow[32 * c]), acc_k[c]);
      }
    }
    T* gj = gbase + size_t(j) * tok + h * D + lane;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      gj[hd + 32 * c] = from_f<T>(acc_k[c]);
      gj[2 * hd + 32 * c] = from_f<T>(acc_v[c]);
    }
    __syncwarp();
  }
}

template <int D>
cudaError_t launch_fp32(const void* qkv, const void* dout, void* dqkv, void* stats, int b, int n,
                        int heads, int causal, float scale, cudaStream_t stream) {
  using T = float;
  const size_t s1 = smem_dq<T, D>(n), s2 = smem_dkv<T, D>(n);
  if (s1 > colxlip::kMaxSharedBytes || s2 > colxlip::kMaxSharedBytes)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_fp32_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(s1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_fp32_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s2));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* out = static_cast<T*>(dqkv);
  float* st = static_cast<float*>(stats);
  attn_bwd_dq_fp32_kernel<T, D><<<grid, kWarps * 32, s1, stream>>>(q, g, out, st, n, heads,
                                                                   causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_fp32_kernel<T, D><<<grid, kWarps * 32, s2, stream>>>(q, g, out, st, n, heads,
                                                                    causal, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, N, 3*H*D], dout [B, N, H*D], dqkv [B, N, 3*H*D] (all of one dtype:
// 0 = float32, 1 = bfloat16 with 16-byte aligned pointers), stats: float32
// scratch of 3*B*H*N. Returns a cudaError_t (0 = launched).
extern "C" int colxlip_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                     int b, int n, int heads, int head_dim, int causal,
                                     int dtype, float scale, void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return launch_fp32<32>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch_fp32<64>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  if (dtype == 1 && (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
                     reinterpret_cast<uintptr_t>(dqkv)) & 15)
    return cudaErrorMisalignedAddress;
  if (dtype == 1 && head_dim == 32)
    return launch_mma<32>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch_mma<64>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  return cudaErrorInvalidValue;
}
