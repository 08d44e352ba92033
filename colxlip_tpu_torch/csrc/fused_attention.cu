// Packed-QKV multi-head self-attention, forward, for Hopper (sm_90a).
//
// Replaces: colxlip_tpu/ops/fused_attention.py `fused_mha_packed` (:423), whose
// TPU body is the Pallas `_fwd_kernel` (:103, with `_unit_qk` :69 and
// `_unit_pv` :85), and `_fwd_call_heads` (:273), the same function on a
// head-pair grid. Same contract: qkv [B, N, 3*H*D] exactly as the in_proj
// matmul emits it (q | k | v along features, head h in columns h*D..h*D+D-1),
// out [B, N, H*D] ready for out_proj. No transpose in or out, and no
// [B, H, N, N] tensor in device memory.
//
// Numerics follow the TPU kernel: fp32 scores scaled by 1/sqrt(D), causal mask
// col <= row, row max m, e = exp(s - m), l = fp32 row sum of the unrounded e,
// out = (e cast to the input dtype . V, accumulated in fp32) / l.
//
// What bounds it on the H100: at the vision shape (B=64, N=197, H=12, D=64,
// bf16) the call moves 77 MB (qkv in, out back: 23 us at 3.35 TB/s) against
// 7.6 GFLOP (8 us at the tensor cores' 989 TFLOP/s), so the function is bound
// by bytes, but only if its products run on the tensor cores: on the CUDA
// cores (67 TFLOP/s) the same operations take over 100 us.
//
// Design, bf16 inputs (`attn_fwd_mma_kernel`): every product is an
// mma.sync.m16n8k16 tile (csrc/mma_tile.cuh holds the layouts). One block of
// four warps per (query tile of 64, head, batch row); a warp owns 16 query
// rows, whose Q fragments it keeps in registers. The TPU kernel holds a whole
// head's N x N scores in VMEM; here K and V walk past in key tiles of 64,
// staged by 16-byte cp.async copies into double-buffered padded shared memory
// while the previous tile is multiplied, so there is no limit on N. A score
// tile is 8 x (D/16) mma a warp and its accumulator fragment is already the
// A-operand layout of the next product, so bf16(e) goes into P.V from
// registers, with V read through ldmatrix.trans.
// The key tiles are swept twice, to keep the contract's rounding points:
// sweep 1 computes S only and the row max; sweep 2 computes S again,
// e = expf(s - m), l += e before the cast and O += bf16(e) . V. That is
// 3 N^2 D products instead of 2 and no rescaling: the kernel differs from the
// plain version by summation order only, where a one-sweep online softmax
// would round e against another max. Rows of a tile past N are zero-filled in
// shared memory (a masked 0 times a stale NaN pattern would be NaN), scores
// of dead keys are -inf before the max, query rows past N are computed and
// not stored, and under the causal mask a query tile stops at its diagonal
// key tile. A warp multiplies only the groups of 16 keys that one of its rows
// can see (none past N or above the diagonal; a warp whose rows all lie past
// N multiplies nothing), and a whole tile, the common case, runs as one
// branch-free block of mma. One barrier a step: it says both that the tile
// has arrived and that the other buffer is free for the next copy.
// What limits it as measured on the H100: neither bytes nor the tensor cores
// but latency. A step is a chain (ldmatrix, mma, 32 expf of nine instructions
// each, mma) that only other resident warps hide, and 128 registers a thread
// and 46 KB a block allow four blocks of four warps an SM. Deeper copy rings
// (three, four buffers) and 128-row blocks each cost resident warps and
// measured slower; skipping dead groups and the second barrier bought 15%.
// wgmma and TMA are not used: a head's tile is 64 wide and a
// (batch row, head) problem is 197 x 197, of which there are 3,072 at batch
// 256, which fill 132 SMs with small blocks; a warpgroup-wide 64 x 256
// instruction has nothing larger to chew on here.
//
// fp32 inputs (`attn_fwd_fp32_kernel`) keep the first version's CUDA-core
// design, because bf16 or TF32 operands cannot meet a 1e-5 tolerance and no
// main path runs fp32 attention: one block per (query tile of 64, head, batch
// row) stages all of K_h and V_h in shared memory, one warp per query row,
// lanes over keys for the scores and over output dimensions for PV. Its N is
// bounded by the 232,448 bytes of shared memory a block can have (the
// launcher refuses above). The entry point returns cudaGetLastError(),
// because a refused launch never runs and a later synchronize would not
// report it.

#include "attention_tile.cuh"

namespace {

using colxlip::align16;
using colxlip::from_f;
using colxlip::to_f;
using colxlip::warp_max;
using colxlip::warp_sum;
namespace mma = colxlip::mma;
using mma::bf16;

constexpr int kRowsPerBlock = 64;

// ---- bf16: tensor-core tiles -------------------------------------------------

// Four warps of 16 query rows: a block's rows are one tile of 64. Eight warps
// (128 rows, half the K and V traffic) measured no faster forward and 28%
// slower backward, where registers then leave one block an SM.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;

// Q tile, two K tiles, two V tiles
template <int D>
constexpr size_t smem_mma() { return 5 * size_t(mma::tile_elems<D>()) * sizeof(bf16); }

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 4)
attn_fwd_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n, int heads,
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

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TILE;      // two buffers
  bf16* vs = ks + 2 * TILE;  // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  // key tiles this query tile meets (up to the diagonal when causal); each is
  // visited once a sweep
  const int tiles = causal ? blockIdx.x + 1 : (n + mma::kTileRows - 1) / mma::kTileRows;
  const int steps = 2 * tiles;

  mma::load_tile<D, kMmaThreads>(qs, qg, tok, row0, n);
  mma::load_tile<D, kMmaThreads>(ks, kg, tok, 0, n);
  mma::cp_async_commit();

  const int wrow = row0 + warp * 16;           // the warp's first query row
  const int r0 = wrow + g, r1 = r0 + 8;        // this thread's two query rows
  uint32_t qf[D / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const bool second = s >= tiles;  // sweep 2: e, l and P.V
    // This step's tile has arrived, and every warp is done with the other
    // buffer (it read it in the step before): one barrier serves both, then
    // the next tile's copies run under this step's products. (Two buffers: a
    // ring of three or four, which costs a resident block an SM, measured 15%
    // and 43% slower.)
    mma::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < steps) {
      const bool next_second = s + 1 >= tiles;
      const int next = next_second ? s + 1 - tiles : s + 1;
      mma::load_tile<D, kMmaThreads>(ks + (buf ^ 1) * TILE, kg, tok, next * mma::kTileRows, n);
      if (next_second)
        mma::load_tile<D, kMmaThreads>(vs + (buf ^ 1) * TILE, vg, tok, next * mma::kTileRows, n);
      mma::cp_async_commit();
    }
    if (s == 0) mma::load_a<D>(qf, qs + warp * 16 * RS, lane);

    const int key0 = (second ? s - tiles : s) * mma::kTileRows;
    const int groups = mma::live_key_groups(key0, wrow, n, causal);
    if (groups > 0) {
      float sc[8][4];
      mma::score_tile<D>(sc, qf, ks + buf * TILE, lane, key0, wrow, n, causal, scale, groups);
      if (!second) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          m0 = fmaxf(m0, fmaxf(sc[nt][0], sc[nt][1]));
          m1 = fmaxf(m1, fmaxf(sc[nt][2], sc[nt][3]));
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          sc[nt][0] = expf(sc[nt][0] - m0);
          sc[nt][1] = expf(sc[nt][1] - m0);
          sc[nt][2] = expf(sc[nt][2] - m1);
          sc[nt][3] = expf(sc[nt][3] - m1);
          l0 += sc[nt][0] + sc[nt][1];
          l1 += sc[nt][2] + sc[nt][3];
        }
        uint32_t pf[4][4];
        mma::pack_a(pf, sc);
        mma::mma_pb<D>(o, pf, vs + buf * TILE, lane, 0, groups);
      }
    }
    if (s == tiles - 1) {  // end of sweep 1, whether or not this warp saw the last tile
      m0 = mma::quad_max(m0);
      m1 = mma::quad_max(m1);
    }
  }

  l0 = mma::quad_sum(l0);
  l1 = mma::quad_sum(l1);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    o[nt][0] /= l0;
    o[nt][1] /= l0;
    o[nt][2] /= l1;
    o[nt][3] /= l1;
  }
  bf16* orow = out + (size_t(b) * n + r0) * hd + h * D;
  mma::store_rows<D>(orow, 8 * size_t(hd), o, r0 < n, r1 < n, lane);
}

template <int D>
cudaError_t launch_mma(const void* qkv, void* out, int b, int n, int heads, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_mma<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  attn_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), n, heads, causal, scale);
  return cudaGetLastError();
}

// ---- fp32: CUDA cores, all of K_h and V_h in shared memory -----------------

constexpr int kWarps = 8;

// K row stride in elements: an odd number of 32-bit words, so the 32 lanes
// reading 32 different keys hit 32 different banks.
template <typename T, int D>
__host__ __device__ constexpr int k_stride() { return colxlip::odd_word_stride<T, D>(); }

template <typename T, int D>
__host__ __device__ inline size_t kv_bytes(int n) {
  return align16(size_t(n) * k_stride<T, D>() * sizeof(T) + size_t(n) * D * sizeof(T));
}

template <typename T, int D>
size_t smem_bytes(int n) {
  return kv_bytes<T, D>(n) + size_t(kWarps) * D * sizeof(float) + size_t(kWarps) * n * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_fp32_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
                     int causal, float scale) {
  constexpr int KS = k_stride<T, D>();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int hd = heads * D;
  const size_t tok = 3 * size_t(hd);
  const T* base = qkv + size_t(b) * n * tok;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + size_t(n) * KS;
  float* qs = reinterpret_cast<float*>(smem + kv_bytes<T, D>(n));
  float* ps = qs + kWarps * D;

  const int nk = causal ? min(n, row0 + kRowsPerBlock) : n;
  for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
    const int j = idx / D, d = idx - j * D;
    const T* t = base + size_t(j) * tok + h * D + d;
    ks[j * KS + d] = t[hd];
    vs[j * D + d] = t[2 * hd];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q = qs + warp * D;
  float* p = ps + warp * n;
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int i = row0 + r;
    if (i >= n) break;
    const T* qrow = base + size_t(i) * tok + h * D;
    for (int d = lane; d < D; d += 32) q[d] = to_f(qrow[d]);
    __syncwarp();

    const int nkeys = causal ? i + 1 : n;
    float mx = -INFINITY;
    for (int j = lane; j < nkeys; j += 32) {
      const T* krow = ks + j * KS;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q[d], to_f(krow[d]), s);
      s *= scale;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);

    float sum = 0.f;
    for (int j = lane; j < nkeys; j += 32) {
      const float e = expf(p[j] - mx);
      sum += e;
      p[j] = to_f(from_f<T>(e));  // the PV operand in the input dtype
    }
    sum = warp_sum(sum);
    __syncwarp();

    float acc[D / 32];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) acc[c] = 0.f;
    for (int j = 0; j < nkeys; ++j) {
      const float pj = p[j];
      const T* vrow = vs + j * D + lane;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[c] = fmaf(pj, to_f(vrow[32 * c]), acc[c]);
    }
    T* orow = out + (size_t(b) * n + i) * hd + h * D + lane;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) orow[32 * c] = from_f<T>(acc[c] / sum);
    __syncwarp();
  }
}

template <int D>
cudaError_t launch_fp32(const void* qkv, void* out, int b, int n, int heads, int causal,
                        float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<float, D>(n);
  if (smem > colxlip::kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_fp32_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  attn_fwd_fp32_kernel<float, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), n, heads, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv, out: device pointers; dtype 0 = float32, 1 = bfloat16 (16-byte aligned
// pointers). Returns a cudaError_t (0 = launched).
extern "C" int colxlip_attention_fwd(const void* qkv, void* out, int b, int n, int heads,
                                     int head_dim, int causal, int dtype, float scale,
                                     void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32) return launch_fp32<32>(qkv, out, b, n, heads, causal, scale, s);
  if (dtype == 0 && head_dim == 64) return launch_fp32<64>(qkv, out, b, n, heads, causal, scale, s);
  if (dtype == 1 && (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  if (dtype == 1 && head_dim == 32) return launch_mma<32>(qkv, out, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 64) return launch_mma<64>(qkv, out, b, n, heads, causal, scale, s);
  return cudaErrorInvalidValue;
}

// Name of a cudaError_t, for the Python wrappers' error messages.
extern "C" const char* colxlip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
