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
// Design, fp32 inputs (`attn_fwd_fp32_kernel`): fp32 FMAs on the CUDA cores,
// because bf16 or TF32 operands cannot meet the 1e-5 tolerance
// (csrc/sgemm_tile.cuh says why). The grid is the bf16 kernel's: one block of
// 128 threads per (query tile of 64, head, batch row); K and V walk past in
// key tiles of 64, double-buffered by 16-byte cp.async copies (rows past N
// zero-filled), so there is no limit on N. Every product is the register-
// blocked tile of attention_tile.cuh `attn32`: a thread holds 8 query rows x
// 4 keys of S = scale Q K^T and 8 rows x D/16 columns of O, fed by float4
// reads of row-major tiles. One sweep with an online softmax: per key tile
// m' = max(m, rowmax S), a = expf(m - m'), e = expf(S - m'), l = a l + the
// thread's own sum of e, O = a O + e . V, and at the end l is the fixed
// xor-butterfly sum of the 16 threads' partials and out = O / l. In fp32
// there is no rounding point that needs the final max (the bf16 kernel sweeps
// twice only to round e against it): the rescaled e differs from
// exp(s - m) by a few ulp, and the function's own 2 N^2 D products suffice.
// e goes through shared memory as P^T, in rows that only the writing
// half-warp reads: a __syncwarp, not a barrier. A warp multiplies only the
// groups of 16 keys that one of its rows can see, and a warp whose rows all
// lie past N multiplies nothing. Shared memory is 104,448 bytes at D = 64
// (Q, two K and two V tiles, P^T; rows padded to 16 bytes past a multiple of
// 128), so two blocks of four warps share an SM; 168 registers, no spills.
// What limits it as measured on the H100 (PERF.md section 6): at ViT-L's 257
// tokens the kernel runs at 37% of the fp32 FMA peak, counting the ragged
// tiles it multiplies. Not occupancy: one buffer of K and V (three blocks an
// SM) measured the same there. Each 4 k of a product is 12 float4 shared
// loads for 128 fmaf, and the softmax's expf sits between the two products.
// The entry point returns cudaGetLastError(), because a refused launch never
// runs and a later synchronize would not report it.

#include "attention_tile.cuh"

namespace {

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

// ---- fp32: register-blocked CUDA-core tiles (attention_tile.cuh attn32) ------

namespace a32 = colxlip::attn32;

// Q tile, two K tiles, two V tiles, the transposed probability tile
template <int D>
constexpr size_t smem_fp32() {
  return (5 * size_t(a32::tile_floats<D>()) + a32::kTransposedFloats) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(a32::kThreads, 2)
attn_fwd_fp32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n, int heads,
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

  extern __shared__ __align__(16) float smem32[];
  float* qs = smem32;
  float* ks = qs + TILE;      // two buffers
  float* vs = ks + 2 * TILE;  // two buffers
  float* ps = vs + 2 * TILE;  // P^T: [key][query row]

  const int tiles = causal ? blockIdx.x + 1 : (n + a32::kRows - 1) / a32::kRows;
  a32::stage_rows<D>(qs, qg, tok, row0, n);
  a32::stage_rows<D>(ks, kg, tok, 0, n);
  a32::stage_rows<D>(vs, vg, tok, 0, n);
  mma::cp_async_commit();

  float m[8], l[8], o[8][CW];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) o[i][j] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    // tile t has arrived, and every warp is done with the other buffers (it
    // read them in the step before): one barrier serves both, then the next
    // tile's copies run under this step's products
    mma::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tiles) {
      a32::stage_rows<D>(ks + (buf ^ 1) * TILE, kg, tok, (t + 1) * a32::kRows, n);
      a32::stage_rows<D>(vs + (buf ^ 1) * TILE, vg, tok, (t + 1) * a32::kRows, n);
      mma::cp_async_commit();
    }
    const int key0 = t * a32::kRows;
    const int live = a32::live_cols(key0, row0, n, causal);
    if (live <= 0) continue;  // warp-uniform: the warp's rows all lie past n

    float s[8][4];
    a32::abt<D>(s, qs, ks + buf * TILE, (live + 15) >> 4);
    a32::scale_scores(s, row0, key0, n, causal, scale);
    // one sweep, online: the running max m, l and O rescaled by
    // a = expf(m_old - m_new) whenever the max grows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float mt = a32::row_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float mn = fmaxf(m[i], mt);
      const float ref = mn == -INFINITY ? 0.f : mn;  // a row with no live key yet
      const float a = expf(m[i] - ref);
      m[i] = mn;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - ref);
        rs += s[i][c];
      }
      l[i] = l[i] * a + rs;
#pragma unroll
      for (int j = 0; j < CW; ++j) o[i][j] *= a;
    }
    a32::store_transposed(ps, s);
    __syncwarp();
    a32::pb<D>(o, ps, vs + buf * TILE, 0, live);
    __syncwarp();  // every lane has read P^T before the next step writes it
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float sum = a32::row_sum(l[i]);
#pragma unroll
    for (int j = 0; j < CW; ++j) o[i][j] /= sum;
  }
  a32::store_rows<D>(out + size_t(b) * n * hd + h * D, hd, row0, n, o);
}

template <int D>
cudaError_t launch_fp32(const void* qkv, void* out, int b, int n, int heads, int causal,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_fp32<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + a32::kRows - 1) / a32::kRows, heads, b);
  attn_fwd_fp32_kernel<D><<<grid, a32::kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), n, heads, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv, out: 16-byte aligned device pointers; dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int colxlip_attention_fwd(const void* qkv, void* out, int b, int n, int heads,
                                     int head_dim, int causal, int dtype, float scale,
                                     void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  if (dtype == 0 && head_dim == 32) return launch_fp32<32>(qkv, out, b, n, heads, causal, scale, s);
  if (dtype == 0 && head_dim == 64) return launch_fp32<64>(qkv, out, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 32) return launch_mma<32>(qkv, out, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 64) return launch_mma<64>(qkv, out, b, n, heads, causal, scale, s);
  return cudaErrorInvalidValue;
}

// Name of a cudaError_t, for the Python wrappers' error messages.
extern "C" const char* colxlip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
