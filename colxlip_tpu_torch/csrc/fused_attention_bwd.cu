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
// dK = dz^T . Q, each accumulated in fp32 and rounded to the input dtype.
//
// What bounds it on the H100: per (batch row, head) the backward does
// 7 * N^2 * D FMAs (s and dp twice, dQ, dK, dV) against 4 * N * D values in
// and 3 * N * D out. At the vision shape (B=256, N=197, H=12, D=64) that is
// 53 G FMA over 0.3 GB, so it is bound by FMA issue, not memory. This first
// version runs them as fp32 FMAs on the CUDA cores (67 TFLOP/s peak);
// mma.sync / wgmma on the tensor cores is the next step.
//
// Design: two kernels on the stream, FlashAttention-2 style.
//   1. dQ pass, one block per (query tile of 64, head, batch row), as the
//      forward kernel: K_h and V_h in shared memory, one warp per query row.
//      Lanes take keys for s and dp (warp-reduced max, sum and delta), then
//      output dimensions for dQ. It stores each row's max, sum and delta
//      (fp32, [3, B, H, N] scratch from the wrapper).
//   2. dK/dV pass, one block per (key tile of 64, head, batch row): Q_h and
//      dO_h in shared memory, one warp per key row. Lanes take query rows to
//      rebuild p and dz from the stored statistics, then output dimensions
//      for dK and dV.
// Both passes compute s and dp with the same FMA order over D, so pass 2's
// p equals pass 1's bit for bit; neither needs atomics. Rows read by 32
// lanes at once are padded to an odd number of 32-bit words (no bank
// conflicts). Shared memory is dynamic (over 48 KB at N=197), and each entry
// point returns cudaGetLastError() so a refused launch is reported.

#include "common.cuh"

namespace {

using colxlip::align16;
using colxlip::from_f;
using colxlip::round_to;
using colxlip::to_f;
using colxlip::warp_max;
using colxlip::warp_sum;

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;
constexpr int kMaxN = 256;

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
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
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
attn_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
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

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* dout, void* dqkv, void* stats, int b, int n,
                   int heads, int causal, float scale, cudaStream_t stream) {
  const size_t s1 = smem_dq<T, D>(n), s2 = smem_dkv<T, D>(n);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(s1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s2));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* out = static_cast<T*>(dqkv);
  float* st = static_cast<float*>(stats);
  attn_bwd_dq_kernel<T, D><<<grid, kWarps * 32, s1, stream>>>(q, g, out, st, n, heads, causal,
                                                              scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<T, D><<<grid, kWarps * 32, s2, stream>>>(q, g, out, st, n, heads, causal,
                                                               scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, N, 3*H*D], dout [B, N, H*D], dqkv [B, N, 3*H*D] (all of one dtype:
// 0 = float32, 1 = bfloat16), stats: float32 scratch of 3*B*H*N. Returns a
// cudaError_t (0 = launched).
extern "C" int colxlip_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* stats,
                                     int b, int n, int heads, int head_dim, int causal,
                                     int dtype, float scale, void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || n < 1 || n > kMaxN)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32)
    return launch<float, 32>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 32)
    return launch<__nv_bfloat16, 32>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(qkv, dout, dqkv, stats, b, n, heads, causal, scale, s);
  return cudaErrorInvalidValue;
}
