// Packed-QKV multi-head self-attention, forward, for Hopper (sm_90a).
//
// Replaces: colxlip_tpu/ops/fused_attention.py `fused_mha_packed` (:423), whose
// TPU body is the Pallas `_fwd_kernel` (:103, with `_unit_qk` :69 and
// `_unit_pv` :85). Same contract: qkv [B, N, 3*H*D] exactly as the in_proj
// matmul emits it (q | k | v along features, head h in columns h*D..h*D+D-1),
// out [B, N, H*D] ready for out_proj. No transpose in or out, and no
// [B, H, N, N] tensor in device memory.
//
// Numerics follow the TPU kernel: fp32 scores scaled by 1/sqrt(D), causal mask
// col <= row, row max, e = exp(s - max) cast to the input dtype for the PV
// product, PV accumulated in fp32, divided by the fp32 row sum of e.
//
// What bounds it on the H100: at the vision shape (B=64, N=197, H=12, D=64,
// bf16) the call moves 77 MB (qkv in, out back: about 23 us at 3.35 TB/s) and
// does 7.6 GFLOP. This first version computes both products with fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak), so it is bound by FMA issue, not by memory.
// Moving QK^T and PV onto the tensor cores (mma.sync / wgmma) is the next step.
//
// Design: one block per (query-row tile of 64, head, batch row). The block
// stages K_h and V_h for its batch row in shared memory (all N keys, or the
// keys up to its last row when causal), so each query row reads them from
// shared memory instead of device memory. One warp per query row: lanes take
// keys for the scores (warp-reduced max and sum), then lanes take output
// dimensions for PV. K rows are padded to an odd 32-bit-word stride, so the
// 32 lanes reading 32 different keys hit 32 different banks. K+V for N=197,
// D=64 in bf16 is over 48 KB, so shared memory is dynamic and the launcher
// raises the kernel's limit with cudaFuncSetAttribute; the entry point returns
// cudaGetLastError(), because a refused launch never runs and a later
// synchronize would not report it.

#include "common.cuh"

namespace {

using colxlip::align16;
using colxlip::from_f;
using colxlip::to_f;
using colxlip::warp_max;
using colxlip::warp_sum;

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;
constexpr int kMaxN = 256;

// K row stride in elements: an odd number of 32-bit words.
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
attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
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

template <typename T, int D>
cudaError_t launch(const void* qkv, void* out, int b, int n, int heads, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(n);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, b);
  attn_fwd_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, heads, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv, out: device pointers; dtype 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 = launched).
extern "C" int colxlip_attention_fwd(const void* qkv, void* out, int b, int n, int heads,
                                     int head_dim, int causal, int dtype, float scale,
                                     void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || n < 1 || n > kMaxN)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 32) return launch<float, 32>(qkv, out, b, n, heads, causal, scale, s);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(qkv, out, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 32)
    return launch<__nv_bfloat16, 32>(qkv, out, b, n, heads, causal, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(qkv, out, b, n, heads, causal, scale, s);
  return cudaErrorInvalidValue;
}

// Name of a cudaError_t, for the Python wrappers' error messages.
extern "C" const char* colxlip_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
