// Streaming contrastive cross-entropy, forward and backward, for Hopper
// (sm_90a): per-row CE of scale * a @ b^T against integer labels without the
// [M, N] logit matrix in device memory.
//
// Replaces: colxlip_tpu/ops/fused_ce.py `_fwd_call` (:82, body `_fwd_kernel`
// :45) and `_bwd_call` (:180; bodies `_bwd_da_kernel` :122 and
// `_bwd_db_kernel` :152). Same arithmetic:
//
//   forward   z_ij = scale * <a_i, b_j>   (dot accumulated in fp32 from the
//             input dtype, scaled after), online max / sum over column tiles
//             starting from max = -1e30 (not -inf: exp(-inf - -inf) is NaN),
//             lse_i = max + log(sum), loss_i = lse_i - z_{i, label_i} with
//             the label logit picked out of the same scaled tile
//   dA        dz_ij = (exp(z_ij - lse_i) - [j == label_i]) * g_i,
//             dA = scale * dz @ B with B read as fp32, scaled after the sum;
//             dscale_i = sum_j dz_ij * <a_i, b_j>
//   dB        dB = scale * dz^T @ A, likewise
//
// dA, dB, loss, lse and dscale leave the kernels in fp32; the wrapper casts
// and sums the per-row dscale. The TPU grid's padding to (8, 128) multiples
// and its n_valid argument are gone: every kernel masks the ragged edge of M
// and N itself, and D is a runtime argument (D <= 768).
//
// Hopper has no sequential grid to carry a running sum across, so the loop
// over the streamed dimension sits inside the block: in the forward and in
// dA one block owns a row tile and walks the column tiles; in dB one block
// owns a column tile and walks the row tiles (the transposed grid of
// fused_ce.py:206-220). Nothing is summed across blocks, so there are no
// atomics and two runs agree bit for bit.
//
// What bounds it on the H100: the work is 2 M N D flops forward and 4 M N D
// in each backward kernel against (M + N) D input elements, so at M = N =
// 32768, D = 512 it is bound by operations (1.1 + 2 x 2.2 TFLOP over 67 MB in
// bf16), and at the one-step shape M = N = 256 by launch latency. This first
// version runs every product as fp32 FMAs on the CUDA cores: a 16 x 16
// thread block holds the [rows, cols] tile of raw dots in registers, fed
// from shared-memory chunks of 32 features stored feature-major with odd row
// strides (conflict-free stores, broadcast loads): csrc/stream_tile.cuh,
// shared with csrc/fused_mlp.cu. The backward kernels put dz for the tile
// in shared memory and then each warp adds dz times the streamed matrix's rows (read through L1/L2,
// lanes on consecutive features) into its 4 owned rows of the fp32 output,
// all D features of them in registers. Moving the products onto the tensor
// cores (bf16 mma.sync / wgmma for the dots, TF32 or split-bf16 for the
// fp32 second product) is the next step.

#include "stream_tile.cuh"

namespace {

using colxlip::to_f;
using namespace colxlip::stream_tile;

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// forward: one block per tile of 64 rows of a, looping over tiles of 64 rows
// of b
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b, const int* __restrict__ labels,
              const float* __restrict__ scale_ptr, float* __restrict__ loss,
              float* __restrict__ lse, int m, int n, int d) {
  constexpr int RPT = 4, CPT = 4;
  constexpr int BM = kTY * RPT, BN = kTX * CPT;
  __shared__ Stage<RPT, CPT> st;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int i0 = blockIdx.x * BM;
  const float scale = *scale_ptr;

  float mx[RPT], sum[RPT], zt[RPT];
  int lab[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i0 + ty + kTY * r;
    mx[r] = kNeg;
    sum[r] = 0.f;
    zt[r] = 0.f;
    lab[r] = row < m ? labels[row] : -1;
  }

  for (int j0 = 0; j0 < n; j0 += BN) {
    float acc[RPT][CPT];
    raw_tile<T, RPT, CPT>(a, b, i0, j0, m, n, d, st, acc);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float tmax = kNeg;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = j0 + tx + kTX * c;
        const float z = col < n ? scale * acc[r][c] : kNeg;
        acc[r][c] = z;
        tmax = fmaxf(tmax, z);
        if (col == lab[r]) zt[r] += z;
      }
      const float mnew = fmaxf(mx[r], row_max(tmax));
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) part += expf(acc[r][c] - mnew);  // masked: exp(-1e30) = 0
      sum[r] = sum[r] * expf(mx[r] - mnew) + row_sum(part);
      mx[r] = mnew;
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i0 + ty + kTY * r;
    const float label_logit = row_sum(zt[r]);
    if (tx == 0 && row < m) {
      const float l = mx[r] + logf(sum[r]);
      lse[row] = l;
      loss[row] = l - label_logit;
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dA and per-row dscale: one block per tile of 32 rows of a, looping over
// tiles of 64 rows of b.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
ce_bwd_da_kernel(const T* __restrict__ a, const T* __restrict__ b, const int* __restrict__ labels,
                 const float* __restrict__ scale_ptr, const float* __restrict__ lse,
                 const float* __restrict__ g, float* __restrict__ da,
                 float* __restrict__ dscale, int m, int n, int d) {
  constexpr int RPT = kOwn / kTY, CPT = kStream / kTX;
  __shared__ Stage<RPT, CPT> st;
  __shared__ float dz[kOwn][kStream + 1];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int i0 = blockIdx.x * kOwn;
  const float scale = *scale_ptr;

  float lse_r[RPT], g_r[RPT], ds[RPT];
  int lab[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i0 + ty + kTY * r;
    const bool in = row < m;
    lse_r[r] = in ? lse[row] : 0.f;
    g_r[r] = in ? g[row] : 0.f;
    lab[r] = in ? labels[row] : -1;
    ds[r] = 0.f;
  }
  float out[kOwnPerWarp][DPT];
  zero_owned<DPT>(out);

  for (int j0 = 0; j0 < n; j0 += kStream) {
    float acc[RPT][CPT];
    raw_tile<T, RPT, CPT>(a, b, i0, j0, m, n, d, st, acc);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const bool row_in = i0 + ty + kTY * r < m;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = j0 + tx + kTX * c;
        float v = 0.f;
        if (row_in && col < n) {
          const float p = expf(scale * acc[r][c] - lse_r[r]);
          v = (p - (col == lab[r] ? 1.f : 0.f)) * g_r[r];
        }
        ds[r] = fmaf(v, acc[r][c], ds[r]);
        dz[ty + kTY * r][tx + kTX * c] = v;
      }
    }
    __syncthreads();
    accumulate<T, DPT>(dz, b + size_t(j0) * d, min(kStream, n - j0), d, out);
    __syncthreads();
  }

  store_owned<DPT>(out, da, i0, m, d, scale);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i0 + ty + kTY * r;
    const float total = row_sum(ds[r]);
    if (tx == 0 && row < m) dscale[row] = total;
  }
}

// dB: one block per tile of 32 rows of b, looping over tiles of 64 rows of a.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
ce_bwd_db_kernel(const T* __restrict__ a, const T* __restrict__ b, const int* __restrict__ labels,
                 const float* __restrict__ scale_ptr, const float* __restrict__ lse,
                 const float* __restrict__ g, float* __restrict__ db, int m, int n, int d) {
  constexpr int RPT = kStream / kTY, CPT = kOwn / kTX;
  __shared__ Stage<RPT, CPT> st;
  __shared__ float dz[kOwn][kStream + 1];  // [column of the tile][row of the tile]
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int j0 = blockIdx.x * kOwn;
  const float scale = *scale_ptr;

  float out[kOwnPerWarp][DPT];
  zero_owned<DPT>(out);

  for (int i0 = 0; i0 < m; i0 += kStream) {
    float acc[RPT][CPT];
    raw_tile<T, RPT, CPT>(a, b, i0, j0, m, n, d, st, acc);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = i0 + ty + kTY * r;
      const bool row_in = row < m;
      const float lse_r = row_in ? lse[row] : 0.f;
      const float g_r = row_in ? g[row] : 0.f;
      const int lab = row_in ? labels[row] : -1;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = j0 + tx + kTX * c;
        float v = 0.f;
        if (row_in && col < n) {
          const float p = expf(scale * acc[r][c] - lse_r);
          v = (p - (col == lab ? 1.f : 0.f)) * g_r;
        }
        dz[tx + kTX * c][ty + kTY * r] = v;
      }
    }
    __syncthreads();
    accumulate<T, DPT>(dz, a + size_t(i0) * d, min(kStream, m - i0), d, out);
    __syncthreads();
  }

  store_owned<DPT>(out, db, j0, n, d, scale);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void* a;
  const void* b;
  const int* labels;
  const float* scale;
  const float* lse;
  const float* g;
  int m, n, d;
  cudaStream_t stream;
};

template <typename T, int DPT>
cudaError_t launch_da(const Args& x, float* da, float* dscale) {
  ce_bwd_da_kernel<T, DPT><<<(x.m + kOwn - 1) / kOwn, kThreads, 0, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), x.labels, x.scale, x.lse, x.g, da,
      dscale, x.m, x.n, x.d);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t launch_db(const Args& x, float* db) {
  ce_bwd_db_kernel<T, DPT><<<(x.n + kOwn - 1) / kOwn, kThreads, 0, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), x.labels, x.scale, x.lse, x.g, db,
      x.m, x.n, x.d);
  return cudaGetLastError();
}

// The per-thread feature count is a template argument (the accumulators live
// in registers): 32 * DPT >= D.
template <typename T>
cudaError_t dispatch_da(const Args& x, float* da, float* dscale) {
  if (x.d <= 64) return launch_da<T, 2>(x, da, dscale);
  if (x.d <= 256) return launch_da<T, 8>(x, da, dscale);
  if (x.d <= 512) return launch_da<T, 16>(x, da, dscale);
  return launch_da<T, 24>(x, da, dscale);
}

template <typename T>
cudaError_t dispatch_db(const Args& x, float* db) {
  if (x.d <= 64) return launch_db<T, 2>(x, db);
  if (x.d <= 256) return launch_db<T, 8>(x, db);
  if (x.d <= 512) return launch_db<T, 16>(x, db);
  return launch_db<T, 24>(x, db);
}

bool bad_shape(int m, int n, int d, int dtype) {
  return m < 1 || n < 1 || d < 1 || d > kMaxD || (dtype != 0 && dtype != 1);
}

}  // namespace

// a [M, D], b [N, D] (dtype 0 = float32, 1 = bfloat16), labels [M] int32,
// scale: one float32 on the device; out loss [M], lse [M] float32. Returns a
// cudaError_t (0 = launched).
extern "C" int colxlip_fused_ce_fwd(const void* a, const void* b, const void* labels,
                                    const void* scale, void* loss, void* lse, int m, int n, int d,
                                    int dtype, void* stream) {
  if (bad_shape(m, n, d, dtype)) return cudaErrorInvalidValue;
  constexpr int BM = kTY * 4;
  const int grid = (m + BM - 1) / BM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* sc = static_cast<const float*>(scale);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    ce_fwd_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(a),
                                                   static_cast<const float*>(b), lab, sc, lo, ls,
                                                   m, n, d);
  else
    ce_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), lab, sc, lo,
        ls, m, n, d);
  return cudaGetLastError();
}

// As the forward, plus lse [M] and g [M] float32 (the cotangent of the loss
// rows); out da [M, D] and dscale [M] float32.
extern "C" int colxlip_fused_ce_bwd_da(const void* a, const void* b, const void* labels,
                                       const void* scale, const void* lse, const void* g,
                                       void* da, void* dscale, int m, int n, int d, int dtype,
                                       void* stream) {
  if (bad_shape(m, n, d, dtype)) return cudaErrorInvalidValue;
  const Args x{a, b, static_cast<const int*>(labels), static_cast<const float*>(scale),
               static_cast<const float*>(lse), static_cast<const float*>(g), m, n, d,
               static_cast<cudaStream_t>(stream)};
  float* out = static_cast<float*>(da);
  float* ds = static_cast<float*>(dscale);
  return dtype == 0 ? dispatch_da<float>(x, out, ds) : dispatch_da<__nv_bfloat16>(x, out, ds);
}

// As colxlip_fused_ce_bwd_da; out db [N, D] float32.
extern "C" int colxlip_fused_ce_bwd_db(const void* a, const void* b, const void* labels,
                                       const void* scale, const void* lse, const void* g,
                                       void* db, int m, int n, int d, int dtype, void* stream) {
  if (bad_shape(m, n, d, dtype)) return cudaErrorInvalidValue;
  const Args x{a, b, static_cast<const int*>(labels), static_cast<const float*>(scale),
               static_cast<const float*>(lse), static_cast<const float*>(g), m, n, d,
               static_cast<cudaStream_t>(stream)};
  float* out = static_cast<float*>(db);
  return dtype == 0 ? dispatch_db<float>(x, out) : dispatch_db<__nv_bfloat16>(x, out);
}
