// LayerNorm over the last axis, forward and backward, for Hopper (sm_90a):
// fp32 statistics over a float32 or bfloat16 stream, one read of x per
// direction, nothing saved for the backward but x.
//
// Replaces: colxlip_tpu/ops/fused_ln.py `_fwd_call` (:90, body `_fwd_kernel`
// :58) and `_bwd_call` (:123, body `_bwd_kernel` :68). Same arithmetic:
//
//   forward   mu = mean(x), xc = x - mu, var = mean(xc * xc)  (two passes
//             over the row in registers, not E[x^2] - E[x]^2),
//             y = xc * rsqrt(var + eps) * gamma + beta, cast to x's type
//   backward  mu and rstd recomputed from x; xhat = xc * rstd,
//             gdo = dy * gamma, m1 = mean(gdo), m2 = mean(gdo * xhat),
//             dx = rstd * (gdo - m1 - xhat * m2) in x's type;
//             dgamma = sum over rows of dy * xhat, dbeta = sum over rows of
//             dy, both fp32
//
// One warp owns a row and holds it in registers (lane l has columns l, l +
// 32, ...; the per-lane count is a template bucket, D <= 1024), so the
// statistics are two warp reductions and the row is read once. The TPU
// kernel sums dgamma and dbeta across its sequential grid. Here each warp
// sums the rows it walks in registers, the block's warps add up in warp
// order through shared memory, each block writes one partial row, and a
// second small kernel adds the partial rows in block order: no atomics, so
// two runs agree bit for bit.
//
// What bounds it on the H100: bytes. The forward moves 2 R D elements and
// the backward 3 R D against about 8 and 16 operations an element; at the
// vision shape (50,432 x 768, bf16) that is 155 and 232 MB, 0.05 and 0.07
// ms at 3.35 TB/s. The loads are one element a lane (a warp reads 64
// contiguous bytes of bf16 at a time), not 16-byte vectors: the simple
// version first.

#include "stream_tile.cuh"

namespace {

using colxlip::from_f;
using colxlip::to_f;
using colxlip::warp_sum;
using colxlip::stream_tile::reduce_partials;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 1024;

// Reads row `xr` into v (0 past D), then v = x - mean; returns rstd.
template <typename T, int DPT>
__device__ __forceinline__ float center_row(const T* __restrict__ xr, int d, float eps,
                                            float (&v)[DPT]) {
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    const int col = lane + 32 * c;
    v[c] = col < d ? to_f(xr[col]) : 0.f;
    sum += v[c];
  }
  const float mu = warp_sum(sum) / float(d);
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < DPT; ++c) {
    v[c] = lane + 32 * c < d ? v[c] - mu : 0.f;
    sq = fmaf(v[c], v[c], sq);
  }
  return rsqrtf(warp_sum(sq) / float(d) + eps);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    float v[DPT];
    const float rstd = center_row<T, DPT>(x + size_t(row) * d, d, eps, v);
    T* yr = y + size_t(row) * d;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = lane + 32 * c;
      if (col < d) yr[col] = from_f<T>(v[c] * rstd * gamma[col] + beta[col]);
    }
  }
}

// partials: [gridDim.x][2][d] fp32, row 0 the block's dgamma, row 1 its dbeta.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partials,
              int rows, int d, float eps) {
  __shared__ float red[2][kMaxD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float dg[DPT], db[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dg[c] = db[c] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    float v[DPT], go[DPT];
    const float rstd = center_row<T, DPT>(x + size_t(row) * d, d, eps, v);
    const T* dyr = dy + size_t(row) * d;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = lane + 32 * c;
      const float o = col < d ? to_f(dyr[col]) : 0.f;
      v[c] *= rstd;                                   // xhat
      go[c] = col < d ? o * gamma[col] : 0.f;         // dy * gamma
      s1 += go[c];
      s2 = fmaf(go[c], v[c], s2);
      dg[c] = fmaf(o, v[c], dg[c]);
      db[c] += o;
    }
    const float m1 = warp_sum(s1) / float(d), m2 = warp_sum(s2) / float(d);
    T* dxr = dx + size_t(row) * d;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = lane + 32 * c;
      if (col < d) dxr[col] = from_f<T>(rstd * (go[c] - m1 - v[c] * m2));
    }
  }

  // the block's warps add up in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = lane + 32 * c;
        if (col < d) {
          red[0][col] = (w == 0 ? 0.f : red[0][col]) + dg[c];
          red[1][col] = (w == 0 ? 0.f : red[1][col]) + db[c];
        }
      }
    }
    __syncthreads();
  }
  float* part = partials + size_t(blockIdx.x) * 2 * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    part[col] = red[0][col];
    part[d + col] = red[1][col];
  }
}

struct Args {
  const void* x;
  const float* gamma;
  int rows, d;
  float eps;
  cudaStream_t stream;
};

template <typename T, int DPT>
cudaError_t launch_fwd(const Args& a, const float* beta, void* y) {
  const int want = (a.rows + kWarps - 1) / kWarps, cap = 132 * 16;   // then a grid-stride loop
  const int grid = want < cap ? want : cap;
  ln_fwd_kernel<T, DPT><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.gamma, beta, static_cast<T*>(y), a.rows, a.d, a.eps);
  return cudaGetLastError();
}

template <typename T, int DPT>
cudaError_t launch_bwd(const Args& a, const void* dy, void* dx, float* partials, int blocks) {
  ln_bwd_kernel<T, DPT><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.gamma, static_cast<const T*>(dy), static_cast<T*>(dx),
      partials, a.rows, a.d, a.eps);
  return cudaGetLastError();
}

// The per-lane column count is a template argument (the row lives in
// registers): 32 * DPT >= D.
template <typename T>
cudaError_t dispatch_fwd(const Args& a, const float* beta, void* y) {
  if (a.d <= 128) return launch_fwd<T, 4>(a, beta, y);
  if (a.d <= 256) return launch_fwd<T, 8>(a, beta, y);
  if (a.d <= 512) return launch_fwd<T, 16>(a, beta, y);
  if (a.d <= 768) return launch_fwd<T, 24>(a, beta, y);
  return launch_fwd<T, 32>(a, beta, y);
}

template <typename T>
cudaError_t dispatch_bwd(const Args& a, const void* dy, void* dx, float* partials, int blocks) {
  if (a.d <= 128) return launch_bwd<T, 4>(a, dy, dx, partials, blocks);
  if (a.d <= 256) return launch_bwd<T, 8>(a, dy, dx, partials, blocks);
  if (a.d <= 512) return launch_bwd<T, 16>(a, dy, dx, partials, blocks);
  if (a.d <= 768) return launch_bwd<T, 24>(a, dy, dx, partials, blocks);
  return launch_bwd<T, 32>(a, dy, dx, partials, blocks);
}

bool bad_shape(int rows, int d, int dtype) {
  return rows < 1 || d < 1 || d > kMaxD || (dtype != 0 && dtype != 1);
}

}  // namespace

// x, y [rows, d] (dtype 0 = float32, 1 = bfloat16); gamma, beta [d] float32.
// Returns a cudaError_t (0 = launched).
extern "C" int colxlip_fused_ln_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                    int rows, int d, float eps, int dtype, void* stream) {
  if (bad_shape(rows, d, dtype)) return cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(gamma), rows, d, eps,
               static_cast<cudaStream_t>(stream)};
  const float* b = static_cast<const float*>(beta);
  return dtype == 0 ? dispatch_fwd<float>(a, b, y) : dispatch_fwd<__nv_bfloat16>(a, b, y);
}

// x, dy, dx [rows, d]; gamma [d] float32; partials: scratch of blocks * 2 * d
// float32; dgb [2, d] float32: dgamma then dbeta.
extern "C" int colxlip_fused_ln_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                                    void* partials, void* dgb, int rows, int d, float eps,
                                    int blocks, int dtype, void* stream) {
  if (bad_shape(rows, d, dtype) || blocks < 1) return cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(gamma), rows, d, eps,
               static_cast<cudaStream_t>(stream)};
  float* part = static_cast<float*>(partials);
  const cudaError_t err = dtype == 0 ? dispatch_bwd<float>(a, dy, dx, part, blocks)
                                     : dispatch_bwd<__nv_bfloat16>(a, dy, dx, part, blocks);
  if (err != cudaSuccess) return err;
  return reduce_partials(part, static_cast<float*>(dgb), blocks, 2 * d, a.stream);
}
