// Transformer MLP c_fc -> GELU -> c_proj in one kernel, with a recompute
// backward, for Hopper (sm_90a): no [rows, H] tensor ever reaches device
// memory, forward or backward.
//
// Replaces: colxlip_tpu/ops/fused_mlp.py `_fwd_call` (:244, body
// `_fwd_kernel` :182) and `_bwd_call` (:278, body `_bwd_kernel` :198). Same
// arithmetic, with T the compute dtype (float32 or bfloat16) and every
// product summed in fp32:
//
//   forward   h = T(T(x W1) + b1); a = T(gelu_fp32(h)); out = T(T(a W2) + b2)
//   backward  h, a and gelu'(h) recomputed from x;
//             da = dy W2^T (fp32, not rounded); dh = T(gelu'(h) * da);
//             dx = T(dh W1^T); dW1 = x^T dh, db1 = sum_rows dh,
//             dW2 = a^T dy, db2 = sum_rows dy, the four in fp32
//
// gelu is the TPU kernel's: the exact branch is the Abramowitz-Stegun 7.1.26
// erf polynomial (`_erf_poly` :52; value `_kernel_gelu` :60, derivative cdf +
// x pdf in `_kernel_gelu_and_grad` :133), not erff; the tanh branch is the
// closed form.
//
// Layout: both weights arrive hidden-major, W1 as [H, D] (the c_fc.weight
// of the port's Linear as it is) and W2 as [H, D] (c_proj.weight
// transposed, which is the TPU kernel's own W2 layout), so that every
// product reads contiguous rows; dW1 and dW2 leave in the same layout.
//
// Where the TPU design cannot be carried over: it keeps W1 and W2 resident
// in VMEM and walks batch rows on a sequential grid, summing dW across grid
// steps. An SM has 227 KB of shared memory, so the weights are streamed, and
// a CUDA grid has no order, so nothing is summed across blocks in place:
//
//   forward   a block owns 32 rows of x and walks the hidden dimension in
//             slices of 64: the slice of h comes from a register tile
//             (stream_tile.cuh raw_tile), becomes a in shared memory, and
//             its product with the slice's 64 rows of W2 is added into the
//             block's [32, D] output, held in registers (accumulate)
//   dx        the same walk: gelu'(h) and da from two register tiles, dh in
//             shared memory, dx += dh times the slice's rows of W1
//   dW1, db1  a block owns 32 hidden units and walks the rows of x in tiles
//             of 64, recomputing h and da for its slice: dW1 += dh^T x
//   dW2       the same walk with a in place of dh and dy in place of x
//   db2       a column sum of dy
//
// The row walk of dW1 / dW2 is cut into `splits` ranges so that H / 32
// blocks times splits fill the card; each range writes its partial sums to
// scratch and a second kernel adds them in range order (reduce_partials), as
// db1 and db2 do: no atomics, so two runs agree bit for bit.
//
// What bounds it on the H100: operations. Forward 4 R D H flops; the backward
// needs 10 R D H (five products: h recomputed once, dW2, da, dW1, dx) and
// does 16 here (h is recomputed three times and da twice, once in each
// pass) over (2 R D + 2 D H) and (3 R D + 6 D H) elements: at the
// vision shape (R = 50,432, D = 768, H = 3072, bf16) 0.48 ms forward at 989
// TFLOP/s. This first version runs every product as fp32 FMAs on the CUDA
// cores, so it is some 70 times off that bound; bf16 mma.sync / wgmma tiles
// are the next step.

#include "stream_tile.cuh"

namespace {

using colxlip::from_f;
using colxlip::round_to;
using colxlip::to_f;
using colxlip::warp_sum;
using namespace colxlip::stream_tile;

constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
constexpr float kTanhCubic = 0.044715f;

// Abramowitz-Stegun 7.1.26, |error| <= 1.5e-7.
__device__ __forceinline__ float erf_poly(float x) {
  const float a = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return sign * (1.f - poly * expf(-a * a));
}

__device__ __forceinline__ float gelu_value(float x, bool approximate) {
  if (approximate) {
    const float u = kSqrt2OverPi * (x + kTanhCubic * x * x * x);
    return 0.5f * x * (1.f + tanhf(u));
  }
  return 0.5f * x * (1.f + erf_poly(x * kSqrtHalf));
}

__device__ __forceinline__ float gelu_grad(float x, bool approximate) {
  if (approximate) {
    const float u = kSqrt2OverPi * (x + kTanhCubic * x * x * x);
    const float t = tanhf(u);
    const float du = kSqrt2OverPi * (1.f + 3.f * kTanhCubic * x * x);
    return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
  }
  const float cdf = 0.5f * (1.f + erf_poly(x * kSqrtHalf));
  const float pdf = kInvSqrt2Pi * expf(-0.5f * x * x);
  return cdf + x * pdf;
}

// The pre-activation as the compute dtype sees it: the product rounded to T,
// the bias added in T.
template <typename T>
__device__ __forceinline__ float pre_activation(float dot, float bias) {
  return round_to<T>(round_to<T>(dot) + bias);
}

// ---------------------------------------------------------------------------
// forward and dx: one block per tile of 32 rows, looping over slices of 64
// hidden units
// ---------------------------------------------------------------------------

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out, int rows,
               int d, int h, int approximate) {
  constexpr int RPT = kOwn / kTY, CPT = kStream / kTX;
  __shared__ Stage<RPT, CPT> st;
  __shared__ float act[kOwn][kStream + 1];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int i0 = blockIdx.x * kOwn;
  float acc_out[kOwnPerWarp][DPT];
  zero_owned<DPT>(acc_out);

  for (int h0 = 0; h0 < h; h0 += kStream) {
    float acc[RPT][CPT];
    raw_tile<T, RPT, CPT>(x, w1, i0, h0, rows, h, d, st, acc);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = h0 + tx + kTX * c;
      const float bias = col < h ? to_f(b1[col]) : 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float a = 0.f;
        if (col < h) a = round_to<T>(gelu_value(pre_activation<T>(acc[r][c], bias), approximate));
        act[ty + kTY * r][tx + kTX * c] = a;
      }
    }
    __syncthreads();
    accumulate<T, DPT>(act, w2 + size_t(h0) * d, min(kStream, h - h0), d, acc_out);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kOwnPerWarp; ++r) {
    const int row = i0 + kOwnPerWarp * warp + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = lane + 32 * c;
      if (col < d)
        out[size_t(row) * d + col] = from_f<T>(round_to<T>(acc_out[r][c]) + to_f(b2[col]));
    }
  }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ dy, T* __restrict__ dx,
                  int rows, int d, int h, int approximate) {
  constexpr int RPT = kOwn / kTY, CPT = kStream / kTX;
  __shared__ Stage<RPT, CPT> st;
  __shared__ float dh[kOwn][kStream + 1];
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int i0 = blockIdx.x * kOwn;
  float acc_out[kOwnPerWarp][DPT];
  zero_owned<DPT>(acc_out);

  for (int h0 = 0; h0 < h; h0 += kStream) {
    float grad[RPT][CPT], da[RPT][CPT];
    raw_tile<T, RPT, CPT>(x, w1, i0, h0, rows, h, d, st, grad);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = h0 + tx + kTX * c;
      const float bias = col < h ? to_f(b1[col]) : 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        grad[r][c] = col < h ? gelu_grad(pre_activation<T>(grad[r][c], bias), approximate) : 0.f;
    }
    raw_tile<T, RPT, CPT>(dy, w2, i0, h0, rows, h, d, st, da);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        dh[ty + kTY * r][tx + kTX * c] = round_to<T>(grad[r][c] * da[r][c]);
    __syncthreads();
    accumulate<T, DPT>(dh, w1 + size_t(h0) * d, min(kStream, h - h0), d, acc_out);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kOwnPerWarp; ++r) {
    const int row = i0 + kOwnPerWarp * warp + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = lane + 32 * c;
      if (col < d) dx[size_t(row) * d + col] = from_f<T>(acc_out[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dW1 + db1 (kFirst) or dW2: one block per slice of 32 hidden units and per
// range of rows, looping over tiles of 64 rows
// ---------------------------------------------------------------------------

// dw_part [gridDim.y][h][d] and db1_part [gridDim.y][h] fp32: this range's
// partial sums (db1_part is written by the kFirst kernel only).
template <typename T, int DPT, bool kFirst>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ dy,
                  float* __restrict__ dw_part, float* __restrict__ db1_part, int rows, int d,
                  int h, int approximate, int rows_per_split) {
  constexpr int RPT = kStream / kTY, CPT = kOwn / kTX;
  __shared__ Stage<RPT, CPT> st;
  __shared__ float z[kOwn][kStream + 1];   // [hidden unit of the slice][row of the tile]
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kOwn;
  const int first = blockIdx.y * rows_per_split;
  const int last = min(rows, first + rows_per_split);   // rows past it read as zero

  float bias[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = j0 + tx + kTX * c;
    bias[c] = col < h ? to_f(b1[col]) : 0.f;
  }
  float out[kOwnPerWarp][DPT], db1[kOwnPerWarp];
  zero_owned<DPT>(out);
#pragma unroll
  for (int r = 0; r < kOwnPerWarp; ++r) db1[r] = 0.f;

  for (int i0 = first; i0 < last; i0 += kStream) {
    float acc[RPT][CPT];
    raw_tile<T, RPT, CPT>(x, w1, i0, j0, last, h, d, st, acc);
    if (kFirst) {
      float da[RPT][CPT];
      raw_tile<T, RPT, CPT>(dy, w2, i0, j0, last, h, d, st, da);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[r][c] = round_to<T>(
              gelu_grad(pre_activation<T>(acc[r][c], bias[c]), approximate) * da[r][c]);
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[r][c] =
              round_to<T>(gelu_value(pre_activation<T>(acc[r][c], bias[c]), approximate));
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const bool row_in = i0 + ty + kTY * r < last;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const bool in = row_in && j0 + tx + kTX * c < h;
        z[tx + kTX * c][ty + kTY * r] = in ? acc[r][c] : 0.f;
      }
    }
    __syncthreads();
    accumulate<T, DPT>(z, (kFirst ? x : dy) + size_t(i0) * d, min(kStream, last - i0), d, out);
    if (kFirst) {
#pragma unroll
      for (int r = 0; r < kOwnPerWarp; ++r) {
        const float* zr = z[kOwnPerWarp * warp + r];
        db1[r] += warp_sum(zr[lane] + zr[lane + 32]);
      }
    }
    __syncthreads();
  }

  store_owned<DPT>(out, dw_part + size_t(blockIdx.y) * h * d, j0, h, d, 1.f);
  if (kFirst && lane == 0) {
#pragma unroll
    for (int r = 0; r < kOwnPerWarp; ++r) {
      const int j = j0 + kOwnPerWarp * warp + r;
      if (j < h) db1_part[size_t(blockIdx.y) * h + j] = db1[r];
    }
  }
}

// partials[blockIdx.x][col] = sum of dy[r, col] over rows r = blockIdx.x,
// blockIdx.x + gridDim.x, ... in fp32.
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ dy, float* __restrict__ partials, int rows,
                              int d) {
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float total = 0.f;
    for (int r = blockIdx.x; r < rows; r += gridDim.x) total += to_f(dy[size_t(r) * d + col]);
    partials[size_t(blockIdx.x) * d + col] = total;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void* x;
  const void* w1;
  const void* b1;
  const void* w2;
  int rows, d, h, approximate;
  cudaStream_t stream;
};

template <typename T, int DPT>
cudaError_t launch_fwd(const Args& a, const void* b2, void* out) {
  mlp_fwd_kernel<T, DPT><<<(a.rows + kOwn - 1) / kOwn, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1), static_cast<const T*>(a.b1),
      static_cast<const T*>(a.w2), static_cast<const T*>(b2), static_cast<T*>(out), a.rows, a.d,
      a.h, a.approximate);
  return cudaGetLastError();
}

struct BwdOut {
  const void* dy;
  void* dx;
  float* dw1;
  float* db1;
  float* dw2;
  float* db2;
  float* scratch;   // splits * h * d + splits * h + colsum_blocks * d floats
  int splits, colsum_blocks;
};

template <typename T, int DPT>
cudaError_t launch_bwd(const Args& a, const BwdOut& o) {
  const T* x = static_cast<const T*>(a.x);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* w2 = static_cast<const T*>(a.w2);
  const T* dy = static_cast<const T*>(o.dy);
  float* dw_part = o.scratch;
  float* db1_part = dw_part + size_t(o.splits) * a.h * a.d;
  float* db2_part = db1_part + size_t(o.splits) * a.h;
  cudaError_t err;

  mlp_bwd_dx_kernel<T, DPT><<<(a.rows + kOwn - 1) / kOwn, kThreads, 0, a.stream>>>(
      x, w1, b1, w2, dy, static_cast<T*>(o.dx), a.rows, a.d, a.h, a.approximate);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  colsum_kernel<T><<<o.colsum_blocks, 256, 0, a.stream>>>(dy, db2_part, a.rows, a.d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(db2_part, o.db2, o.colsum_blocks, a.d, a.stream)) != cudaSuccess)
    return err;

  // whole tiles of 64 rows to each range
  const int tiles = (a.rows + kStream - 1) / kStream;
  const int rows_per_split = (tiles + o.splits - 1) / o.splits * kStream;
  const dim3 grid((a.h + kOwn - 1) / kOwn, o.splits);
  mlp_bwd_dw_kernel<T, DPT, true><<<grid, kThreads, 0, a.stream>>>(
      x, w1, b1, w2, dy, dw_part, db1_part, a.rows, a.d, a.h, a.approximate, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(dw_part, o.dw1, o.splits, a.h * a.d, a.stream)) != cudaSuccess)
    return err;
  if ((err = reduce_partials(db1_part, o.db1, o.splits, a.h, a.stream)) != cudaSuccess)
    return err;

  mlp_bwd_dw_kernel<T, DPT, false><<<grid, kThreads, 0, a.stream>>>(
      x, w1, b1, w2, dy, dw_part, db1_part, a.rows, a.d, a.h, a.approximate, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(dw_part, o.dw2, o.splits, a.h * a.d, a.stream);
}

// The per-thread feature count is a template argument (the accumulators live
// in registers): 32 * DPT >= D.
template <typename T>
cudaError_t dispatch_fwd(const Args& a, const void* b2, void* out) {
  if (a.d <= 256) return launch_fwd<T, 8>(a, b2, out);
  if (a.d <= 512) return launch_fwd<T, 16>(a, b2, out);
  return launch_fwd<T, 24>(a, b2, out);
}

template <typename T>
cudaError_t dispatch_bwd(const Args& a, const BwdOut& o) {
  if (a.d <= 256) return launch_bwd<T, 8>(a, o);
  if (a.d <= 512) return launch_bwd<T, 16>(a, o);
  return launch_bwd<T, 24>(a, o);
}

bool bad_shape(int rows, int d, int h, int dtype) {
  return rows < 1 || d < 1 || d > kMaxD || h < 1 || (dtype != 0 && dtype != 1);
}

}  // namespace

// x, out [rows, d]; w1, w2 [h, d]; b1 [h]; b2 [d], all of one dtype (0 =
// float32, 1 = bfloat16). Returns a cudaError_t (0 = launched).
extern "C" int colxlip_fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* out, int rows, int d,
                                     int h, int approximate, int dtype, void* stream) {
  if (bad_shape(rows, d, h, dtype)) return cudaErrorInvalidValue;
  const Args a{x, w1, b1, w2, rows, d, h, approximate, static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? dispatch_fwd<float>(a, b2, out) : dispatch_fwd<__nv_bfloat16>(a, b2, out);
}

// As the forward, plus dy, dx [rows, d] in the same dtype; out dw1, dw2 [h, d],
// db1 [h], db2 [d] float32; scratch: splits * h * d + splits * h +
// colsum_blocks * d float32.
extern "C" int colxlip_fused_mlp_bwd(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* dy, void* dx, void* dw1,
                                     void* db1, void* dw2, void* db2, void* scratch, int rows,
                                     int d, int h, int approximate, int splits,
                                     int colsum_blocks, int dtype, void* stream) {
  if (bad_shape(rows, d, h, dtype) || splits < 1 || colsum_blocks < 1)
    return cudaErrorInvalidValue;
  const Args a{x, w1, b1, w2, rows, d, h, approximate, static_cast<cudaStream_t>(stream)};
  const BwdOut o{dy,
                 dx,
                 static_cast<float*>(dw1),
                 static_cast<float*>(db1),
                 static_cast<float*>(dw2),
                 static_cast<float*>(db2),
                 static_cast<float*>(scratch),
                 splits,
                 colsum_blocks};
  return dtype == 0 ? dispatch_bwd<float>(a, o) : dispatch_bwd<__nv_bfloat16>(a, o);
}
