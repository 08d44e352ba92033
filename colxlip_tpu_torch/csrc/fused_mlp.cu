// Transformer MLP c_fc -> GELU -> c_proj with a recompute backward, for
// Hopper (sm_90a): no [rows, H] tensor reaches device memory, forward or
// backward. In bf16 only an L2-sized [R_c, H] chunk of it does.
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
// transposed, which is the TPU kernel's own W2 layout); dW1 and dW2 leave in
// the same layout.
//
// What bounds it on the H100: operations. The forward is two products, 4 R D
// H flops; the backward five, 10 R D H (h recomputed once, da, dW2, dW1,
// dx), over (2 R D + 2 D H) and (3 R D + 6 D H) elements: at the vision shape
// (R = 50,432, D = 768, H = 3072, bf16) 0.48 ms forward and 1.20 ms backward
// at 989 TFLOP/s.
//
// bf16: the tensor cores. The TPU design keeps W1, W2 and a [rows, H] block
// in VMEM and chains the two products in one kernel. On Hopper the [rows, D]
// output of such a chain would sit in registers (192 fp32 a thread at 64
// rows and D = 768), so the products run one at a time instead, each as one
// hand-written mma.sync GEMM tile (mlp_gemm.cuh) with its epilogue, over the
// rows in chunks of R_c (chosen by the wrapper so that the chunk's hidden
// tiles stay in the 50 MB L2: 2048 rows at H = 3072 backward, 12 MiB a tile,
// and 4096 forward, where one tile is live):
//
//   forward, per chunk                     epilogue
//     x W1^T   kNT  -> ws [R_c, H]         a = T(gelu(T(T(acc) + b1)))
//     a W2     kNN  -> out rows            T(T(acc) + b2)
//   backward: db2 = column sums of dy (colsum + reduce, once); per chunk
//     x W1^T   kNT  -> ws [R_c, H]         h = T(T(acc) + b1)
//     dy W2^T  kNT  -> dh [R_c, H]         acc is da, fp32: reads h, writes
//                                          dh = T(gelu'(h) da), a over h, and
//                                          each warp's column sums of dh
//     a^T dy   kTN  -> dW2                 the first chunk stores, later add
//     dh^T x   kTN  -> dW1                 the same
//     dh W1    kNN  -> dx rows             T(acc)
//   then db1 = the warps' column sums added in a fixed order.
//
// That is the function's own 4 and 10 R D H: h is computed once a chunk and
// da once. The weight-gradient products bound K at the chunk's real rows.
// Every sum is taken in one fixed order (K in steps of 64 inside a tile,
// chunks in order on one stream, partial sums reduced in index order), with
// no atomics, so two runs agree bit for bit.
//
// Roundings (the forward). A tile sums K in another order than any other
// implementation: where a sum lies near a midpoint between two bf16 values,
// two correct orders round it apart, and the bias added after that rounding
// can make one step two. The forward is held to the exact function within
// what its fp32 sums and its fp32 GELU allow (ops/fused_mlp_check.py derives
// the per-element bar), not to another implementation's order. The
// backward's outputs round once (dx, dh) or not at all (dW, db), and are held
// to 2^-7 of the largest gradient.
//
// fp32: the CUDA cores (stream_tile.cuh), any D, as first ported:
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
// db1 and db2 do. This path computes 16 R D H (h three times, da twice) as
// fp32 FMAs: a split-bf16 product on the tensor cores would not keep fp32's
// sums (maxsim_tile.cuh says why).
//
// Past D = 768 (ViT-L's 1024) the owned [32, D] tile would not fit in
// registers, so the owned features are cut into S slices of 512 (blockIdx.y
// of the forward and dx, blockIdx.z of the dW passes), each block
// recomputing the hidden slice it reads: 2 (S + 1) R D H forward and
// 2 (5 S + 3) R D H backward (S = 2 at D = 1024). Each output element is
// summed in the same order as without the cut.

#include <algorithm>

#include "mlp_gemm.cuh"
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
// forward and dx: one block per tile of 32 rows and per slice of 32 DPT
// output features (blockIdx.y), looping over slices of 64 hidden units
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
  const int c0 = blockIdx.y * 32 * DPT, dc = min(32 * DPT, d - c0);
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
    accumulate<T, DPT>(act, w2 + size_t(h0) * d + c0, min(kStream, h - h0), dc, d, acc_out);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kOwnPerWarp; ++r) {
    const int row = i0 + kOwnPerWarp * warp + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = c0 + lane + 32 * c;
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
  const int c0 = blockIdx.y * 32 * DPT, dc = min(32 * DPT, d - c0);
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
    accumulate<T, DPT>(dh, w1 + size_t(h0) * d + c0, min(kStream, h - h0), dc, d, acc_out);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kOwnPerWarp; ++r) {
    const int row = i0 + kOwnPerWarp * warp + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < d) dx[size_t(row) * d + col] = from_f<T>(acc_out[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dW1 + db1 (kFirst) or dW2: one block per slice of 32 hidden units, per
// range of rows and per slice of 32 DPT features (blockIdx.z), looping over
// tiles of 64 rows
// ---------------------------------------------------------------------------

// dw_part [gridDim.y][h][d] and db1_part [gridDim.y][h] fp32: this range's
// partial sums (db1_part is written by the kFirst kernel's first feature
// slice only).
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
  const int c0 = blockIdx.z * 32 * DPT, dc = min(32 * DPT, d - c0);

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
    accumulate<T, DPT>(z, (kFirst ? x : dy) + size_t(i0) * d + c0, min(kStream, last - i0), dc,
                       d, out);
    if (kFirst) {
#pragma unroll
      for (int r = 0; r < kOwnPerWarp; ++r) {
        const float* zr = z[kOwnPerWarp * warp + r];
        db1[r] += warp_sum(zr[lane] + zr[lane + 32]);
      }
    }
    __syncthreads();
  }

  store_owned<DPT>(out, dw_part + size_t(blockIdx.y) * h * d + c0, j0, h, dc, d, 1.f);
  if (kFirst && blockIdx.z == 0 && lane == 0) {
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

// Feature slices of 32 DPT columns: one where D <= 768, more past it, each
// recomputing the hidden slice it needs (h, and da in the backward).
template <int DPT>
int feature_slices(int d) {
  return (d + 32 * DPT - 1) / (32 * DPT);
}

template <typename T, int DPT>
cudaError_t launch_fwd(const Args& a, const void* b2, void* out) {
  const dim3 grid((a.rows + kOwn - 1) / kOwn, feature_slices<DPT>(a.d));
  mlp_fwd_kernel<T, DPT><<<grid, kThreads, 0, a.stream>>>(
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

  const int slices = feature_slices<DPT>(a.d);
  mlp_bwd_dx_kernel<T, DPT><<<dim3((a.rows + kOwn - 1) / kOwn, slices), kThreads, 0,
                              a.stream>>>(
      x, w1, b1, w2, dy, static_cast<T*>(o.dx), a.rows, a.d, a.h, a.approximate);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  colsum_kernel<T><<<o.colsum_blocks, 256, 0, a.stream>>>(dy, db2_part, a.rows, a.d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce_partials(db2_part, o.db2, o.colsum_blocks, a.d, a.stream)) != cudaSuccess)
    return err;

  // whole tiles of 64 rows to each range
  const int tiles = (a.rows + kStream - 1) / kStream;
  const int rows_per_split = (tiles + o.splits - 1) / o.splits * kStream;
  const dim3 grid((a.h + kOwn - 1) / kOwn, o.splits, slices);
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
// in registers): 32 * DPT >= D up to 768; past it slices of 512 features
// (DPT 16), as many as D needs, so any D runs without a larger register tile
// (a [32, 1024] fp32 tile alone would take 128 registers a thread).
template <typename T>
cudaError_t dispatch_fwd(const Args& a, const void* b2, void* out) {
  if (a.d <= 256) return launch_fwd<T, 8>(a, b2, out);
  if (a.d <= 512 || a.d > 768) return launch_fwd<T, 16>(a, b2, out);
  return launch_fwd<T, 24>(a, b2, out);
}

template <typename T>
cudaError_t dispatch_bwd(const Args& a, const BwdOut& o) {
  if (a.d <= 256) return launch_bwd<T, 8>(a, o);
  if (a.d <= 512 || a.d > 768) return launch_bwd<T, 16>(a, o);
  return launch_bwd<T, 24>(a, o);
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores (mlp_gemm.cuh), one epilogue each
// ---------------------------------------------------------------------------

namespace gemm = colxlip::mlp_gemm;
using colxlip::mma::bf16;

enum Epilogue {
  kEpiGelu = 0,    // forward x W1^T: a = T(gelu(T(T(acc) + b1))) -> out
  kEpiPre = 1,     // backward x W1^T: h = T(T(acc) + b1) -> out
  kEpiDh = 2,      // dy W2^T (acc = da): h in out -> a in out, dh, db1 sums
  kEpiBias = 3,    // a W2: T(T(acc) + b2) -> out
  kEpiRound = 4,   // dh W1: T(acc) -> out
  kEpiAcc = 5,     // a^T dy, dh^T x: fp32 out = acc (first chunk) or out + acc
};

__device__ __forceinline__ __nv_bfloat162* bf16_pair(void* base, size_t off) {
  return reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(base) + off);
}

// The GELU value and derivative of two elements, (value 0, value 1,
// derivative 0, derivative 1), called rather than inlined: 32 inlined copies
// a thread of both branches of both functions overflow the instruction cache
// (the dy W2^T product took 3.40 ms inlined and 1.91 called at the vision
// shape on the H100). The forward's value alone stays inlined (1.41 against
// 1.48 ms called).
__device__ __noinline__ float4 gelu_grad_pair(float x0, float x1, int approximate) {
  return make_float4(gelu_value(x0, approximate), gelu_value(x1, approximate),
                     gelu_grad(x0, approximate), gelu_grad(x1, approximate));
}

struct EpiArgs {
  void* out;          // [m, ldo]: bf16, or fp32 for kEpiAcc
  int ldo;
  const bf16* bias;   // by column: b1 (kEpiGelu, kEpiPre), b2 (kEpiBias)
  bf16* dh;           // kEpiDh: [m, ldo]
  float* db1_part;    // kEpiDh: [2 m / 128][n], one row a warp's 64 rows
  int first;          // kEpiAcc, kEpiDh: store, where later chunks add
  int approximate;
};

// One C tile of one product and its epilogue. A thread holds, of each m16 x
// n8 accumulator tile, rows g and g + 8 at columns 2t and 2t + 1 (as
// mma_tile.cuh lays it out) and writes them as bf16 or fp32 pairs. Rows at
// or past m and columns at or past n (n is a multiple of 8) are never
// written. The epilogues that read device memory (h for kEpiDh, the running
// dW for kEpiAcc) load one m16 row of tiles at a time, every load before any
// store: a store may alias a later load as far as the compiler knows, so
// loads and stores taken in turn would wait out the L2 latency once a pair.
template <int L, int BN, int E>
__global__ void __launch_bounds__(gemm::kThreads, 2)
mlp_gemm_kernel(const gemm::Operands p0, const EpiArgs e0, const gemm::Operands p1,
                const EpiArgs e1) {
  using Tl = gemm::Tile<L, BN>;
  // blockIdx.z picks one of two products of one shape (the two dW share a
  // launch, so that their tiles fill the card's waves together); field by
  // field, so that nothing is copied to local memory
  const bool z = blockIdx.z != 0;
  const gemm::Operands p{z ? p1.a : p0.a, z ? p1.b : p0.b, z ? p1.lda : p0.lda,
                         z ? p1.ldb : p0.ldb, z ? p1.m : p0.m, z ? p1.n : p0.n,
                         z ? p1.k : p0.k};
  const EpiArgs e{z ? e1.out : e0.out,           z ? e1.ldo : e0.ldo,
                  z ? e1.bias : e0.bias,         z ? e1.dh : e0.dh,
                  z ? e1.db1_part : e0.db1_part, z ? e1.first : e0.first,
                  z ? e1.approximate : e0.approximate};
  constexpr int MI = Tl::kMI, NI = Tl::kNI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * gemm::kBM, n0 = blockIdx.x * BN;
  float acc[MI][NI][4];
  gemm::mainloop<L, BN>(acc, reinterpret_cast<bf16*>(smem_raw), p, m0, n0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / Tl::kWarpsN, wn = warp % Tl::kWarpsN;
  const int row0 = m0 + wm * Tl::kWM + (lane >> 2);
  const int col0 = n0 + wn * gemm::kWarpN + 2 * (lane & 3);
  float bias[NI][2];
  float sums[NI][2];   // kEpiDh: this thread's column sums of dh
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = col0 + 8 * ni;
    sums[ni][0] = sums[ni][1] = bias[ni][0] = bias[ni][1] = 0.f;
    if constexpr (E == kEpiGelu || E == kEpiPre || E == kEpiBias) {
      if (col < p.n) {
        bias[ni][0] = to_f(e.bias[col]);
        bias[ni][1] = to_f(e.bias[col + 1]);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    // what this row of tiles reads: h (kEpiDh) or the running dW (kEpiAcc)
    __nv_bfloat162 hv[NI][2];
    float2 old[NI][2];
    if constexpr (E == kEpiDh || E == kEpiAcc) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 16 * mi + 8 * half, col = col0 + 8 * ni;
          if (row >= p.m || col >= p.n) continue;
          const size_t off = size_t(row) * e.ldo + col;
          if constexpr (E == kEpiDh)
            hv[ni][half] = *bf16_pair(e.out, off);
          else if (!e.first)
            old[ni][half] = *reinterpret_cast<const float2*>(static_cast<float*>(e.out) + off);
        }
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 16 * mi + 8 * half, col = col0 + 8 * ni;
        if (row >= p.m || col >= p.n) continue;
        const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        const float bias0 = bias[ni][0], bias1 = bias[ni][1];
        const size_t off = size_t(row) * e.ldo + col;
        if constexpr (E == kEpiGelu) {
          *bf16_pair(e.out, off) = __floats2bfloat162_rn(
              gelu_value(pre_activation<bf16>(v0, bias0), e.approximate),
              gelu_value(pre_activation<bf16>(v1, bias1), e.approximate));
        } else if constexpr (E == kEpiPre) {
          *bf16_pair(e.out, off) = __floats2bfloat162_rn(pre_activation<bf16>(v0, bias0),
                                                         pre_activation<bf16>(v1, bias1));
        } else if constexpr (E == kEpiDh) {
          const float4 ag = gelu_grad_pair(__low2float(hv[ni][half]),
                                           __high2float(hv[ni][half]), e.approximate);
          const float d0 = round_to<bf16>(ag.z * v0), d1 = round_to<bf16>(ag.w * v1);
          *bf16_pair(e.out, off) = __floats2bfloat162_rn(ag.x, ag.y);
          *reinterpret_cast<__nv_bfloat162*>(e.dh + off) = __floats2bfloat162_rn(d0, d1);
          sums[ni][0] += d0;
          sums[ni][1] += d1;
        } else if constexpr (E == kEpiBias) {
          *bf16_pair(e.out, off) =
              __floats2bfloat162_rn(round_to<bf16>(v0) + bias0, round_to<bf16>(v1) + bias1);
        } else if constexpr (E == kEpiRound) {
          *bf16_pair(e.out, off) = __floats2bfloat162_rn(v0, v1);
        } else {
          auto* dst = reinterpret_cast<float2*>(static_cast<float*>(e.out) + off);
          *dst = e.first ? make_float2(v0, v1)
                         : make_float2(old[ni][half].x + v0, old[ni][half].y + v1);
        }
      }
    }
  }
  if constexpr (E == kEpiDh) {
    // the warp's kWM rows of each column: the eight lanes of one column
    // (same lane % 4) add theirs, and lane (lane % 4) stores the sum
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          sums[ni][j] += __shfl_xor_sync(0xffffffffu, sums[ni][j], o);
    if (lane < 4) {
      float* part = e.db1_part + size_t(blockIdx.y * Tl::kWarpsM + wm) * p.n;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = col0 + 8 * ni;
        if (col >= p.n) continue;
        auto* dst = reinterpret_cast<float2*>(part + col);
        const float2 old = e.first ? make_float2(0.f, 0.f) : *dst;
        *dst = make_float2(old.x + sums[ni][0], old.y + sums[ni][1]);
      }
    }
  }
}

#define COLXLIP_TRY(call)                          \
  do {                                             \
    const cudaError_t err_ = (call);               \
    if (err_ != cudaSuccess) return err_;          \
  } while (0)

// One product (`count` 1), or two of the same shape in one grid (`count` 2:
// p1, e1 are the second).
template <int L, int BN, int E>
cudaError_t launch_gemm(const gemm::Operands& p, const EpiArgs& e, cudaStream_t stream,
                        int count = 1, const gemm::Operands* p1 = nullptr,
                        const EpiArgs* e1 = nullptr) {
  using Tl = gemm::Tile<L, BN>;
  // above 48 KB a block: set once per kernel (a failure is returned on every call)
  static const cudaError_t attr =
      cudaFuncSetAttribute(mlp_gemm_kernel<L, BN, E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tl::kBytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + gemm::kBM - 1) / gemm::kBM, count);
  mlp_gemm_kernel<L, BN, E><<<grid, gemm::kThreads, Tl::kBytes, stream>>>(
      p, e, count > 1 ? *p1 : p, count > 1 ? *e1 : e);
  return cudaGetLastError();
}

// Products whose C has D columns (a W2, dh W1, the two dW) take 128 x 64
// tiles where 128 x 128 ones would not give every multiprocessor two blocks.
// The choice changes no sum: every element adds K in the same order.
template <int L, int E>
cudaError_t launch_d_columns(const gemm::Operands& p, const EpiArgs& e, int sms,
                             cudaStream_t stream, int count = 1,
                             const gemm::Operands* p1 = nullptr, const EpiArgs* e1 = nullptr) {
  const long long wide =
      (long long)count * ((p.m + gemm::kBM - 1) / gemm::kBM) * ((p.n + 127) / 128);
  return wide >= 2LL * sms ? launch_gemm<L, 128, E>(p, e, stream, count, p1, e1)
                           : launch_gemm<L, 64, E>(p, e, stream, count, p1, e1);
}

int multiprocessors() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

// ws: [min(rows, chunk), h] bf16 (the forward's chunk holds twice the
// backward's rows: one tile where the backward has two).
cudaError_t bf16_fwd(const Args& a, const void* b2, void* out, bf16* ws, int chunk) {
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const int sms = multiprocessors();
  for (int r0 = 0; r0 < a.rows; r0 += chunk) {
    const int rc = std::min(chunk, a.rows - r0);
    const gemm::Operands up{x + size_t(r0) * a.d, w1, a.d, a.d, rc, a.h, a.d};
    const EpiArgs eu{ws, a.h, static_cast<const bf16*>(a.b1), nullptr, nullptr, 0,
                     a.approximate};
    COLXLIP_TRY((launch_gemm<gemm::kNT, 128, kEpiGelu>(up, eu, a.stream)));
    const gemm::Operands down{ws, static_cast<const bf16*>(a.w2), a.h, a.d, rc, a.d, a.h};
    const EpiArgs ed{static_cast<bf16*>(out) + size_t(r0) * a.d, a.d,
                     static_cast<const bf16*>(b2), nullptr, nullptr, 0, a.approximate};
    COLXLIP_TRY((launch_d_columns<gemm::kNN, kEpiBias>(down, ed, sms, a.stream)));
  }
  return cudaSuccess;
}

// ws: 2 [min(rows, chunk), h] bf16 (h, then a; dh); o.scratch: chunk / 64 * h
// (db1 sums, one row a warp) + colsum_blocks * d (db2 partials, as float32's) fp32.
cudaError_t bf16_bwd(const Args& a, const BwdOut& o, bf16* ws, int chunk) {
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const bf16* dy = static_cast<const bf16*>(o.dy);
  const int cap = std::min(chunk, a.rows);
  bf16* hid = ws;                          // h, then a
  bf16* dh = ws + size_t(cap) * a.h;
  float* db1_part = o.scratch;
  float* db2_part = db1_part + size_t(chunk / 64) * a.h;
  const int sms = multiprocessors();

  // float32's partition of the rows, with a thread for every column (up to
  // 1024) where float32 loops 256 threads over them: the same sums, and a
  // thread's loads no longer wait on another column's (0.23 ms at 256 threads
  // at the vision shape on the H100)
  const int colsum_threads = std::min(1024, (a.d + 31) / 32 * 32);
  colsum_kernel<bf16><<<o.colsum_blocks, colsum_threads, 0, a.stream>>>(dy, db2_part, a.rows,
                                                                       a.d);
  COLXLIP_TRY(cudaGetLastError());
  COLXLIP_TRY(reduce_partials(db2_part, o.db2, o.colsum_blocks, a.d, a.stream));

  for (int r0 = 0; r0 < a.rows; r0 += chunk) {
    const int rc = std::min(chunk, a.rows - r0), first = r0 == 0;
    const bf16* xc = x + size_t(r0) * a.d;
    const bf16* dyc = dy + size_t(r0) * a.d;
    const gemm::Operands up{xc, w1, a.d, a.d, rc, a.h, a.d};
    const EpiArgs e_pre{hid, a.h, static_cast<const bf16*>(a.b1), nullptr, nullptr, 0,
                        a.approximate};
    COLXLIP_TRY((launch_gemm<gemm::kNT, 128, kEpiPre>(up, e_pre, a.stream)));
    const gemm::Operands da{dyc, w2, a.d, a.d, rc, a.h, a.d};
    const EpiArgs e_dh{hid, a.h, nullptr, dh, db1_part, first, a.approximate};
    COLXLIP_TRY((launch_gemm<gemm::kNT, 128, kEpiDh>(da, e_dh, a.stream)));
    // dW2 += a^T dy and dW1 += dh^T x: K is the chunk's rows
    const gemm::Operands gw2{hid, dyc, a.h, a.d, a.h, a.d, rc};
    const EpiArgs e_w2{o.dw2, a.d, nullptr, nullptr, nullptr, first, a.approximate};
    const gemm::Operands gw1{dh, xc, a.h, a.d, a.h, a.d, rc};
    const EpiArgs e_w1{o.dw1, a.d, nullptr, nullptr, nullptr, first, a.approximate};
    COLXLIP_TRY((launch_d_columns<gemm::kTN, kEpiAcc>(gw2, e_w2, sms, a.stream, 2, &gw1, &e_w1)));
    const gemm::Operands gx{dh, w1, a.h, a.d, rc, a.d, a.h};
    const EpiArgs e_dx{static_cast<bf16*>(o.dx) + size_t(r0) * a.d, a.d, nullptr, nullptr,
                       nullptr, 0, a.approximate};
    COLXLIP_TRY((launch_d_columns<gemm::kNN, kEpiRound>(gx, e_dx, sms, a.stream)));
  }
  // the first chunk wrote every warp's row of sums that a later chunk adds to
  return reduce_partials(db1_part, o.db1, 2 * ((cap + gemm::kBM - 1) / gemm::kBM), a.h,
                         a.stream);
}

bool bad_shape(int rows, int d, int h, int dtype, const void* ws, int chunk) {
  if (rows < 1 || d < 1 || h < 1) return true;
  if (dtype == 0) return false;
  return dtype != 1 || d % 8 || h % 8 || ws == nullptr || chunk < gemm::kBM ||
         chunk % gemm::kBM;
}

}  // namespace

// x, out [rows, d]; w1, w2 [h, d]; b1 [h]; b2 [d], all of one dtype (0 =
// float32, 1 = bfloat16). bf16: d and h multiples of 8, x, w1, w2 16-byte
// aligned, chunk_rows a multiple of 128, workspace [min(rows, chunk_rows), h]
// bf16; float32: any d, workspace and chunk_rows unused. Returns a
// cudaError_t (0 = launched).
extern "C" int colxlip_fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* out, void* workspace,
                                     int rows, int d, int h, int approximate, int chunk_rows,
                                     int dtype, void* stream) {
  if (bad_shape(rows, d, h, dtype, workspace, chunk_rows)) return cudaErrorInvalidValue;
  const Args a{x, w1, b1, w2, rows, d, h, approximate, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_fwd<float>(a, b2, out);
  return bf16_fwd(a, b2, out, static_cast<bf16*>(workspace), chunk_rows);
}

// As the forward, plus dy, dx [rows, d] in the same dtype; out dw1, dw2 [h, d],
// db1 [h], db2 [d] float32. float32: scratch splits * h * d + splits * h +
// colsum_blocks * d float32. bf16: scratch chunk_rows / 64 * h + colsum_blocks
// * d float32, workspace 2 [min(rows, chunk_rows), h] bf16, splits unused.
extern "C" int colxlip_fused_mlp_bwd(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* dy, void* dx, void* dw1,
                                     void* db1, void* dw2, void* db2, void* scratch,
                                     void* workspace, int rows, int d, int h, int approximate,
                                     int splits, int colsum_blocks, int chunk_rows, int dtype,
                                     void* stream) {
  if (bad_shape(rows, d, h, dtype, workspace, chunk_rows) || splits < 1 || colsum_blocks < 1)
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
  if (dtype == 0) return dispatch_bwd<float>(a, o);
  return bf16_bwd(a, o, static_cast<bf16*>(workspace), chunk_rows);
}
