// ColBERT MaxSim late-interaction score, backward, for Hopper (sm_90a).
//
// Replaces: colxlip_tpu/ops/maxsim_pallas.py `_bwd_call` (:244; bodies
// `_bwd_dt_kernel` :175 and `_bwd_di_kernel` :210), with the tie convention
// of the streaming custom VJP the TPU main path runs
// (colxlip_tpu/ops/maxsim.py `_maxsim_streaming_bwd`, :197-227): the
// cotangent of max_sim[m, k, n] reaches EVERY image token q that attains the
// max, in full. (The Pallas kernel routes to the first argmax only.)
//
//   coef[m, k, n]    = g[m, k] * w[m, k, n] / (sum_n w + 1e-8)
//                      ('plain': g[m, k] / Lt), w from the mask mode
//   dT[m, n, :]      = sum_k coef[m, k, n] * sum_{q tied at the max} I[k, q, :]
//   dI[k, q, :]      = sum_{m, n : q tied at the max} coef[m, k, n] * T[m, n, :]
//
// accumulated in fp32 and rounded to the input dtype.
//
// Routing runs against the backward's OWN recomputed max, never a max saved
// by the forward: a max from another accumulation order would match no
// similarity and silently zero whole rows of the gradient. The routing pass
// uses the forward's own tile code (maxsim_tile.cuh), so here the two agree
// bit for bit anyway; the tie masks it writes keep every tie.
//
// Three kernels on the stream:
//   1. route, one block per (m, k): the forward's register tile of
//      similarities, its row max, the masked-mean weights, and for every
//      (m, k, n) the coefficient (fp32 [M, K, Lt]) and a 256-bit mask of the
//      image tokens at the max (uint32 [M, K, Lt, 8]). At M = K = 256 that
//      is 20 MB + 161 MB of scratch from the wrapper.
//   2. dT, one block per (m, n): 8 warps split the K images, each adds the
//      tied image rows times the coefficient into its own fp32 row in
//      shared memory; the 8 rows are summed at the end. No atomics.
//   3. dI, one block per (image k, slice of 128 features): dI[k] sums over
//      all M * Lt text tokens, which would be M * Lt * D global atomics per
//      image (5e9 at the training shape, all contending for 196 rows). The
//      block instead keeps its [Li, 128] fp32 slice of dI[k] in shared
//      memory (128 KB at Li = 256) and 32 warps walk the (m, n) pairs, adding
//      coef * T[m, n, slice] into the tied rows with shared-memory atomics
//      (lanes on consecutive features: no bank conflicts). Float atomics
//      make the summation order, and so the last bits of dI, vary from run
//      to run.
//
// What bounds it on the H100: the route pass recomputes the similarities,
// 2 * M * K * Lt * Li * D = 1 TFLOP at the training shape (M = K = 256,
// Lt = 77, Li = 196, D = 512), on the CUDA cores like the forward; the dT and
// dI passes do M * K * Lt * D FMAs each (2.6 G) and read their operand rows
// from L2 (T and I are 20 and 51 MB in bf16). So the route pass dominates,
// as the forward does; bf16 tensor-core products for the tile are the next
// step for both.

#include "maxsim_tile.cuh"

namespace {

using colxlip::from_f;
using colxlip::to_f;
using namespace colxlip::maxsim_tile;

constexpr int kTieWords = kMaxCols / 32;  // 8 words of 32 image tokens
constexpr int kDtWarps = 8;
constexpr int kDiWarps = 32;
constexpr int kDiSlice = 128;             // features of dI per block
constexpr int kMaxD = 4096;               // dT's shared rows: kDtWarps * D fp32 <= 128 KB

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
maxsim_bwd_route_kernel(const T* __restrict__ text, const T* __restrict__ image,
                        const float* __restrict__ text_mask, const float* __restrict__ g,
                        float* __restrict__ coef, unsigned* __restrict__ ties, int num_k, int lt,
                        int li, int d, int mask_mode) {
  __shared__ Smem<CPT> sm;
  __shared__ unsigned tie[kRows][kTieWords];
  const int m = blockIdx.x / num_k;
  const int k = blockIdx.x - m * num_k;
  for (int idx = threadIdx.x; idx < kRows * kTieWords; idx += blockDim.x)
    tie[idx / kTieWords][idx % kTieWords] = 0u;
  float acc[kRPT][CPT];
  // sim_tile ends with __syncthreads(), which also orders the zeroing above
  sim_tile<T, CPT>(text + size_t(m) * lt * d, image + size_t(k) * li * d, lt, li, d, sm, acc);

  const size_t row0 = (size_t(m) * num_k + k) * lt;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float* mask_row = text_mask + size_t(m) * lt;
    float w = 0.f;
    for (int n = lane; n < lt; n += 32) w += token_weight(mask_mode, sm.rowmax[n], mask_row, n);
    w = colxlip::warp_sum(w);
    const float gmk = g[size_t(m) * num_k + k];
    for (int n = lane; n < lt; n += 32)
      coef[row0 + n] = mask_mode == 1
                           ? gmk / float(lt)
                           : gmk * token_weight(mask_mode, sm.rowmax[n], mask_row, n) / (w + kEps);
  }

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int row = ty + kTY * r;
    if (row >= lt) continue;
    const float mx = sm.rowmax[row];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + kTX * c;
      if (col < li && acc[r][c] >= mx) atomicOr(&tie[row][col >> 5], 1u << (col & 31));
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < lt * kTieWords; idx += blockDim.x)
    ties[row0 * kTieWords + idx] = tie[idx / kTieWords][idx % kTieWords];
}

// Calls f(q) for every image token q set in the tie mask of row r; lanes
// 0..7 load the 8 words, the whole warp walks the bits in step.
template <typename F>
__device__ __forceinline__ void for_each_tie(const unsigned* __restrict__ ties, size_t r,
                                             int lane, F&& f) {
  const unsigned mine = lane < kTieWords ? ties[r * kTieWords + lane] : 0u;
#pragma unroll
  for (int w = 0; w < kTieWords; ++w) {
    unsigned bits = __shfl_sync(0xffffffffu, mine, w);
    while (bits) {
      f(w * 32 + __ffs(bits) - 1);
      bits &= bits - 1;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kDtWarps * 32)
maxsim_bwd_dt_kernel(const T* __restrict__ image, const float* __restrict__ coef,
                     const unsigned* __restrict__ ties, T* __restrict__ dtext, int num_k, int lt,
                     int li, int d) {
  extern __shared__ float dt_acc[];  // [kDtWarps, d]
  const int m = blockIdx.x / lt;
  const int n = blockIdx.x - m * lt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = dt_acc + size_t(warp) * d;
  for (int e = lane; e < d; e += 32) acc[e] = 0.f;
  for (int k = warp; k < num_k; k += kDtWarps) {
    const size_t r = (size_t(m) * num_k + k) * lt + n;
    const float c = coef[r];
    if (c == 0.f) continue;  // warp-uniform: a zero coefficient adds nothing
    for_each_tie(ties, r, lane, [&](int q) {
      const T* irow = image + (size_t(k) * li + q) * d;
      for (int e = lane; e < d; e += 32) acc[e] = fmaf(c, to_f(irow[e]), acc[e]);
    });
  }
  __syncthreads();
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kDtWarps; ++w) s += dt_acc[size_t(w) * d + e];
    dtext[(size_t(m) * lt + n) * d + e] = from_f<T>(s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kDiWarps * 32)
maxsim_bwd_di_kernel(const T* __restrict__ text, const float* __restrict__ coef,
                     const unsigned* __restrict__ ties, T* __restrict__ dimage, int num_m,
                     int num_k, int lt, int li, int d) {
  extern __shared__ float di_acc[];  // [li, kDiSlice]
  const int k = blockIdx.x;
  const int d0 = blockIdx.y * kDiSlice;
  const int width = min(kDiSlice, d - d0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int idx = threadIdx.x; idx < li * kDiSlice; idx += blockDim.x) di_acc[idx] = 0.f;
  __syncthreads();
  for (int pair = warp; pair < num_m * lt; pair += kDiWarps) {
    const int m = pair / lt, n = pair - m * lt;
    const size_t r = (size_t(m) * num_k + k) * lt + n;
    const float c = coef[r];
    if (c == 0.f) continue;
    const T* trow = text + (size_t(m) * lt + n) * d + d0;
    float tv[kDiSlice / 32];
#pragma unroll
    for (int j = 0; j < kDiSlice / 32; ++j) {
      const int e = lane + 32 * j;
      tv[j] = e < width ? c * to_f(trow[e]) : 0.f;
    }
    for_each_tie(ties, r, lane, [&](int q) {
      float* row = di_acc + q * kDiSlice;
#pragma unroll
      for (int j = 0; j < kDiSlice / 32; ++j)
        if (lane + 32 * j < width) atomicAdd(row + lane + 32 * j, tv[j]);
    });
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < li * kDiSlice; idx += blockDim.x) {
    const int q = idx / kDiSlice, e = idx - q * kDiSlice;
    if (e < width) dimage[(size_t(k) * li + q) * d + d0 + e] = from_f<T>(di_acc[idx]);
  }
}

template <typename T, int CPT>
cudaError_t launch_route(const void* text, const void* image, const void* mask, const float* g,
                         float* coef, unsigned* ties, int m, int k, int lt, int li, int d,
                         int mask_mode, cudaStream_t stream) {
  maxsim_bwd_route_kernel<T, CPT><<<unsigned(m) * unsigned(k), kThreads, 0, stream>>>(
      static_cast<const T*>(text), static_cast<const T*>(image),
      static_cast<const float*>(mask), g, coef, ties, k, lt, li, d, mask_mode);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* text, const void* image, const void* mask, const float* g,
                   float* coef, unsigned* ties, void* dtext, void* dimage, int m, int k, int lt,
                   int li, int d, int mask_mode, cudaStream_t stream) {
  cudaError_t err =
      li <= 4 * kTX    ? launch_route<T, 4>(text, image, mask, g, coef, ties, m, k, lt, li, d,
                                            mask_mode, stream)
      : li <= 13 * kTX ? launch_route<T, 13>(text, image, mask, g, coef, ties, m, k, lt, li, d,
                                             mask_mode, stream)
                       : launch_route<T, 16>(text, image, mask, g, coef, ties, m, k, lt, li, d,
                                             mask_mode, stream);
  if (err != cudaSuccess) return err;

  const size_t dt_smem = size_t(kDtWarps) * d * sizeof(float);
  err = cudaFuncSetAttribute(maxsim_bwd_dt_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(dt_smem));
  if (err != cudaSuccess) return err;
  maxsim_bwd_dt_kernel<T><<<unsigned(m) * unsigned(lt), kDtWarps * 32, dt_smem, stream>>>(
      static_cast<const T*>(image), coef, ties, static_cast<T*>(dtext), k, lt, li, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t di_smem = size_t(li) * kDiSlice * sizeof(float);
  err = cudaFuncSetAttribute(maxsim_bwd_di_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(di_smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(k, (d + kDiSlice - 1) / kDiSlice);
  maxsim_bwd_di_kernel<T><<<grid, kDiWarps * 32, di_smem, stream>>>(
      static_cast<const T*>(text), coef, ties, static_cast<T*>(dimage), m, k, lt, li, d);
  return cudaGetLastError();
}

}  // namespace

// text [M, Lt, D], image [K, Li, D] (dtype 0 = float32, 1 = bfloat16), mask
// [M, Lt] float32 or null (mask_mode 2 only), g [M, K] float32 (the
// cotangent of the scores); scratch coef float32 [M, K, Lt] and ties uint32
// [M, K, Lt, 8]; out dtext [M, Lt, D] and dimage [K, Li, D] in the input
// dtype. Returns a cudaError_t (0 = launched).
extern "C" int colxlip_maxsim_bwd(const void* text, const void* image, const void* mask,
                                  const void* g, void* coef, void* ties, void* dtext,
                                  void* dimage, int m, int k, int lt, int li, int d,
                                  int mask_mode, int dtype, void* stream) {
  if (m < 1 || k < 1 || lt < 1 || lt > kRows || li < 1 || li > kMaxCols ||
      d < 1 || d > kMaxD || mask_mode < 0 || mask_mode > 2 ||
      (mask_mode == 2 && mask == nullptr) || (long long)m * k > 0x7fffffffLL ||
      (long long)m * lt > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  float* cf = static_cast<float*>(coef);
  unsigned* tf = static_cast<unsigned*>(ties);
  if (dtype == 0)
    return launch<float>(text, image, mask, gf, cf, tf, dtext, dimage, m, k, lt, li, d, mask_mode, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(text, image, mask, gf, cf, tf, dtext, dimage, m, k, lt, li, d,
                                 mask_mode, s);
  return cudaErrorInvalidValue;
}
