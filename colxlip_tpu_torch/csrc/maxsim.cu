// ColBERT MaxSim late-interaction score, forward, for Hopper (sm_90a).
//
// Replaces: colxlip_tpu/ops/maxsim_pallas.py `_fwd_call` (:112; body
// `_fwd_kernel` :86, public `maxsim_pallas` :336), and on the train step the
// streaming forward of colxlip_tpu/ops/maxsim.py (`_mknq_max_tiles`).
//
//   S[m, k] = masked-mean over n of ( max over q of <T[m, n, :], I[k, q, :]> )
//
// mask_mode 0 'nonzero': mean over n where the max is != 0, denominator + 1e-8
//           1 'plain'  : mean over all Lt
//           2 'valid'  : weights text_mask[m, n], denominator + 1e-8
// exactly as colxlip_tpu/ops/maxsim.py `_masked_mean_from_maxsim` (:47-63).
//
// What bounds it on the H100: at the training shape (M = K = 256, Lt = 77,
// Li = 196, D = 512, bf16) the similarities are 2 M K Lt Li D = 1.01 TFLOP
// over 71 MB of input: bound by the tensor cores (1.0 ms at 989 TFLOP/s).
//
// Design: two kernels on the stream.
//   1. `maxsim_max_kernel`: the Pallas kernel's matrix product, [M Lt, D] .
//      [D, Li] for each image, on mma.sync tensor-core tiles
//      (maxsim_tile.cuh): a block is 128 flattened text rows against one
//      image, its row max is warp-local (the thread's own columns, then
//      quad_max), and it writes max_sim [M, K, Lt] fp32, the residual of the
//      JAX streaming forward (20 MB at the training shape). The grid walks
//      the row blocks fastest, so the blocks resident together share one
//      image and stream the text rows: the text (20 MB in bf16) stays in the
//      50 MB L2 and each image is read from device memory about once, where
//      the image-fastest order would cycle all 51 MB of images through L2 for
//      every row block.
//   2. `maxsim_mean_kernel`: one warp per (m, k) reduces the Lt maxima of
//      max_sim with the mask rule. A text's rows straddle row blocks, so the
//      mean cannot sit in kernel 1 without a cross-block reduction. A text
//      row zeroed at and after EOT gives products of exactly 0, so its max is
//      exactly 0 and 'nonzero' drops it, as in the plain version.

#include "maxsim_tile.cuh"

namespace {

using namespace colxlip::maxsim_tile;
using colxlip::mma::bf16;

constexpr int kMeanWarps = 8;

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 1)
maxsim_max_kernel(const T* __restrict__ text, const T* __restrict__ image,
                  float* __restrict__ max_sim, int rows, int num_k, int lt, int li, int d,
                  int groups, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlockRows;
  const int r0 = row0 + warp * 16 + (lane >> 2), r1 = r0 + 8;  // this thread's two rows
  for (int k = blockIdx.y; k < num_k; k += gridDim.y) {
    const T* ik = image + size_t(k) * li * d;
    float acc[2 * NP][4];
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int gi = 0; gi < groups; ++gi) {
      sim_group<T, NP>(acc, smem, text, ik, rows, row0, li, gi * 16 * NP, d, aligned != 0);
      row_max<NP>(acc, m0, m1);
    }
    m0 = colxlip::mma::quad_max(m0);
    m1 = colxlip::mma::quad_max(m1);
    if ((lane & 3) == 0) {
      if (r0 < rows) max_sim[mkn(r0, lt, num_k, k)] = m0;
      if (r1 < rows) max_sim[mkn(r1, lt, num_k, k)] = m1;
    }
  }
}

__global__ void __launch_bounds__(kMeanWarps * 32)
maxsim_mean_kernel(const float* __restrict__ max_sim, const float* __restrict__ text_mask,
                   float* __restrict__ out, long long pairs, int num_k, int lt, int mask_mode) {
  const int lane = threadIdx.x & 31;
  const long long p = blockIdx.x * (long long)kMeanWarps + (threadIdx.x >> 5);  // m * K + k
  if (p >= pairs) return;
  const float* row = max_sim + p * lt;
  const float* mask_row = text_mask + (p / num_k) * lt;
  float s = 0.f, w = 0.f;
  for (int n = lane; n < lt; n += 32) {
    const float v = row[n];
    const float wn = token_weight(mask_mode, v, mask_row, n);
    s += v * wn;
    w += wn;
  }
  s = colxlip::warp_sum(s);
  w = colxlip::warp_sum(w);
  if (lane == 0) out[p] = mask_mode == 1 ? s / float(lt) : s / (w + kEps);
}

template <typename T, int NP>
cudaError_t launch_max(const void* text, const void* image, float* max_sim, int m, int k, int lt,
                       int li, int d, int groups, cudaStream_t stream) {
  const size_t smem = Layout<T, NP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(maxsim_max_kernel<T, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rows = m * lt;
  const int aligned = async16<T>(text, image, d);
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows, k < 65535 ? k : 65535);
  maxsim_max_kernel<T, NP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(text), static_cast<const T*>(image), max_sim, rows, k, lt, li, d,
      groups, aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_max(const void* text, const void* image, float* max_sim, int m, int k,
                         int lt, int li, int d, cudaStream_t stream) {
  const Plan p = plan(li);
  switch (p.np) {
    case 4: return launch_max<T, 4>(text, image, max_sim, m, k, lt, li, d, p.groups, stream);
    case 8: return launch_max<T, 8>(text, image, max_sim, m, k, lt, li, d, p.groups, stream);
    case 13: return launch_max<T, 13>(text, image, max_sim, m, k, lt, li, d, p.groups, stream);
    default: return launch_max<T, 16>(text, image, max_sim, m, k, lt, li, d, p.groups, stream);
  }
}

}  // namespace

// text [M, Lt, D], image [K, Li, D] (dtype 0 = float32, 1 = bfloat16), mask
// [M, Lt] float32 or null (mask_mode 2 only), scratch max_sim [M, K, Lt]
// float32, out [M, K] float32. Any Lt, Li and D >= 1. Returns a cudaError_t
// (0 = launched).
extern "C" int colxlip_maxsim_fwd(const void* text, const void* image, const void* mask,
                                  void* max_sim, void* out, int m, int k, int lt, int li, int d,
                                  int mask_mode, int dtype, void* stream) {
  if (m < 1 || k < 1 || lt < 1 || li < 1 || d < 1 || mask_mode < 0 || mask_mode > 2 ||
      (mask_mode == 2 && mask == nullptr) || (long long)m * k > 0x7fffffffLL ||
      (long long)m * lt > 0x7fffffffLL - kBlockRows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ms = static_cast<float*>(max_sim);
  cudaError_t err = dtype == 0   ? dispatch_max<float>(text, image, ms, m, k, lt, li, d, s)
                    : dtype == 1 ? dispatch_max<bf16>(text, image, ms, m, k, lt, li, d, s)
                                 : cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const long long pairs = (long long)m * k;
  maxsim_mean_kernel<<<unsigned((pairs + kMeanWarps - 1) / kMeanWarps), kMeanWarps * 32, 0, s>>>(
      ms, static_cast<const float*>(mask), static_cast<float*>(out), pairs, k, lt, mask_mode);
  return cudaGetLastError();
}
