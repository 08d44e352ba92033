// ColBERT MaxSim late-interaction score, forward, for Hopper (sm_90a).
//
// Replaces: colxlip_tpu/ops/maxsim_pallas.py `maxsim_pallas` (:336), whose TPU
// body is the Pallas `_fwd_kernel` (:86). On the TPU, the serving path's call
// (ops/maxsim.py:305-354) goes to an XLA einsum or streaming path; on the card
// there is no fusion of einsum + max, and the plain version would hold the
// [M, K, Lt, Li] fp32 similarity tensor (3.8 GB at M = K = 256, Lt = 77,
// Li = 196), so the score path runs this kernel.
//
//   S[m, k] = masked-mean over n of ( max over q of <T[m, n, :], I[k, q, :]> )
//
// mask_mode 0 'nonzero': mean over n where the max is != 0, denominator + 1e-8
//           1 'plain'  : mean over all Lt
//           2 'valid'  : weights text_mask[m, n], denominator + 1e-8
// exactly as colxlip_tpu/ops/maxsim.py `_masked_mean_from_maxsim` (:47-63).
//
// What bounds it on the H100: at the serving shape (M = K = 64, Lt = 77,
// Li = 196, D = 512, fp32) the call is 2*M*K*Lt*Li*D = 63 GFLOP over 16 MB of
// input, so it is compute-bound. Inputs are fp32 (the JAX score path feeds
// fp32), and this first version runs fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak); TF32 or bf16 tensor-core products would change the numbers and are
// left for a later PR.
//
// Design: the (m, k) outputs are independent (the max is over one image's
// tokens, the mean over one text's tokens), so one block computes one S[m, k]
// with no cross-block reduction. The block is a small register-tiled GEMM of
// T[m] (Lt x D) against I[k] (Li x D): 16 x 16 threads, each holding a 5 x CPT
// tile of fp32 dot products (rows ty + 16 r, columns tx + 16 c), fed from
// shared-memory chunks of 32 features stored feature-major with odd row
// strides (conflict-free stores and broadcast loads). The row max runs over
// the thread's columns and then across the 16 lanes of the row group by
// shuffles, and one warp reduces the masked mean. The similarity tile never
// leaves registers; nothing of size [M, K, Lt, Li] exists anywhere.

#include "maxsim_tile.cuh"

namespace {

using namespace colxlip::maxsim_tile;

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
maxsim_fwd_kernel(const T* __restrict__ text, const T* __restrict__ image,
                  const float* __restrict__ text_mask, float* __restrict__ out,
                  int num_k, int lt, int li, int d, int mask_mode) {
  __shared__ Smem<CPT> sm;
  const int m = blockIdx.x / num_k;
  const int k = blockIdx.x - m * num_k;
  float acc[kRPT][CPT];
  sim_tile<T, CPT>(text + size_t(m) * lt * d, image + size_t(k) * li * d, lt, li, d, sm, acc);

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float* mask_row = text_mask + size_t(m) * lt;
    float s = 0.f, w = 0.f;
    for (int n = lane; n < lt; n += 32) {
      const float v = sm.rowmax[n];
      const float wn = token_weight(mask_mode, v, mask_row, n);
      s += v * wn;
      w += wn;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      w += __shfl_xor_sync(0xffffffffu, w, o);
    }
    if (lane == 0) out[size_t(m) * num_k + k] = mask_mode == 1 ? s / float(lt) : s / (w + kEps);
  }
}

template <typename T, int CPT>
cudaError_t launch(const void* text, const void* image, const void* mask, void* out, int m,
                   int k, int lt, int li, int d, int mask_mode, cudaStream_t stream) {
  maxsim_fwd_kernel<T, CPT><<<unsigned(m) * unsigned(k), kThreads, 0, stream>>>(
      static_cast<const T*>(text), static_cast<const T*>(image),
      static_cast<const float*>(mask), static_cast<float*>(out), k, lt, li, d, mask_mode);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* text, const void* image, const void* mask, void* out, int m,
                     int k, int lt, int li, int d, int mask_mode, cudaStream_t stream) {
  if (li <= 4 * kTX) return launch<T, 4>(text, image, mask, out, m, k, lt, li, d, mask_mode, stream);
  if (li <= 13 * kTX) return launch<T, 13>(text, image, mask, out, m, k, lt, li, d, mask_mode, stream);
  return launch<T, 16>(text, image, mask, out, m, k, lt, li, d, mask_mode, stream);
}

}  // namespace

// text [M, Lt, D], image [K, Li, D] (dtype 0 = float32, 1 = bfloat16), mask
// [M, Lt] float32 or null (mask_mode 2 only), out [M, K] float32. Returns a
// cudaError_t (0 = launched).
extern "C" int colxlip_maxsim_fwd(const void* text, const void* image, const void* mask,
                                  void* out, int m, int k, int lt, int li, int d,
                                  int mask_mode, int dtype, void* stream) {
  if (m < 1 || k < 1 || lt < 1 || lt > kRows || li < 1 || li > kMaxCols || d < 1 ||
      mask_mode < 0 || mask_mode > 2 || (mask_mode == 2 && mask == nullptr) ||
      (long long)m * k > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(text, image, mask, out, m, k, lt, li, d, mask_mode, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(text, image, mask, out, m, k, lt, li, d, mask_mode, s);
  return cudaErrorInvalidValue;
}
