// Stochastic-rounding int8 quantization of a [K, N] weight, one scale a
// column, for Hopper (sm_90a): one launch, the weight read from device memory
// once.
//
// Replaces: colxlip_tpu/ops/quantization.py `quantize_int8_pallas` (:52, body
// `_quant_kernel` :34). Same arithmetic, in fp32 whatever the input type:
//
//   scale[j]     = max(max_i |w[i, j]| / 127, 1e-8)
//   values[i, j] = clip(floor(w[i, j] / scale[j] + u[i, j]), -127, 127)
//   u[i, j]      = (bits >> 8) * 2^-24, uniform in [0, 1) from 24 random bits
//
// The TPU kernel draws its bits from the core's own generator, seeded with
// the seed plus the column block. Here the bits come from Philox4x32-10,
// written out below: key = the 64-bit seed, counter = (row, column / 4, 0, 0),
// and element (i, j) takes word j % 4 of that counter's four. So the noise of
// an element depends on the seed and its position alone, never on the grid,
// the block size or the width of the matrix, no two column blocks repeat a
// pattern, and ops/quantization.py `quantize_int8_plain` computes the same
// words with integer tensor arithmetic: the two are equal bit for bit. To keep
// them so, both divisions are IEEE divisions (__fdiv_rn, never a multiply by
// a reciprocal) and the add before the floor is one rounded add (__fadd_rn),
// which the compiler may not contract with anything.
//
// What bounds it on the H100: bytes. It must read K N elements and write K N
// bytes and N scales (at 768 x 3072 fp32: 11.8 MB, 3.5 us at 3.35 TB/s), but
// it also issues about 40 instructions an element (Philox's ten rounds for
// four elements, an IEEE division), which at that shape take about as long.
// The TPU kernel holds a whole column block in VMEM and takes its maximum
// before it quantizes. Here a column's maximum spans blocks, so a column
// strip of W columns is cut along K among the kCluster blocks of one
// thread-block cluster (`__cluster_dims__`, neighbouring SMs). Each block
// reads its slice of rows once and, while the loads are in flight, draws
// their Philox noise (it depends on the position alone); it keeps both in
// shared memory and takes its column maxima. The blocks exchange the maxima
// through distributed shared memory (cooperative_groups::this_cluster(),
// map_shared_rank): every block takes the maximum of the cluster's kCluster
// in the same way, so all compute the same scales, and each quantizes the
// rows it holds: a division, an add, a floor and a store an element after the
// barrier. No memset, no atomic, no second launch. A slice too tall to keep
// (kKeepBytes) is read again in the same launch, from L2 where it is still
// there, and its noise drawn then (the KEEP = false instantiation). A thread
// owns four neighbouring columns: one Philox call serves its four elements,
// and when N is a multiple of 4 and the pointers are aligned it loads them as
// one 16-byte (fp32) or 8-byte (bf16) word and stores four int8 as one 32-bit
// word. N is never padded.

#include "common.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using colxlip::to_f;

constexpr int kCluster = 8;          // blocks of a cluster along K (the portable most)
constexpr int kThreads = 256;
// columns of a strip, W: 64 where strips of 64 still make kWideBlocks blocks
// (fewer blocks, each one's barriers and reductions over more columns), else
// 32 (128 bytes of an fp32 row: more clusters for a narrow weight). Measured
// by scripts/torch_quant_bench.py --ablate.
constexpr int kWideBlocks = 256;
// a block keeps its rows (x and u, fp32) up to this much shared memory: two
// blocks an SM; K <= 3072 at W = 32 (every Dense weight of ViT-B-16), 1536 at 64
constexpr int kKeepBytes = 96 * 1024;

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011): ten rounds on the counter (c0, c1, c2, c3) under the key
// (k0, k1), the key bumped by the Weyl constants between rounds.
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1, uint32_t (&out)[4]) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// Four neighbouring elements of row `row` starting at column `col` (a
// multiple of 4), as fp32; columns past n read as 0.
template <typename T, bool VEC>
__device__ __forceinline__ float4 load4(const T* __restrict__ w, size_t row, int col, int n) {
  const T* p = w + row * size_t(n) + col;
  if constexpr (VEC && sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else if constexpr (VEC) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
  } else {
    float x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = col + c < n ? to_f(p[c]) : 0.f;
    return make_float4(x[0], x[1], x[2], x[3]);
  }
}

// u of four elements from their Philox words: the top 24 bits times 2^-24
// (exact).
__device__ __forceinline__ float4 noise4(size_t row, int col, uint32_t seed_lo, uint32_t seed_hi) {
  uint32_t bits[4];
  philox4x32_10(uint32_t(row), uint32_t(col >> 2), 0u, 0u, seed_lo, seed_hi, bits);
  constexpr float kScale = 1.0f / 16777216.0f;
  return make_float4(float(bits[0] >> 8) * kScale, float(bits[1] >> 8) * kScale,
                     float(bits[2] >> 8) * kScale, float(bits[3] >> 8) * kScale);
}

__device__ __forceinline__ int8_t quantize1(float x, float scale, float u) {
  const float rounded = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  return int8_t(fminf(fmaxf(rounded, -127.0f), 127.0f));
}

// The cluster barrier in two halves (PTX barrier.cluster): a block arrives
// once it has read the others' shared memory and waits before it leaves.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Grid (ceil(N / W), kCluster), one cluster a column strip: block rank
// r of a cluster owns rows [r rows_per_block, (r + 1) rows_per_block). With
// KEEP its rows and their noise wait in shared memory ([rows_per_block]
// [kGroups] float4 each) between the two passes; without, the second pass
// reads the rows again and draws the noise then.
template <typename T, bool VEC, bool KEEP, int W>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ w, int8_t* __restrict__ values, float* __restrict__ scales,
                int k, int n, int rows_per_block, uint32_t seed_lo, uint32_t seed_hi) {
  constexpr int kGroups = W / 4;              // threads along the columns, 4 columns each
  constexpr int kLanes = kThreads / kGroups;  // threads along the rows
  extern __shared__ float4 keep[];            // x, then u
  __shared__ float4 red[kLanes][kGroups];
  __shared__ float col_max[W];
  __shared__ float col_scale[W];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int tx = threadIdx.x % kGroups, ty = threadIdx.x / kGroups;
  const int col = blockIdx.x * W + 4 * tx;
  const int row0 = rank * rows_per_block;
  const int rows = max(0, min(rows_per_block, k - row0));
  const bool live = col < n;
  float4* keep_u = keep + rows_per_block * kGroups;

  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
#pragma unroll 4
    for (int r = ty; r < rows; r += kLanes) {
      const float4 x = load4<T, VEC>(w, size_t(row0 + r), col, n);
      if constexpr (KEEP) {
        keep_u[r * kGroups + tx] = noise4(size_t(row0 + r), col, seed_lo, seed_hi);
        keep[r * kGroups + tx] = x;
      }
      m.x = fmaxf(m.x, fabsf(x.x));
      m.y = fmaxf(m.y, fabsf(x.y));
      m.z = fmaxf(m.z, fabsf(x.z));
      m.w = fmaxf(m.w, fabsf(x.w));
    }
  }
  red[ty][tx] = m;
  __syncthreads();
  if (threadIdx.x < W) {
    const float* column = reinterpret_cast<const float*>(&red[0][0]) + threadIdx.x;
    float v = column[0];
#pragma unroll
    for (int l = 1; l < kLanes; ++l) v = fmaxf(v, column[l * W]);
    col_max[threadIdx.x] = v;
  }
  // every block's maxima are written; then each reads all kCluster of them
  cluster.sync();
  if (threadIdx.x < W) {
    float amax = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      amax = fmaxf(amax, cluster.map_shared_rank(&col_max[0], r)[threadIdx.x]);
    const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
    col_scale[threadIdx.x] = scale;
    const int j = blockIdx.x * W + threadIdx.x;
    if (rank == 0 && j < n) scales[j] = scale;
  }
  cluster_arrive();
  __syncthreads();                            // the scales
  if (live) {
    const float4 s = make_float4(col_scale[4 * tx], col_scale[4 * tx + 1],
                                 col_scale[4 * tx + 2], col_scale[4 * tx + 3]);
#pragma unroll 4
    for (int r = ty; r < rows; r += kLanes) {
      const size_t row = size_t(row0 + r);
      float4 x, u;
      if constexpr (KEEP) {
        x = keep[r * kGroups + tx];
        u = keep_u[r * kGroups + tx];
      } else {
        x = load4<T, VEC>(w, row, col, n);
        u = noise4(row, col, seed_lo, seed_hi);
      }
      const int8_t q[4] = {quantize1(x.x, s.x, u.x), quantize1(x.y, s.y, u.y),
                           quantize1(x.z, s.z, u.z), quantize1(x.w, s.w, u.w)};
      int8_t* out = values + row * size_t(n) + col;
      if constexpr (VEC) {
        *reinterpret_cast<char4*>(out) = make_char4(q[0], q[1], q[2], q[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < n) out[c] = q[c];
      }
    }
  }
  // no block leaves (and frees its col_max) before every block has read it
  cluster_wait();
}

template <typename T, bool VEC, int W>
cudaError_t launch(const T* w, int8_t* values, float* scales, int k, int n, uint32_t seed_lo,
                   uint32_t seed_hi, cudaStream_t stream) {
  const int rows_per_block = (k + kCluster - 1) / kCluster;
  const dim3 grid((n + W - 1) / W, kCluster);
  if (size_t(rows_per_block) * W * 8 > kKeepBytes) {
    quantize_kernel<T, VEC, false, W><<<grid, kThreads, 0, stream>>>(
        w, values, scales, k, n, rows_per_block, seed_lo, seed_hi);
    return cudaGetLastError();
  }
  // above 48 KB a block: set once (a failure is returned on every call)
  static const cudaError_t attr = cudaFuncSetAttribute(
      quantize_kernel<T, VEC, true, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, kKeepBytes);
  if (attr != cudaSuccess) return attr;
  quantize_kernel<T, VEC, true, W><<<grid, kThreads, size_t(rows_per_block) * W * 8, stream>>>(
      w, values, scales, k, n, rows_per_block, seed_lo, seed_hi);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch(const void* w, void* values, void* scales, int k, int n, uint32_t seed_lo,
                   uint32_t seed_hi, cudaStream_t stream) {
  const auto* wt = static_cast<const T*>(w);
  auto* v = static_cast<int8_t*>(values);
  auto* s = static_cast<float*>(scales);
  if ((n + 63) / 64 * kCluster >= kWideBlocks)
    return launch<T, VEC, 64>(wt, v, s, k, n, seed_lo, seed_hi, stream);
  return launch<T, VEC, 32>(wt, v, s, k, n, seed_lo, seed_hi, stream);
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// w [K, N] float32 (dtype 0) or bfloat16 (dtype 1), contiguous; values [K, N]
// int8; scales [N] float32. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int colxlip_quantize_int8(const void* w, void* values, void* scales, int k, int n,
                                     uint32_t seed_lo, uint32_t seed_hi, int dtype,
                                     void* stream) {
  if (k < 1 || n < 1 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t elem = dtype == 0 ? 4 : 2;
  const bool vec = n % 4 == 0 && aligned(w, 4 * elem) && aligned(values, 4);
  if (dtype == 0)
    return int(vec ? launch<float, true>(w, values, scales, k, n, seed_lo, seed_hi, s)
                   : launch<float, false>(w, values, scales, k, n, seed_lo, seed_hi, s));
  return int(vec ? launch<__nv_bfloat16, true>(w, values, scales, k, n, seed_lo, seed_hi, s)
                 : launch<__nv_bfloat16, false>(w, values, scales, k, n, seed_lo, seed_hi, s));
}
