// Transformer MLP c_fc -> GELU -> c_proj with a recompute backward, for
// Hopper (sm_90a): no [rows, H] tensor reaches device memory, forward or
// backward. Only an L2-sized [R_c, H] chunk of it does, in both dtypes and
// both directions.
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
// fp32: the CUDA cores, any D. Both directions run the bf16 path's schedule
// on an fp32 GEMM tile of the CUDA cores (sgemm_tile.cuh: 128 x 128
// register-blocked tiles, 8 x 8 outputs a thread, K in steps of 16 through 3
// cp.async stages), one kernel for every product (mlp_sgemm_kernel), with
// the same epilogues where the function is the same (T = float rounds
// nothing):
//
//   forward, per chunk of R_c rows
//     x W1^T   kNT  -> ws [R_c, H]         a = gelu(acc + b1)
//     a W2     kNN  -> out rows            acc + b2, or K slices (below)
//   backward: db2 = column sums of dy (colsum + reduce, once); per chunk
//     x W1^T   kNT  -> ws [R_c, H]         h = acc + b1
//     dy W2^T  kNT  -> dh [R_c, H]         acc is da: reads h, writes
//                                          dh = gelu'(h) da, a over h, and
//                                          each warp's column sums of dh
//     a^T dy   kTN  -> dW2                 the first chunk stores, later add
//     dh^T x   kTN  -> dW1                 the same (one launch with dW2)
//     dh W1    kNN  -> dx rows             K slices (below)
//   then db1 = the warps' column sums added in a fixed order.
//
// That is the function's own 4 and 10 R D H: h once a chunk forward, h and
// da once a chunk backward. The two kNN products (a W2, dh W1; K = H) are
// one function, kn_product: where a chunk's [R_c, D] tiles would leave the
// card half idle it cuts K into `splits` slices of whole k-steps, each
// slice's partial [R_c, D] to scratch, added in slice order by
// reduce_partials, which adds b2 once after the whole sum (as the plain
// version's matmul(a, w2) + b2); a short chunk takes more slices
// (chunk_splits). The wrapper picks R_c so that the chunk's fp32 [R_c, H]
// tiles stay in L2 (backward two, 1024 rows at H = 4096; forward one, twice
// the rows) and `splits` so that the kNN tiles fill the card's two blocks
// an SM. The forward's chunks are near-equal runs of whole 128-row tiles
// (ViT-L's 4,112 rows: 3 chunks of 11 tiles), so no short last chunk takes
// a wave of its own. Every output is summed in one fixed order (K in order
// inside a tile, chunks in order on one stream, partial sums in index
// order), with no atomics: two runs agree bit for bit.

#include <algorithm>

#include "mlp_gemm.cuh"
#include "sgemm_tile.cuh"
#include "stream_tile.cuh"

namespace {

using colxlip::round_to;
using colxlip::to_f;
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

struct BwdOut {
  const void* dy;
  void* dx;
  float* dw1;
  float* db1;
  float* dw2;
  float* db2;
  float* scratch;   // fp32 sums: db1 and db2 partial rows, fp32 dx's K slices
  int splits, colsum_blocks;
};

// db2 = the column sums of dy, both dtypes: partial row b sums rows b,
// b + blocks, ... in order, then the partial rows add up in order. One
// thread a column up to 1024 (the sums do not depend on the thread count; a
// thread's loads no longer wait on another column's: 0.23 ms at 256 threads
// at the vision shape on the H100).
template <typename T>
cudaError_t column_sums(const T* dy, float* partials, float* db2, int rows, int d, int blocks,
                        cudaStream_t stream) {
  const int threads = std::min(1024, (d + 31) / 32 * 32);
  colsum_kernel<T><<<blocks, threads, 0, stream>>>(dy, partials, rows, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partials, db2, blocks, d, stream);
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
// (db1 sums, one row a warp) + colsum_blocks * d (db2 partials) fp32.
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

  COLXLIP_TRY(column_sums(dy, db2_part, o.db2, a.rows, a.d, o.colsum_blocks, a.stream));

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

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores (sgemm_tile.cuh), the bf16 path's
// schedule and epilogues
// ---------------------------------------------------------------------------

namespace sg = colxlip::sgemm;

struct EpiArgs32 {
  float* out;          // [m, ldo]
  int ldo;
  const float* bias;   // by column: b1 (kEpiGelu, kEpiPre), b2 (kEpiBias)
  float* dh;           // kEpiDh: [m, ldo]
  float* db1_part;     // kEpiDh: [4 ceil(m / 128)][n], one row a warp's 32 rows
  int first;           // kEpiAcc, kEpiDh: store, where later chunks add
  int approximate;
};

// `live` (0-4) consecutive floats at p: one float4 where VEC and all four
// are live, else one by one (zeros past live).
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, int live, float (&v)[4]) {
  if (VEC && live == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < live ? p[c] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int live, const float (&v)[4]) {
  if (VEC && live == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < live) p[c] = v[c];
  }
}

// Two consecutive floats at p, `live` of them (0-2) written.
template <bool VEC>
__device__ __forceinline__ void store2(float* p, int live, float v0, float v1) {
  if (VEC && live >= 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (live > 0) p[0] = v0;
    if (live > 1) p[1] = v1;
  }
}

// One C tile of one product and its epilogue (the bf16 path's, with T =
// float). blockIdx.z picks the product: with kslice 0, p0 / e0 or (z = 1)
// p1 / e1, two products of one shape in one grid (the two dW, whose tiles
// fill the card's waves together); with kslice > 0, K slice z of p0 (k from
// z kslice, at most kslice of it) into slice z of e0.out, [gridDim.z][m][ldo].
// A thread's outputs are 4-column pieces (sgemm_tile.cuh tile_col): for
// kEpiAcc a row's two pieces of the running dW are read before either is
// written. Rows at or past m and columns at or past n are never written.
template <int L, bool VEC, int E>
__global__ void __launch_bounds__(sg::kThreads, 2)
mlp_sgemm_kernel(const sg::Operands p0, const EpiArgs32 e0, const sg::Operands p1,
                 const EpiArgs32 e1, int kslice) {
  // field by field, so that nothing is copied to local memory
  const bool z1 = kslice == 0 && blockIdx.z != 0;
  sg::Operands p{z1 ? p1.a : p0.a,     z1 ? p1.b : p0.b, z1 ? p1.lda : p0.lda,
                 z1 ? p1.ldb : p0.ldb, z1 ? p1.m : p0.m, z1 ? p1.n : p0.n,
                 z1 ? p1.k : p0.k};
  EpiArgs32 e{z1 ? e1.out : e0.out,           z1 ? e1.ldo : e0.ldo,
              z1 ? e1.bias : e0.bias,         z1 ? e1.dh : e0.dh,
              z1 ? e1.db1_part : e0.db1_part, z1 ? e1.first : e0.first,
              z1 ? e1.approximate : e0.approximate};
  if (kslice > 0) {
    const int k0 = int(blockIdx.z) * kslice;
    p.a += L == sg::kTN ? size_t(k0) * p.lda : size_t(k0);
    p.b += L == sg::kNT ? size_t(k0) : size_t(k0) * p.ldb;
    p.k = min(kslice, p.k - k0);
    e.out += size_t(blockIdx.z) * p.m * e.ldo;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * sg::kBM, n0 = blockIdx.x * sg::kBN;
  float acc[sg::kThreadRows][sg::kThreadCols];
  sg::mainloop<L, VEC>(acc, reinterpret_cast<float*>(smem_raw), p, m0, n0);

  // sums: kEpiDh, this thread's column sums of dh
  constexpr bool kBias = E == kEpiGelu || E == kEpiPre || E == kEpiBias;
  float bias[sg::kThreadCols], sums[sg::kThreadCols];
#pragma unroll
  for (int j = 0; j < sg::kThreadCols; ++j) {
    const int col = n0 + sg::tile_col(j);
    sums[j] = 0.f;
    bias[j] = kBias && col < p.n ? e.bias[col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < sg::kThreadRows; ++i) {
    const int row = m0 + sg::tile_row(i);
    if (row >= p.m) continue;
    float* orow = e.out + size_t(row) * e.ldo;
    float old[2][4];
    int live[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + sg::tile_col(4 * q);
      live[q] = col < p.n ? min(4, p.n - col) : 0;
      if (E == kEpiAcc && !e.first) load4<VEC>(orow + col, live[q], old[q]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (live[q] == 0) continue;
      const int col = n0 + sg::tile_col(4 * q);
      const float v[4] = {acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                          acc[i][4 * q + 3]};
      if constexpr (E == kEpiDh) {
        // h a piece at a time, a and dh stored a pair at a time: few values
        // live across the GELU calls, under the 128 registers of two
        // blocks an SM
        load4<VEC>(orow + col, live[q], old[q]);
        float* dh_row = e.dh + size_t(row) * e.ldo + col;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float4 g = gelu_grad_pair(old[q][2 * p], old[q][2 * p + 1], e.approximate);
          // the product rounded alone: the sums add the dh that is stored
          const float d0 = __fmul_rn(g.z, v[2 * p]), d1 = __fmul_rn(g.w, v[2 * p + 1]);
          const int pair_live = min(2, max(0, live[q] - 2 * p));
          if (pair_live > 0) sums[4 * q + 2 * p] += d0;
          if (pair_live > 1) sums[4 * q + 2 * p + 1] += d1;
          store2<VEC>(orow + col + 2 * p, pair_live, g.x, g.y);
          store2<VEC>(dh_row + 2 * p, pair_live, d0, d1);
        }
        continue;
      }
      float res[4];
      if constexpr (E == kEpiGelu) {
#pragma unroll
        for (int c = 0; c < 4; ++c) res[c] = gelu_value(v[c] + bias[4 * q + c], e.approximate);
      } else if constexpr (E == kEpiPre || E == kEpiBias) {
#pragma unroll
        for (int c = 0; c < 4; ++c) res[c] = v[c] + bias[4 * q + c];
      } else if constexpr (E == kEpiAcc) {
#pragma unroll
        for (int c = 0; c < 4; ++c) res[c] = e.first ? v[c] : old[q][c] + v[c];
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) res[c] = v[c];
      }
      store4<VEC>(orow + col, live[q], res);
    }
  }
  if constexpr (E == kEpiDh) {
    // the warp's 32 rows of each column: the four lanes of one column (same
    // lane % 8) add theirs, and lane (lane % 8) adds the sum into its row
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < sg::kThreadCols; ++j) {
      sums[j] += __shfl_xor_sync(0xffffffffu, sums[j], 8);
      sums[j] += __shfl_xor_sync(0xffffffffu, sums[j], 16);
    }
    if (lane < 8) {
      float* part = e.db1_part + size_t(blockIdx.y * sg::kWarpsM + warp / sg::kWarpsN) * p.n;
#pragma unroll
      for (int j = 0; j < sg::kThreadCols; ++j) {
        const int col = n0 + sg::tile_col(j);
        if (col < p.n) part[col] = (e.first ? 0.f : part[col]) + sums[j];
      }
    }
  }
}

// One product, two of one shape (`count` 2: p1, e1 the second), or K slices
// of one (`count` slices of kslice).
template <int L, bool VEC, int E>
cudaError_t launch_sgemm(const sg::Operands& p, const EpiArgs32& e, cudaStream_t stream,
                         int count = 1, const sg::Operands* p1 = nullptr,
                         const EpiArgs32* e1 = nullptr, int kslice = 0) {
  // above 48 KB a block: set once per kernel (a failure is returned on every call)
  static const cudaError_t attr =
      cudaFuncSetAttribute(mlp_sgemm_kernel<L, VEC, E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(sg::kBytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.n + sg::kBN - 1) / sg::kBN, (p.m + sg::kBM - 1) / sg::kBM, count);
  mlp_sgemm_kernel<L, VEC, E><<<grid, sg::kThreads, sg::kBytes, stream>>>(
      p, e, p1 ? *p1 : p, e1 ? *e1 : e, kslice);
  return cudaGetLastError();
}

// K slices of a chunk's kNN product (rc rows): the wrapper's `splits` for a
// chunk of cap rows (the scratch holds splits slices of cap rows); a
// shorter chunk takes more, as many as fill two blocks an SM, within the
// scratch, one k-step a slice and kRedGroups slices at most (reduce_partials
// adds them in slice order), none empty. The wrapper's fp32_chunk_splits is
// the same rule.
int chunk_splits(int rc, int cap, int d, int h, int splits, int sms) {
  if (splits <= 1) return 1;
  const int tiles = ((rc + sg::kBM - 1) / sg::kBM) * ((d + sg::kBN - 1) / sg::kBN);
  const int steps = (h + sg::kBK - 1) / sg::kBK;
  int want = splits;
  if (tiles * splits < 2 * sms)
    want = std::max(splits, std::min({(2 * sms + tiles - 1) / tiles,
                                      int((long long)splits * cap / rc), steps, kRedGroups}));
  const int per = (steps + want - 1) / want;
  return (steps + per - 1) / per;
}

// out [rc, d] (rows d apart) = A [rc, h] . B [h, d], K = h, plus `bias` by
// column where one is given: the forward's a W2 + b2 and the backward's
// dh W1, one function. One launch, or (chunk_splits > 1) K slices of whole
// k-steps, none empty, each slice's partial [rc, d] into scratch; then
// reduce_partials adds the slices in slice order and the bias once, after
// the whole sum.
template <bool VEC>
cudaError_t kn_product(const float* a, const float* b, const float* bias, float* out,
                       float* scratch, int rc, int cap, int d, int h, int call_splits, int sms,
                       cudaStream_t stream) {
  const sg::Operands p{a, b, h, d, rc, d, h};
  const int splits = chunk_splits(rc, cap, d, h, call_splits, sms);
  if (splits > 1) {
    const int steps = (h + sg::kBK - 1) / sg::kBK;
    const int kslice = (steps + splits - 1) / splits * sg::kBK;
    const EpiArgs32 e{scratch, d, nullptr, nullptr, nullptr, 0, 0};
    COLXLIP_TRY((launch_sgemm<sg::kNN, VEC, kEpiRound>(p, e, stream, splits, nullptr, nullptr,
                                                       kslice)));
    return reduce_partials(scratch, out, splits, rc * d, stream, Finish{nullptr, bias, d});
  }
  const EpiArgs32 e{out, d, bias, nullptr, nullptr, 0, 0};
  return bias != nullptr ? launch_sgemm<sg::kNN, VEC, kEpiBias>(p, e, stream)
                         : launch_sgemm<sg::kNN, VEC, kEpiRound>(p, e, stream);
}

// ws: [cap, h] fp32 (a); scratch (splits > 1): splits * cap * d fp32 (a W2's
// K slices). The rows go in near-equal chunks of whole 128-row tiles, the
// fewest that keep each within `chunk` rows: chunk c is tiles [c T / n,
// (c + 1) T / n) of the T tiles, and cap the longest. The wrapper's
// fp32_fwd_plan is the same rule.
template <bool VEC>
cudaError_t fp32_fwd(const Args& a, const float* b2, float* out, float* ws, float* scratch,
                     int chunk, int splits) {
  const float* x = static_cast<const float*>(a.x);
  const float* w1 = static_cast<const float*>(a.w1);
  const float* b1 = static_cast<const float*>(a.b1);
  const float* w2 = static_cast<const float*>(a.w2);
  const int tiles = (a.rows + sg::kBM - 1) / sg::kBM, per = chunk / sg::kBM;
  const int chunks = (tiles + per - 1) / per;
  const int cap = std::min(a.rows, (tiles + chunks - 1) / chunks * sg::kBM);
  const int sms = multiprocessors();
  for (int c = 0; c < chunks; ++c) {
    const int r0 = int((long long)tiles * c / chunks) * sg::kBM;
    const int rc = std::min(a.rows, int((long long)tiles * (c + 1) / chunks) * sg::kBM) - r0;
    const sg::Operands up{x + size_t(r0) * a.d, w1, a.d, a.d, rc, a.h, a.d};
    const EpiArgs32 e_up{ws, a.h, b1, nullptr, nullptr, 0, a.approximate};
    COLXLIP_TRY((launch_sgemm<sg::kNT, VEC, kEpiGelu>(up, e_up, a.stream)));
    COLXLIP_TRY(kn_product<VEC>(ws, w2, b2, out + size_t(r0) * a.d, scratch, rc, cap, a.d, a.h,
                                splits, sms, a.stream));
  }
  return cudaSuccess;
}

// ws: 2 [cap, h] fp32 (h, then a; dh), cap = min(rows, chunk); o.scratch:
// 4 ceil(cap / 128) * h (db1 sums, one row a warp's 32 rows) + colsum_blocks
// * d (db2 partials) + (splits > 1: splits * cap * d, dx's K slices) fp32.
template <bool VEC>
cudaError_t fp32_bwd(const Args& a, const BwdOut& o, float* ws, int chunk) {
  const float* x = static_cast<const float*>(a.x);
  const float* w1 = static_cast<const float*>(a.w1);
  const float* b1 = static_cast<const float*>(a.b1);
  const float* w2 = static_cast<const float*>(a.w2);
  const float* dy = static_cast<const float*>(o.dy);
  float* dx = static_cast<float*>(o.dx);
  const int cap = std::min(chunk, a.rows);
  float* hid = ws;                          // h, then a
  float* dh = ws + size_t(cap) * a.h;
  const int part_rows = sg::kWarpsM * ((cap + sg::kBM - 1) / sg::kBM);
  float* db1_part = o.scratch;
  float* db2_part = db1_part + size_t(part_rows) * a.h;
  float* dx_part = db2_part + size_t(o.colsum_blocks) * a.d;
  const int sms = multiprocessors();

  COLXLIP_TRY(column_sums(dy, db2_part, o.db2, a.rows, a.d, o.colsum_blocks, a.stream));
  for (int r0 = 0; r0 < a.rows; r0 += chunk) {
    const int rc = std::min(chunk, a.rows - r0), first = r0 == 0;
    const float* xc = x + size_t(r0) * a.d;
    const float* dyc = dy + size_t(r0) * a.d;
    const sg::Operands up{xc, w1, a.d, a.d, rc, a.h, a.d};
    const EpiArgs32 e_pre{hid, a.h, b1, nullptr, nullptr, 0, a.approximate};
    COLXLIP_TRY((launch_sgemm<sg::kNT, VEC, kEpiPre>(up, e_pre, a.stream)));
    const sg::Operands da{dyc, w2, a.d, a.d, rc, a.h, a.d};
    const EpiArgs32 e_dh{hid, a.h, nullptr, dh, db1_part, first, a.approximate};
    COLXLIP_TRY((launch_sgemm<sg::kNT, VEC, kEpiDh>(da, e_dh, a.stream)));
    // dW2 += a^T dy and dW1 += dh^T x: K is the chunk's rows
    const sg::Operands gw2{hid, dyc, a.h, a.d, a.h, a.d, rc};
    const EpiArgs32 e_w2{o.dw2, a.d, nullptr, nullptr, nullptr, first, a.approximate};
    const sg::Operands gw1{dh, xc, a.h, a.d, a.h, a.d, rc};
    const EpiArgs32 e_w1{o.dw1, a.d, nullptr, nullptr, nullptr, first, a.approximate};
    COLXLIP_TRY((launch_sgemm<sg::kTN, VEC, kEpiAcc>(gw2, e_w2, a.stream, 2, &gw1, &e_w1)));
    COLXLIP_TRY(kn_product<VEC>(dh, w1, nullptr, dx + size_t(r0) * a.d, dx_part, rc, cap, a.d,
                                a.h, o.splits, sms, a.stream));
  }
  // the first chunk wrote every warp's row of sums that a later chunk adds to
  return reduce_partials(db1_part, o.db1, part_rows, a.h, a.stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// 16-byte copies and stores where every row of every operand allows them.
cudaError_t dispatch_fp32_fwd(const Args& a, const void* b2, void* out, float* ws,
                              float* scratch, int chunk, int splits) {
  const bool vec = a.d % 4 == 0 && a.h % 4 == 0 && aligned16(a.x) && aligned16(a.w1) &&
                   aligned16(a.w2) && aligned16(out) && aligned16(ws) && aligned16(scratch);
  const float* bias = static_cast<const float*>(b2);
  float* o = static_cast<float*>(out);
  return vec ? fp32_fwd<true>(a, bias, o, ws, scratch, chunk, splits)
             : fp32_fwd<false>(a, bias, o, ws, scratch, chunk, splits);
}

cudaError_t dispatch_fp32_bwd(const Args& a, const BwdOut& o, float* ws, int chunk) {
  const bool vec = a.d % 4 == 0 && a.h % 4 == 0 && aligned16(a.x) && aligned16(a.w1) &&
                   aligned16(a.w2) && aligned16(o.dy) && aligned16(o.dx) && aligned16(o.dw1) &&
                   aligned16(o.dw2) && aligned16(ws) && aligned16(o.scratch);
  return vec ? fp32_bwd<true>(a, o, ws, chunk) : fp32_bwd<false>(a, o, ws, chunk);
}

bool bad_shape(int rows, int d, int h, int dtype, const void* ws, int chunk) {
  if (rows < 1 || d < 1 || h < 1 || ws == nullptr) return true;
  if (dtype == 0) return chunk < sg::kBM || chunk % sg::kBM;
  return dtype != 1 || d % 8 || h % 8 || chunk < gemm::kBM || chunk % gemm::kBM;
}

}  // namespace

// x, out [rows, d]; w1, w2 [h, d]; b1 [h]; b2 [d], all of one dtype (0 =
// float32, 1 = bfloat16); chunk_rows a multiple of 128. bf16: d and h
// multiples of 8, x, w1, w2 16-byte aligned, workspace [min(rows,
// chunk_rows), h] bf16; splits 1, scratch unused. float32: any d, workspace
// [cap, h] float32 and, where splits > 1, scratch splits * cap * d float32
// (a W2's K slices), cap the longest of the near-equal chunks of at most
// chunk_rows rows (the wrapper's fp32_fwd_plan). Returns a cudaError_t (0 =
// launched).
extern "C" int colxlip_fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* out, void* workspace,
                                     void* scratch, int rows, int d, int h, int approximate,
                                     int chunk_rows, int splits, int dtype, void* stream) {
  if (bad_shape(rows, d, h, dtype, workspace, chunk_rows) || splits < 1 ||
      (dtype == 1 && splits != 1) || (splits > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  const Args a{x, w1, b1, w2, rows, d, h, approximate, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return dispatch_fp32_fwd(a, b2, out, static_cast<float*>(workspace),
                             static_cast<float*>(scratch), chunk_rows, splits);
  return bf16_fwd(a, b2, out, static_cast<bf16*>(workspace), chunk_rows);
}

// As the forward, plus dy, dx [rows, d] in the same dtype; out dw1, dw2 [h, d],
// db1 [h], db2 [d] float32; chunk_rows a multiple of 128, workspace 2
// [min(rows, chunk_rows), h] in the dtype. float32: scratch 4 ceil(cap / 128)
// * h + colsum_blocks * d (+ splits * cap * d where splits > 1: dx's K
// slices) float32, cap = min(rows, chunk_rows). bf16: scratch chunk_rows / 64
// * h + colsum_blocks * d float32, splits unused.
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
  if (dtype == 0) return dispatch_fp32_bwd(a, o, static_cast<float*>(workspace), chunk_rows);
  return bf16_bwd(a, o, static_cast<bf16*>(workspace), chunk_rows);
}
