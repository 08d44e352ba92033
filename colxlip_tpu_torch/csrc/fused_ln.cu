// LayerNorm over the last axis, forward and backward, for Hopper (sm_90a):
// fp32 statistics over a float32 or bfloat16 stream, one read of x per
// direction, nothing saved for the backward but x.
//
// Replaces: colxlip_tpu/ops/fused_ln.py `_fwd_call` (:90, body `_fwd_kernel`
// :58; TPU kernel #7) and `_bwd_call` (:123, body `_bwd_kernel` :68; TPU
// kernel #8). Same arithmetic:
//
//   forward   mu = mean(x), xc = x - mu, var = mean(xc * xc)  (two passes
//             over the row in registers, not E[x^2] - E[x]^2),
//             y = xc * rsqrt(var + eps) * gamma + beta in fp32, cast once
//             to x's type
//   backward  mu and rstd recomputed from x; xhat = xc * rstd,
//             gdo = dy * gamma, m1 = mean(gdo), m2 = mean(gdo * xhat),
//             dx = rstd * (gdo - m1 - xhat * m2) in x's type;
//             dgamma = sum over rows of dy * xhat, dbeta = sum over rows of
//             dy, both fp32
//
// What bounds both on the H100: bytes. The forward moves 2 R D elements and
// the backward 3 R D against about 8 and 16 operations an element; at the
// vision shape (50,432 x 768, bf16) that is 155 and 232 MB, 0.04625 and
// 0.06937 ms at 3.35 TB/s.
//
// Both kernels share one lane layout and one statistics helper. A warp owns
// a row; a lane holds 16-byte vectors (8 bf16 or 4 fp32 values: vector
// lane + 32 c, 3 a lane at D = 768 in bf16; PE values a lane, a template
// bucket with 32 PE >= D <= 1024) and walks every gridDim.x * 8-th row with
// the next row's x in flight while it reduces this one (16 bytes a lane a
// load, evict-first). center_row takes the statistics: a lane sums each
// vector in order, then its vectors in order; a statistic is the warp's
// butterfly of those sums times one fp32 reciprocal of D. So the forward's mu
// and rstd are bit-equal to the ones the backward recomputes. gamma (and, in
// the forward, beta) is staged once a block in shared memory, lane-major
// (stage_lane_major), so a warp reads it as 512 contiguous bytes. A row whose
// width is not a multiple of the vector, or whose base is not 16-byte
// aligned, takes the same body with scalar loads (VEC = false).
//
// Forward (#7): y = fma(xc * rstd, gamma, beta), written as 16-byte
// vectors. Its grid is sized to the card: as
// many blocks as the occupancy calculator keeps resident, at most one warp a
// row (fwd_blocks), so at ViT-L's 4,112 rows every row is in flight in one
// wave, and at the vision shape's 50,432 each warp walks its rows.
//
// Backward (#8): x's vectors are loaded into registers and dy's lines
// prefetched into L1, from where dy is read twice (for the sums, then for dx)
// rather than held: the registers go to x, dgamma and dbeta, and at D = 768
// the kernel fits two blocks an SM (128 registers). dx = fma(dy gamma, rstd,
// fma(xhat, -rstd m2, -rstd m1)). The TPU kernel sums dgamma and dbeta
// across its sequential grid. Here each warp sums the rows it walks in
// registers, the block's warps add up in warp order through shared memory,
// each block writes one partial row, and a second kernel adds the partial
// rows (stream_tile.cuh reduce_partials, which the MLP shares: at 264
// partial rows one block per 32 columns, kRedGroups row groups each summing
// every kRedGroups-th partial row in order, then the groups in order). No
// atomics, so two runs agree bit for bit. Two blocks an SM cap a thread at
// 128 registers; bf16 fits that up to D = 768, fp32 (twice the registers
// for the same x) would spill, so fp32 asks for one block an SM.
//
// Why the backward has no deeper prefetch: it is bound by its own
// instructions and their latency, not by the memory
// (scripts/torch_ln_bench.py on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md):
// without its loads it still takes 0.069 ms at the vision shape, where
// torch.add(x, dy) moves the same bytes in 0.079, and a cp.async or
// bulk-copy ring of 2-4 rows in shared memory, or more warps an SM, moved it
// by a few percent at most. Left for later: fewer instructions a row in the
// backward (each element is unpacked, centred, scaled and summed about 17
// times).

#include <stdint.h>

#include "common.cuh"
#include "stream_tile.cuh"

namespace {

using colxlip::from_f;
using colxlip::to_f;
using colxlip::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 1024;

// A lane's PE values of a row: NV vectors of V = 16 / sizeof(T) elements,
// vector v = lane + 32 c holding elements v V .. v V + V - 1 (PE is the
// bucket's capacity: 32 PE >= D).
template <typename T, int PE>
struct Lanes {
  static constexpr int V = 16 / int(sizeof(T));
  static constexpr int NV = PE / V;
};

// p[0] + p[1] + ... in that order.
template <int N>
__device__ __forceinline__ float in_order(const float (&p)[N]) {
  float s = p[0];
#pragma unroll
  for (int i = 1; i < N; ++i) s += p[i];
  return s;
}

// 16 bytes of V values (T chooses the type) as floats, and V floats back to
// 16 bytes at p.
__device__ __forceinline__ void unpack16(const float*, const uint4& u, float* out) {
  out[0] = __uint_as_float(u.x), out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z), out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16*, const uint4& u, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void pack16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack16(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// v [d] fp32 staged once a block in shared memory, lane-major: float4 q of
// vector c of lane l at dst[(c V / 4 + q) 32 + l] (zeros past d), so a
// warp's read of it is 512 contiguous bytes; 32 lanes x PE / 4 float4.
template <typename T, int PE>
__device__ __forceinline__ void stage_lane_major(float4* dst, const float* __restrict__ v,
                                                 int d) {
  constexpr int V = Lanes<T, PE>::V;
  for (int idx = threadIdx.x; idx < 8 * PE; idx += kThreads) {
    const int l = idx & 31, q = idx >> 5, c = q / (V / 4), j = (q % (V / 4)) * 4;
    const int e = (l + 32 * c) * V + j;
    dst[idx] = make_float4(e < d ? v[e] : 0.f, e + 1 < d ? v[e + 1] : 0.f,
                           e + 2 < d ? v[e + 2] : 0.f, e + 3 < d ? v[e + 3] : 0.f);
  }
}

// The lane's vector c of values staged by stage_lane_major.
template <typename T, int PE>
__device__ __forceinline__ void read_lane_major(const float4* src, int c,
                                                float (&out)[Lanes<T, PE>::V]) {
  constexpr int V = Lanes<T, PE>::V;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 g4 = src[(c * (V / 4) + q) * 32 + lane];
    out[4 * q] = g4.x, out[4 * q + 1] = g4.y, out[4 * q + 2] = g4.z, out[4 * q + 3] = g4.w;
  }
}

// Row xr into xv, zeros past d: VEC, the lane's vectors from nx (loaded
// ahead); else by scalar loads, in the same lane layout.
template <typename T, int PE, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ xr,
                                         const uint4 (&nx)[Lanes<T, PE>::NV], int d,
                                         float (&xv)[PE]) {
  constexpr int V = Lanes<T, PE>::V, NV = Lanes<T, PE>::NV;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int e = (lane + 32 * c) * V;
    if (VEC && e < d) {
      unpack16(xr, nx[c], xv + c * V);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) xv[c * V + j] = !VEC && e + j < d ? to_f(xr[e + j]) : 0.f;
    }
  }
}

// The row's statistics, as both kernels take them: a lane's sums (one chain
// a vector, its V values in order, then the vectors in order), the warp's
// butterfly, one fp32 reciprocal of D. xv becomes x - mu (0 past d);
// returns rstd.
template <typename T, int PE, bool VEC>
__device__ __forceinline__ float center_row(float (&xv)[PE], int d, float inv_d, float eps) {
  constexpr int V = Lanes<T, PE>::V, NV = Lanes<T, PE>::NV;
  const int lane = threadIdx.x & 31;
  float p[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    p[c] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) p[c] += xv[c * V + j];
  }
  // products that feed a sum are rounded alone (__fmul_rn is never
  // contracted into an fma), so every instantiation gives the same bits
  const float mu = __fmul_rn(warp_sum(in_order(p)), inv_d);
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int e = (lane + 32 * c) * V;
    p[c] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = c * V + j;
      xv[i] = (VEC ? e : e + j) < d ? xv[i] - mu : 0.f;   // VEC: a vector is live or dead
      p[c] = fmaf(xv[i], xv[i], p[c]);
    }
  }
  return rsqrtf(__fmul_rn(warp_sum(in_order(p)), inv_d) + eps);
}

// y = T(fma(xc rstd, gamma, beta)) a row a warp, the next row's x in flight.
// VEC: d a multiple of V and x, y 16-byte aligned (else scalar loads and
// stores).
template <typename T, int PE, bool VEC>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int rows, int d, float eps) {
  using L = Lanes<T, PE>;
  constexpr int V = L::V, NV = L::NV;
  __shared__ float4 gb[2][8 * PE];   // gamma, beta lane-major
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_d = 1.f / float(d);
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  const int count = first < rows ? (rows - first + stride - 1) / stride : 0;

  uint4 nx[NV];
  auto fetch = [&](int k) {
    if (k < count) {
      const T* xr = x + size_t(first + k * stride) * d;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int e = (lane + 32 * c) * V;
        if (e < d) nx[c] = __ldcs(reinterpret_cast<const uint4*>(xr + e));
      }
    }
  };
  if constexpr (VEC) fetch(0);
  stage_lane_major<T, PE>(gb[0], gamma, d);
  stage_lane_major<T, PE>(gb[1], beta, d);
  __syncthreads();

  for (int k = 0; k < count; ++k) {
    const size_t off = size_t(first + k * stride) * d;
    float xv[PE];   // x, then x - mu
    load_row<T, PE, VEC>(x + off, nx, d, xv);
    if constexpr (VEC) fetch(k + 1);
    const float rstd = center_row<T, PE, VEC>(xv, d, inv_d, eps);
    T* yr = y + off;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int e = (lane + 32 * c) * V;
      float g[V], b[V], out[V];
      read_lane_major<T, PE>(gb[0], c, g);
      read_lane_major<T, PE>(gb[1], c, b);
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = fmaf(__fmul_rn(xv[c * V + j], rstd), g[j], b[j]);
      if constexpr (VEC) {
        if (e < d) pack16(yr + e, out);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (e + j < d) yr[e + j] = from_f<T>(out[j]);
      }
    }
  }
}

// partials: [gridDim.x][2][d] fp32, row 0 the block's dgamma, row 1 its dbeta.
// VEC: d a multiple of V and x, dy, dx 16-byte aligned (else scalar loads).
template <typename T, int PE, bool VEC>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 && PE <= 24 ? 2 : 1)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partials,
              int rows, int d, float eps) {
  using L = Lanes<T, PE>;
  constexpr int V = L::V, NV = L::NV;
  __shared__ __align__(16) float red[2][kMaxD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_d = 1.f / float(d);
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  const int count = first < rows ? (rows - first + stride - 1) / stride : 0;
  float dg[PE], db[PE];
#pragma unroll
  for (int i = 0; i < PE; ++i) dg[i] = db[i] = 0.f;

  // VEC: the warp's next row in flight while this row is reduced: x's
  // 16-byte vectors into registers, dy's lines into L1 (read twice from there)
  uint4 nx[NV];
  auto fetch = [&](int k) {
    if (k < count) {
      const size_t off = size_t(first + k * stride) * d;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int e = (lane + 32 * c) * V;
        if (e < d) {
          nx[c] = __ldcs(reinterpret_cast<const uint4*>(x + off + e));
          asm volatile("prefetch.global.L1 [%0];\n" ::"l"(dy + off + e));
        }
      }
    }
  };
  if constexpr (VEC) fetch(0);

  // gamma once a block, lane-major: 128 PE bytes, in red until the warps add up
  float4* gs = reinterpret_cast<float4*>(&red[0][0]);
  stage_lane_major<T, PE>(gs, gamma, d);
  __syncthreads();

  for (int k = 0; k < count; ++k) {
    const T* xr = x + size_t(first + k * stride) * d;
    const T* dyr = dy + size_t(first + k * stride) * d;
    float xv[PE];   // x, then x - mu, then xhat
    load_row<T, PE, VEC>(xr, nx, d, xv);
    if constexpr (VEC) fetch(k + 1);
    // vector c of dy and of gamma, zeros past d; read twice a row
    auto load_dy = [&](int c, float (&o)[V], float (&gm)[V]) {
      const int e = (lane + 32 * c) * V;
      if constexpr (VEC) {
        if (e < d) {
          unpack16(x, __ldg(reinterpret_cast<const uint4*>(dyr + e)), o);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) o[j] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = e + j < d ? to_f(dyr[e + j]) : 0.f;
      }
      read_lane_major<T, PE>(gs, c, gm);
    };

    const float rstd = center_row<T, PE, VEC>(xv, d, inv_d, eps);
    // the same sums for m1 = mean(dy gamma) and m2 = mean(dy gamma xhat)
    float p0[NV], p1[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float o[V], gm[V];
      load_dy(c, o, gm);
      p0[c] = p1[c] = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int i = c * V + j;
        xv[i] *= rstd;                          // xhat
        dg[i] = fmaf(o[j], xv[i], dg[i]);
        db[i] += o[j];
        const float go = __fmul_rn(o[j], gm[j]);   // dy * gamma
        p0[c] += go;
        p1[c] = fmaf(go, xv[i], p1[c]);
      }
    }
    const float m1 = __fmul_rn(warp_sum(in_order(p0)), inv_d);
    const float m2 = __fmul_rn(warp_sum(in_order(p1)), inv_d);
    // dx = rstd (go - m1 - xhat m2) = go rstd + (xhat (-rstd m2) + (-rstd m1))
    const float a0 = -rstd * m1, a1 = -rstd * m2;
    T* dxr = dx + size_t(first + k * stride) * d;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int e = (lane + 32 * c) * V;
      float o[V], gm[V], out[V];
      load_dy(c, o, gm);
#pragma unroll
      for (int j = 0; j < V; ++j)
        out[j] = fmaf(__fmul_rn(o[j], gm[j]), rstd, fmaf(xv[c * V + j], a1, a0));
      if constexpr (VEC) {
        if (e < d) pack16(dxr + e, out);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (e + j < d) dxr[e + j] = from_f<T>(out[j]);
      }
    }
  }
  __syncthreads();   // every warp is done with gs before red reuses it

  // the block's warps add up in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int col = (lane + 32 * c) * V + j;
          if (col < d) {
            red[0][col] = (w == 0 ? 0.f : red[0][col]) + dg[c * V + j];
            red[1][col] = (w == 0 ? 0.f : red[1][col]) + db[c * V + j];
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The forward's grid: one warp a row, at most as many blocks as stay
// resident on the card at once (the occupancy calculator's count, read once
// an instantiation), each warp then walking every gridDim.x * 8-th row.
template <typename T, int PE, bool VEC>
int fwd_blocks(int rows) {
  static const int resident = [] {
    int dev = 0, sms = 132, per_sm = 1;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_fwd_kernel<T, PE, VEC>,
                                                      kThreads, 0) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    return per_sm * sms;
  }();
  const int want = (rows + kWarps - 1) / kWarps;
  return want < resident ? want : resident;
}

template <typename T, int PE>
cudaError_t launch_fwd(const Args& a, const float* beta, void* y) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(y);
  if (a.d % Lanes<T, PE>::V == 0 && aligned16(x) && aligned16(out))
    ln_fwd_kernel<T, PE, true><<<fwd_blocks<T, PE, true>(a.rows), kThreads, 0, a.stream>>>(
        x, a.gamma, beta, out, a.rows, a.d, a.eps);
  else
    ln_fwd_kernel<T, PE, false><<<fwd_blocks<T, PE, false>(a.rows), kThreads, 0, a.stream>>>(
        x, a.gamma, beta, out, a.rows, a.d, a.eps);
  return cudaGetLastError();
}

template <typename T, int PE>
cudaError_t launch_bwd(const Args& a, const void* dy, void* dx, float* partials, int blocks) {
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(dy);
  T* out = static_cast<T*>(dx);
  if (a.d % Lanes<T, PE>::V == 0 && aligned16(x) && aligned16(g) && aligned16(out))
    ln_bwd_kernel<T, PE, true><<<blocks, kThreads, 0, a.stream>>>(
        x, a.gamma, g, out, partials, a.rows, a.d, a.eps);
  else
    ln_bwd_kernel<T, PE, false><<<blocks, kThreads, 0, a.stream>>>(
        x, a.gamma, g, out, partials, a.rows, a.d, a.eps);
  return cudaGetLastError();
}

// The forward's bucket, the backward's: PE values a lane, 32 PE >= D (the
// same lanes hold the same vectors, so the statistics agree bit for bit).
template <typename T>
cudaError_t dispatch_fwd(const Args& a, const float* beta, void* y) {
  if (a.d <= 256) return launch_fwd<T, 8>(a, beta, y);
  if (a.d <= 512) return launch_fwd<T, 16>(a, beta, y);
  if (a.d <= 768) return launch_fwd<T, 24>(a, beta, y);
  return launch_fwd<T, 32>(a, beta, y);
}

// The backward's bucket: PE values a lane, 32 PE >= D.
template <typename T>
cudaError_t dispatch_bwd(const Args& a, const void* dy, void* dx, float* partials, int blocks) {
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
  return colxlip::stream_tile::reduce_partials(part, static_cast<float*>(dgb), blocks, 2 * d,
                                               a.stream);
}
