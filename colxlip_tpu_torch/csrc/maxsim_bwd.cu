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
// similarity and silently zero whole rows of the gradient. The route pass
// uses the forward's own tile code (maxsim_tile.cuh, same plan, same
// products), so here the two agree bit for bit anyway.
//
// Five kernels on the stream:
//   1. route: the forward's tensor-core tile (128 flattened text rows against
//      one image), its warp-local row max, and for every (m, k, n) the max
//      (fp32 [M, K, Lt]), the candidate words (uint32 [M, K, Lt,
//      ceil(Li / 32)], bit q set where sim >= max - 2^-12 |max|) and the one
//      tied token, or -1 (a zero row: every column ties), or -2 (several
//      candidates; int32 [M, K, Lt]).
//      A lane holds two columns of each n-tile; the quad's four lanes OR their
//      bits with two shuffles, and the quad's first lane carries the row's
//      current word in a register and stores each word once, in column
//      order: no shared memory, no atomics, any Li. Where Li takes more than
//      one column group, a first sweep finds the max and a second recomputes
//      the same products for the words.
//   2. settle: a row with more than one candidate (-2), other than a zero
//      row, is a near-tie that the tensor-core sum and a sequential fp32 sum
//      over the features could rank differently (two sums that differ may
//      even round to the same fp32 value in one order and not the other).
//      One thread takes each such candidate's similarity again as fmaf over
//      the features in order (the plain version's fp32 order), keeps the ties
//      at that max and writes the row's words, token and max. So both routes
//      send a near-tie the same way: without this pass the bf16 check at the
//      training shape read a dI error of 0.00794 of the largest gradient, over
//      its bar of 2^-7, from near-ties routed to other tokens (PERF.md). A
//      handful of rows.
//   3. coef, one warp per (m, k): the masked-mean weights from the max.
//   4. dT, one block per (m, n) and slice of at most kMaxD features: 8
//      warps split the K images, each adds the tied image rows' slice times
//      the coefficient into its own fp32 row in shared memory; the 8 rows are
//      summed in a fixed order at the end. Each element's sum runs over k in
//      the same order whatever the slicing, so D <= kMaxD (one slice) and
//      wider D give each element the same bits as one slice would.
//   5. dI, one block per (image k, slice of 128 features, range of image
//      tokens): dI[k] sums over all M * Lt text tokens. The block keeps its
//      [tokens, 128] fp32 slice in shared memory. Its 16 warps are 4 owner
//      groups of 4: the group (q - q0) % 4 owns image token q, and each of
//      its warps takes 32 of the slice's features, a lane each. Stages of 128
//      text rows (64 in fp32) go into shared memory by cp.async, their slices
//      with their coefficients and tied tokens, two stages in flight; every
//      warp walks each stage in ascending (m, n) order, a ballot over 32 rows
//      at a time, adding only into the tokens its group owns. Each sum so runs
//      in one fixed order with no float atomics: two runs give the same bits.
//      A token that collects most ties (as one does at random init) leaves
//      four warps most of the work; they read the text rows from shared
//      memory four at a time. A first version, one warp a token reading the
//      rows from device memory, took 25.7 ms of a step there (PERF.md).
//
// What bounds it on the H100: the route pass recomputes the similarities,
// 2 M K Lt Li D = 1 TFLOP at the training shape (M = K = 256, Lt = 77,
// Li = 196, D = 512) on the tensor cores, as the forward; dT and dI do
// M K Lt D FMAs each (2.6 G, fewer for rows whose coefficient is 0) and read
// their operand rows from L2.

#include "maxsim_tile.cuh"

namespace {

using colxlip::from_f;
using colxlip::to_f;
using colxlip::mma::bf16;
using namespace colxlip::maxsim_tile;

constexpr int kCoefWarps = 8;
constexpr int kDtWarps = 8;
constexpr int kMaxD = 4096;        // dT's slice: kDtWarps * kMaxD fp32 = 128 KB of rows
constexpr int kDiWarps = 16;
constexpr int kDiSlice = 128;      // features of dI per block
constexpr int kDiGroups = kDiSlice / 32;        // warps across the slice's features
constexpr int kDiOwners = kDiWarps / kDiGroups;  // token-owner groups of warps
constexpr int kDiBatch = 4;        // text rows a warp reads together
constexpr int kDiMaxTokens = 256;  // image tokens a block: 128 KB of fp32 rows

// The tie bits of one n-tile for the thread's row (columns c + 2t, c + 2t + 1
// of the quad's row), OR-ed over the quad: the row's 8 columns c .. c + 7.
__device__ __forceinline__ uint32_t quad_bits(bool lo, bool hi, int lane) {
  uint32_t b = (uint32_t(lo) | (uint32_t(hi) << 1)) << (2 * (lane & 3));
  b |= __shfl_xor_sync(0xffffffffu, b, 1);
  return b | __shfl_xor_sync(0xffffffffu, b, 2);
}

// route_q of a row whose near-ties the settle pass decides
constexpr int kUnsettled = -2;

// The margin under a row's max inside which the tensor-core sum (bf16
// products summed by mma.sync) and a sequential fp32 sum over the features
// (the plain version's order) may rank two columns differently: 2^-12 of
// |max|, some hundred times the two sums' difference on unit-norm tokens.
__device__ __forceinline__ float near_margin(float m) {
  return fmaxf(fabsf(m), 1e-6f) * 0x1p-12f;
}

// The candidate words of one row (columns at or above max - margin), written
// in column order by the quad's first lane.
struct TieRow {
  unsigned* out;  // the row's words
  int word = 0;
  uint32_t bits = 0;
  int count = 0;
  int first = -1;

  __device__ __forceinline__ void flush() {
    if (bits) {
      if (first < 0) first = word * 32 + __ffs(bits) - 1;
      count += __popc(bits);
    }
    if (out) out[word] = bits;
  }
  // the 8 bits of columns c .. c + 7 (c a multiple of 8, c < li)
  __device__ __forceinline__ void add(int c, uint32_t b8) {
    if ((c >> 5) != word) {
      flush();
      word = c >> 5;
      bits = 0;
    }
    bits |= b8 << (c & 31);
  }
};

// The candidate bits of a group's columns for the thread's two rows.
template <int NP>
__device__ __forceinline__ void tie_bits(const float (&acc)[2 * NP][4], int col0, int li,
                                         float m0, float m1, TieRow& t0, TieRow& t1, int lane) {
  const float th0 = m0 - near_margin(m0), th1 = m1 - near_margin(m1);
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt) {
    const int c = col0 + 8 * nt;
    const uint32_t b0 = quad_bits(acc[nt][0] >= th0, acc[nt][1] >= th0, lane);
    const uint32_t b1 = quad_bits(acc[nt][2] >= th1, acc[nt][3] >= th1, lane);
    if ((lane & 3) == 0 && c < li) {
      t0.add(c, b0);
      t1.add(c, b1);
    }
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 1)
maxsim_bwd_route_kernel(const T* __restrict__ text, const T* __restrict__ image,
                        float* __restrict__ max_sim, unsigned* __restrict__ ties,
                        int* __restrict__ route_q, int rows, int num_k, int lt, int li, int d,
                        int groups, int words, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlockRows;
  const int r0 = row0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
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
    const size_t i0 = mkn(r0 < rows ? r0 : 0, lt, num_k, k);
    const size_t i1 = mkn(r1 < rows ? r1 : 0, lt, num_k, k);
    TieRow t0{r0 < rows ? ties + i0 * words : nullptr};
    TieRow t1{r1 < rows ? ties + i1 * words : nullptr};
    if (groups == 1) {
      tie_bits<NP>(acc, 0, li, m0, m1, t0, t1, lane);
    } else {
      for (int gi = 0; gi < groups; ++gi) {
        sim_group<T, NP>(acc, smem, text, ik, rows, row0, li, gi * 16 * NP, d, aligned != 0);
        tie_bits<NP>(acc, gi * 16 * NP, li, m0, m1, t0, t1, lane);
      }
    }
    if ((lane & 3) == 0) {
      t0.flush();
      t1.flush();
      // one candidate is the plain version's argmax too; a zero row (max
      // exactly 0, every similarity exactly 0) ties everywhere in any order;
      // anything else the settle pass decides
      if (r0 < rows) {
        max_sim[i0] = m0;
        route_q[i0] = t0.count == 1 ? t0.first : m0 != 0.f ? kUnsettled : -1;
      }
      if (r1 < rows) {
        max_sim[i1] = m1;
        route_q[i1] = t1.count == 1 ? t1.first : m1 != 0.f ? kUnsettled : -1;
      }
    }
  }
}

// The rows with more than one candidate near the max: each
// candidate's similarity again as a sequential fp32 sum over the features,
// fmaf in feature order, the plain version's order, and the ties among those.
// A handful of rows at the training shape (one thread each).
template <typename T>
__global__ void __launch_bounds__(256)
maxsim_bwd_settle_kernel(const T* __restrict__ text, const T* __restrict__ image,
                         float* __restrict__ max_sim, unsigned* __restrict__ ties,
                         int* __restrict__ route_q, long long n_rows, int num_k, int lt, int li,
                         int d, int words) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;  // (m K + k) Lt + n
  if (r >= n_rows || route_q[r] != kUnsettled) return;
  const long long mk = r / lt;
  const long long m = mk / num_k;
  const int k = int(mk - m * num_k);
  const T* trow = text + (m * lt + (r - mk * lt)) * d;
  unsigned* w = ties + r * words;
  auto sim = [&](int q) {
    const T* irow = image + (size_t(k) * li + q) * d;
    float acc = 0.f;
    for (int e = 0; e < d; ++e) acc = fmaf(to_f(trow[e]), to_f(irow[e]), acc);
    return acc;
  };
  float best = -INFINITY;
  for (int i = 0; i < words; ++i)
    for (unsigned b = w[i]; b; b &= b - 1) best = fmaxf(best, sim(32 * i + __ffs(b) - 1));
  int count = 0, first = -1;
  for (int i = 0; i < words; ++i) {
    unsigned keep = 0u;
    for (unsigned b = w[i]; b; b &= b - 1) {
      const int q = 32 * i + __ffs(b) - 1;
      if (sim(q) >= best) {
        keep |= 1u << (q & 31);
        count += 1;
        if (first < 0) first = q;
      }
    }
    w[i] = keep;
  }
  max_sim[r] = best;
  route_q[r] = count == 1 ? first : -1;
}

__global__ void __launch_bounds__(kCoefWarps * 32)
maxsim_bwd_coef_kernel(const float* __restrict__ max_sim, const float* __restrict__ text_mask,
                       const float* __restrict__ g, float* __restrict__ coef, long long pairs,
                       int num_k, int lt, int mask_mode) {
  const int lane = threadIdx.x & 31;
  const long long p = blockIdx.x * (long long)kCoefWarps + (threadIdx.x >> 5);  // m * K + k
  if (p >= pairs) return;
  const float* row = max_sim + p * lt;
  const float* mask_row = text_mask + (p / num_k) * lt;
  float w = 0.f;
  for (int n = lane; n < lt; n += 32) w += token_weight(mask_mode, row[n], mask_row, n);
  w = colxlip::warp_sum(w);
  const float gmk = g[p];
  for (int n = lane; n < lt; n += 32)
    coef[p * lt + n] = mask_mode == 1 ? gmk / float(lt)
                                      : gmk * token_weight(mask_mode, row[n], mask_row, n) /
                                            (w + kEps);
}

// Calls f(q) for every image token q tied at the max of route row r, in
// ascending q: the one token route_q names, else every bit of the tie words
// (lanes load 32 words at a time, the whole warp walks the bits in step).
template <typename F>
__device__ __forceinline__ void for_each_tie(const unsigned* __restrict__ ties,
                                             const int* __restrict__ route_q, size_t r, int words,
                                             int lane, F&& f) {
  const int q = route_q[r];
  if (q >= 0) {
    f(q);
    return;
  }
  for (int w0 = 0; w0 < words; w0 += 32) {
    const unsigned mine = w0 + lane < words ? ties[r * words + w0 + lane] : 0u;
    const int n = min(32, words - w0);
    for (int w = 0; w < n; ++w) {
      unsigned bits = __shfl_sync(0xffffffffu, mine, w);
      while (bits) {
        f((w0 + w) * 32 + __ffs(bits) - 1);
        bits &= bits - 1;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kDtWarps * 32)
maxsim_bwd_dt_kernel(const T* __restrict__ image, const float* __restrict__ coef,
                     const unsigned* __restrict__ ties, const int* __restrict__ route_q,
                     T* __restrict__ dtext, int num_k, int lt, int li, int d, int words,
                     int slice) {
  extern __shared__ float dt_acc[];  // [kDtWarps, slice]
  const int m = blockIdx.x / lt;
  const int n = blockIdx.x - m * lt;
  const int d0 = blockIdx.y * slice;  // the block's features d0 .. d0 + width - 1
  const int width = min(slice, d - d0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = dt_acc + size_t(warp) * width;
  for (int e = lane; e < width; e += 32) acc[e] = 0.f;
  for (int k = warp; k < num_k; k += kDtWarps) {
    const size_t r = (size_t(m) * num_k + k) * lt + n;
    const float c = coef[r];
    if (c == 0.f) continue;  // warp-uniform: a zero coefficient adds nothing
    for_each_tie(ties, route_q, r, words, lane, [&](int q) {
      const T* irow = image + (size_t(k) * li + q) * d + d0;
      for (int e = lane; e < width; e += 32) acc[e] = fmaf(c, to_f(irow[e]), acc[e]);
    });
  }
  __syncthreads();
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kDtWarps; ++w) s += dt_acc[size_t(w) * width + e];
    dtext[(size_t(m) * lt + n) * d + d0 + e] = from_f<T>(s);
  }
}

// dT's feature slices: as few as keep each within kMaxD, near-equal in width.
__host__ __device__ constexpr int dt_slices(int d) { return (d + kMaxD - 1) / kMaxD; }
__host__ __device__ constexpr int dt_slice_width(int d) {
  return (d + dt_slices(d) - 1) / dt_slices(d);
}

// Text rows of the slice a dI stage holds: 34 KB of shared memory either way.
template <typename T>
__host__ __device__ constexpr int di_stage_rows() { return sizeof(T) == 2 ? 128 : 64; }
constexpr int kDiRS = kDiSlice + 8;  // a staged text row, elements: 16-byte aligned rows

template <typename T>
__host__ __device__ constexpr size_t di_stage_bytes() {
  return size_t(di_stage_rows<T>()) * (kDiRS * sizeof(T) + sizeof(float) + sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(kDiWarps * 32)
maxsim_bwd_di_kernel(const T* __restrict__ text, const float* __restrict__ coef,
                     const unsigned* __restrict__ ties, const int* __restrict__ route_q,
                     T* __restrict__ dimage, int num_m, int num_k, int lt, int li, int d,
                     int words, int span, int aligned) {
  constexpr int R = di_stage_rows<T>();
  constexpr int kThreadsDi = kDiWarps * 32;
  extern __shared__ __align__(16) unsigned char di_raw[];
  // [span, kDiSlice] fp32 sums, then two stages of R text rows' slices (the
  // input type), their coefficients and tied tokens
  float* di_acc = reinterpret_cast<float*>(di_raw);
  unsigned char* stages = di_raw + size_t(span) * kDiSlice * sizeof(float);
  const int k = blockIdx.x;
  const int d0 = blockIdx.y * kDiSlice;
  const int width = min(kDiSlice, d - d0);
  const int q0 = blockIdx.z * span;
  const int qn = min(span, li - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int idx = threadIdx.x; idx < qn * kDiSlice; idx += blockDim.x) di_acc[idx] = 0.f;

  const int pairs = num_m * lt;
  auto rmk = [&](int p) {  // route row of text row p = m Lt + n against image k
    const int m = p / lt;
    return (size_t(m) * num_k + k) * lt + (p - m * lt);
  };
  auto stage_t = [&](int b) { return reinterpret_cast<T*>(stages + b * di_stage_bytes<T>()); };
  auto stage_c = [&](int b) { return reinterpret_cast<float*>(stage_t(b) + R * kDiRS); };
  auto stage_q = [&](int b) { return reinterpret_cast<int*>(stage_c(b) + R); };
  // stage s into buffer s & 1: the slice of text rows p0 .. p0 + R - 1 and,
  // for each, coef and route_q of (m, k, n); rows past M Lt read as zeros
  auto stage = [&](int s) {
    const int b = s & 1, p0 = s * R;
    T* st = stage_t(b);
    stage_rows<T, R, kDiRS, kThreadsDi>(st, text, p0, pairs, d, d0, aligned != 0);
    stage_rows<T, R, kDiRS, kThreadsDi>(st + kDC, text, p0, pairs, d, d0 + kDC, aligned != 0);
    for (int i = threadIdx.x; i < R; i += kThreadsDi) {
      const bool live = p0 + i < pairs;
      const size_t r = live ? rmk(p0 + i) : 0;
      colxlip::mma::cp_async_4(stage_c(b) + i, coef + r, live);
      colxlip::mma::cp_async_4(stage_q(b) + i, route_q + r, live);
    }
    colxlip::mma::cp_async_commit();
  };

  // Warp (owner, fg) adds into feature f = 32 fg + lane of the slice, for the
  // image tokens q with (q - q0) % kDiOwners == owner: every sum has one
  // warp, which takes the text rows in ascending order. `cur` holds the
  // lane's element of the warp's open row cur_q while rows keep landing on
  // it (one token collects most ties at random init) and goes back to shared
  // memory when another token comes: the same adds in the same order.
  const int fg = warp % kDiGroups, owner = warp / kDiGroups;
  const int f = 32 * fg + lane;
  int cur_q = -1;
  float cur = 0.f;
  auto add_row = [&](int q, float v) {
    if (q != cur_q) {
      if (cur_q >= 0) di_acc[(cur_q - q0) * kDiSlice + f] = cur;
      cur_q = q;
      cur = di_acc[(q - q0) * kDiSlice + f];
    }
    cur += v;
  };
  auto owns = [&](int q) { return q >= q0 && q < q0 + qn && (q - q0) % kDiOwners == owner; };

  // Stage s + 1 flies while the warps walk stage s. The warps of a token's
  // owner group read the text rows from shared memory, kDiBatch at a time,
  // so a token that collects most ties keeps four warps busy at the rate of
  // shared memory, not of device-memory latency.
  const int n_stages = (pairs + R - 1) / R;
  stage(0);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      stage(s + 1);
      colxlip::mma::cp_async_wait<1>();
    } else {
      colxlip::mma::cp_async_wait<0>();
    }
    __syncthreads();  // stage s has landed for every thread (and di_acc is zeroed)
    const T* st = stage_t(s & 1);
    const float* sc = stage_c(s & 1);
    const int* sq = stage_q(s & 1);
    for (int j = 0; j < R; j += 32) {
      const int q = sq[j + lane];  // -1: several tied tokens
      unsigned mine = __ballot_sync(0xffffffffu, sc[j + lane] != 0.f && (q == -1 || owns(q)));
      while (mine) {
        int idx[kDiBatch], qb[kDiBatch];
        float v[kDiBatch];
#pragma unroll
        for (int b = 0; b < kDiBatch; ++b) {
          idx[b] = mine ? j + __ffs(mine) - 1 : -1;
          mine &= mine - 1;
        }
#pragma unroll
        for (int b = 0; b < kDiBatch; ++b) {  // features past D were staged as zeros
          const int i = idx[b] >= 0 ? idx[b] : idx[0];
          v[b] = sc[i] * to_f(st[i * kDiRS + f]);
          qb[b] = sq[i];
        }
#pragma unroll
        for (int b = 0; b < kDiBatch; ++b) {
          if (idx[b] < 0) break;
          if (qb[b] >= 0) {
            add_row(qb[b], v[b]);
          } else {
            for_each_tie(ties, route_q, rmk(s * R + idx[b]), words, lane, [&](int q) {
              if (owns(q)) add_row(q, v[b]);
            });
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buffer s & 1 before stage s + 2 takes it
  }
  if (cur_q >= 0) di_acc[(cur_q - q0) * kDiSlice + f] = cur;
  __syncthreads();
  for (int idx = threadIdx.x; idx < qn * kDiSlice; idx += blockDim.x) {
    const int q = idx / kDiSlice, e = idx - q * kDiSlice;
    if (e < width) dimage[(size_t(k) * li + q0 + q) * d + d0 + e] = from_f<T>(di_acc[idx]);
  }
}

template <typename T, int NP>
cudaError_t launch_route(const void* text, const void* image, float* max_sim, unsigned* ties,
                         int* route_q, int m, int k, int lt, int li, int d, int groups,
                         int words, cudaStream_t stream) {
  const size_t smem = Layout<T, NP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(maxsim_bwd_route_kernel<T, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rows = m * lt;
  const int aligned = async16<T>(text, image, d);
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows, k < 65535 ? k : 65535);
  maxsim_bwd_route_kernel<T, NP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(text), static_cast<const T*>(image), max_sim, ties, route_q, rows,
      k, lt, li, d, groups, words, aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* text, const void* image, const void* mask, const float* g,
                   float* max_sim, float* coef, unsigned* ties, int* route_q, void* dtext,
                   void* dimage, int m, int k, int lt, int li, int d, int mask_mode,
                   cudaStream_t stream) {
  const Plan p = plan(li);
  const int words = (li + 31) / 32;
  cudaError_t err;
  switch (p.np) {
    case 4:
      err = launch_route<T, 4>(text, image, max_sim, ties, route_q, m, k, lt, li, d, p.groups,
                               words, stream);
      break;
    case 8:
      err = launch_route<T, 8>(text, image, max_sim, ties, route_q, m, k, lt, li, d, p.groups,
                               words, stream);
      break;
    case 13:
      err = launch_route<T, 13>(text, image, max_sim, ties, route_q, m, k, lt, li, d, p.groups,
                                words, stream);
      break;
    default:
      err = launch_route<T, 16>(text, image, max_sim, ties, route_q, m, k, lt, li, d, p.groups,
                                words, stream);
  }
  if (err != cudaSuccess) return err;

  const long long n_rows = (long long)m * k * lt;
  maxsim_bwd_settle_kernel<T><<<unsigned((n_rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(text), static_cast<const T*>(image), max_sim, ties, route_q, n_rows,
      k, lt, li, d, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long pairs = (long long)m * k;
  maxsim_bwd_coef_kernel<<<unsigned((pairs + kCoefWarps - 1) / kCoefWarps), kCoefWarps * 32, 0,
                           stream>>>(max_sim, static_cast<const float*>(mask), g, coef, pairs, k,
                                     lt, mask_mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int slice = dt_slice_width(d);
  const size_t dt_smem = size_t(kDtWarps) * slice * sizeof(float);
  err = cudaFuncSetAttribute(maxsim_bwd_dt_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(dt_smem));
  if (err != cudaSuccess) return err;
  const dim3 dt_grid(unsigned(m) * unsigned(lt), dt_slices(d));
  maxsim_bwd_dt_kernel<T><<<dt_grid, kDtWarps * 32, dt_smem, stream>>>(
      static_cast<const T*>(image), coef, ties, route_q, static_cast<T*>(dtext), k, lt, li, d,
      words, slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int spans = (li + kDiMaxTokens - 1) / kDiMaxTokens;
  const int span = (li + spans - 1) / spans;
  const size_t di_smem = size_t(span) * kDiSlice * sizeof(float) + 2 * di_stage_bytes<T>();
  err = cudaFuncSetAttribute(maxsim_bwd_di_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(di_smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(k, (d + kDiSlice - 1) / kDiSlice, spans);
  maxsim_bwd_di_kernel<T><<<grid, kDiWarps * 32, di_smem, stream>>>(
      static_cast<const T*>(text), coef, ties, route_q, static_cast<T*>(dimage), m, k, lt, li, d,
      words, span, async16<T>(text, text, d));
  return cudaGetLastError();
}

}  // namespace

// text [M, Lt, D], image [K, Li, D] (dtype 0 = float32, 1 = bfloat16), mask
// [M, Lt] float32 or null (mask_mode 2 only), g [M, K] float32 (the
// cotangent of the scores); scratch max_sim and coef float32 [M, K, Lt], ties
// uint32 [M, K, Lt, ceil(Li / 32)] and route_q int32 [M, K, Lt]; out dtext
// [M, Lt, D] and dimage [K, Li, D] in the input dtype. Any Lt, Li and D.
// Returns a cudaError_t (0 = launched).
extern "C" int colxlip_maxsim_bwd(const void* text, const void* image, const void* mask,
                                  const void* g, void* max_sim, void* coef, void* ties,
                                  void* route_q, void* dtext, void* dimage, int m, int k, int lt,
                                  int li, int d, int mask_mode, int dtype, void* stream) {
  if (m < 1 || k < 1 || lt < 1 || li < 1 || d < 1 || mask_mode < 0 ||
      mask_mode > 2 || (mask_mode == 2 && mask == nullptr) || (long long)m * k > 0x7fffffffLL ||
      (long long)m * lt > 0x7fffffffLL - kBlockRows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  float* ms = static_cast<float*>(max_sim);
  float* cf = static_cast<float*>(coef);
  unsigned* tf = static_cast<unsigned*>(ties);
  int* rq = static_cast<int*>(route_q);
  if (dtype == 0)
    return launch<float>(text, image, mask, gf, ms, cf, tf, rq, dtext, dimage, m, k, lt, li, d,
                         mask_mode, s);
  if (dtype == 1)
    return launch<bf16>(text, image, mask, gf, ms, cf, tf, rq, dtext, dimage, m, k, lt, li, d,
                        mask_mode, s);
  return cudaErrorInvalidValue;
}
