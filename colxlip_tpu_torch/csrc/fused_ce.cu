// Streaming contrastive cross-entropy, forward and backward, for Hopper
// (sm_90a): per-row CE of scale * a @ b^T against integer labels without the
// [M, N] logit matrix in device memory.
//
// Replaces: colxlip_tpu/ops/fused_ce.py `_fwd_call` (:82, body `_fwd_kernel`
// :45; TPU kernel #11) and `_bwd_call` (:180), whose two pallas_calls are
// TPU kernels #12 (:184, body `_bwd_da_kernel` :122: dA and the per-row
// dscale) and #13 (:206, body `_bwd_db_kernel` :152: dB). Same arithmetic:
//
//   forward   z_ij = scale * <a_i, b_j>   (dot accumulated in fp32 from the
//             input dtype, scaled after), online max / sum over column tiles
//             starting from max = -1e30 (not -inf: exp(-inf - -inf) is NaN),
//             lse_i = max + log(sum), loss_i = lse_i - z_{i, label_i} with
//             the label logit picked out of the same scaled tile
//   dA        dz_ij = (exp(z_ij - lse_i) - [j == label_i]) * g_i,
//             dA = scale * dz @ B, scaled after the sum;
//             dscale_i = sum_j dz_ij * <a_i, b_j>
//   dB        dB = scale * dz^T @ A, likewise
//
// dA, dB, loss, lse and dscale leave the kernels in fp32; the wrapper casts
// and sums the per-row dscale. The TPU grid's padding to (8, 128) multiples
// and its n_valid argument are gone: every kernel masks the ragged edge of M
// and N itself, and D is a runtime argument (any D in either dtype).
//
// Hopper has no sequential grid to carry a running sum across, so the loop
// over the streamed dimension sits inside the block: in the forward and in
// dA one block owns rows of a and walks tiles of rows of b; in dB one block
// owns rows of b and walks tiles of rows of a (the transposed grid of
// fused_ce.py:206-220). Where the fp32 kernels split the streamed rows
// across blocks, a second pass adds the slices in a fixed order: there are
// no atomics and two runs agree bit for bit.
//
// What bounds them on the H100: operations. The forward is 2 M N D flops,
// each backward kernel 4 M N D (the logit tile again, then dz times the
// streamed matrix), against (M + N) D input elements: at M = N = 32768,
// D = 512 that is 1.1 and 2.2 TFLOP over 67 MB in bf16 (1.11 and 2.22 ms at
// 989 TFLOP/s). At the one-step shape M = N = 256 launch latency bounds all
// three.
//
// bf16, all three kernels: the tensor cores, on one logit tile. The block
// owns kOwn rows ("own": a for the forward and dA, b for dB; 64 rows for
// D <= 512, 32 above) and walks the other matrix ("stream") in tiles of 64
// rows. Per tile, 8 warps:
//   1. raw = X_own . X_stream^T [kOwn, 64] by mma.sync.m16n8k16 (bf16
//      operands, fp32 sums) from ldmatrix fragments of the own tile (staged
//      once) and the stream tile (a ring of two cp.async stages where two
//      fit in shared memory, D <= 512; one at D = 768): `logit_tile`, one
//      function that all three kernels call. Each k-step of 16 features is
//      taken from a zero accumulator and added in fp32 rounding to nearest
//      (mma_tile.cuh mma_16816_rn): an mma that accumulates in place
//      truncates to the accumulator's last bit, and over 32 k-steps of
//      positive terms (<a_i, a_i> when b = a) that bias, times a scale of
//      100, would move p by 1e-4 relative. Warps: kOwn / 16 row groups times
//      8 / (kOwn / 16) column groups. A k-step's result for (i, j) depends
//      only on that k-step's 16 values of a_i and b_j, and the k-steps are
//      added in the same order in every kernel, so the forward and the
//      backward get the same bits of raw_ij: the backward's
//      p = exp(scale raw - lse) meets the forward's lse of the same sums.
//      When the forward summed in k order on the CUDA cores, b = a at scale
//      100 put dscale at 8.5e-5 of max|grad| against the bar of 1e-4.
//   2. the epilogue, in registers.
//      Forward (#11, `ce_fwd_mma_kernel<DC>`): z = scale raw, -1e30 past N;
//      each thread keeps a running (max, sum) for its two rows over the
//      columns it holds (tile max, the sum rescaled, expf(z - max) added)
//      and the label logit where its column is the label. No second product
//      and nothing in shared memory: at the end the pairs merge in a fixed
//      order, the quad by shuffles, then the column groups through shared
//      memory; lse = max + log(sum), loss = lse - z_label. No [kOwn, D]
//      output accumulator, so it takes far fewer registers than the
//      backward.
//      Backward (`ce_bwd_mma_kernel<DC, DA>`, one body for #12 and #13 with
//      the roles of a and b swapped for dB): dz from the tile, the masks
//      (own rows and stream rows past their ends give 0), lse, g and label
//      by own row (dA, read once) or by stream row (dB, staged with the
//      tile); dA adds dz * raw into the thread's per-row dscale. dz goes to
//      shared memory split in two bf16 halves, dz_hi = bf16(dz),
//      dz_lo = bf16(dz - dz_hi).
//   3. (backward) out[kOwn, D] += dz_hi . X_stream + dz_lo . X_stream by
//      mma.sync, A from the dz halves, B the same stream tile read k-major
//      (ldmatrix.trans). A warp owns 16 rows times D / (8 / (kOwn / 16))
//      features of the fp32 output in registers (128 a thread at D = 512,
//      96 at D = 768); the tile's 8 mma per n-tile go into a zero
//      accumulator that is then added to the output rounding to nearest.
// bf16 past kMaxBf16D = 768 features (the chunked walk): the tiles no longer
// fit whole, so all three kernels take Cfg<768>'s geometry (32 own rows, 4
// column groups) and stream the features through the logit tile in chunks
// of kChunk = 256: own rows and stream rows of one chunk in a stage, two
// stages by cp.async so that the next chunk (or the next tile's first) is in
// flight, raw accumulated in registers across the chunks by
// logit_tile_add. The k-steps run in the same order as over a whole row, so
// raw has the bits one whole tile would give it, in every kernel. The
// backward's grid gains a y axis of output feature slices (as few as keep
// each within 768 features, near-equal, a multiple of 16): each block
// recomputes raw over all of D, then adds dz times the stream tile's slice,
// staged once a tile beside the chunks. Each output element so sums the same
// terms in the same order as a whole tile would. D <= 768 keeps the whole
// tiles and their bits.
// What bounds the bf16 forward: operations, 2 M N D flops (1.11174 ms at
// M = N = 32768, D = 512); it also takes one expf an element (1.07e9 there)
// on the special-function units. The split makes the backward's tensor
// cores run 2 M N D + 2 x 2 M N D = 6 M N D flops for the function's
// 4 M N D. Why it is safe here when it was not for MaxSim
// (csrc/maxsim_tile.cuh): nothing routes on an argmax, the outputs are fp32
// and never rounded to bf16, and X is bf16, exact in one half. One bf16
// rounding of dz would cost 2^-9 of the label term (p - 1) g, near the
// largest term of a row: about 2e-3 of max|grad| against the bar of 1e-4;
// the split leaves 2^-18 (tests/test_torch_ce_tiles.py holds both). D is
// staged in 16-byte pieces: the wrapper pads rows to a multiple of 8
// features with zeros (exact) and the kernels zero-fill features past D;
// n-tiles of the output past D are skipped. No atomics: the forward's pairs
// and dscale's per-thread sums meet in shared memory in a fixed order.
//
// fp32 (all three kernels): fp32 FMAs on the CUDA cores. fp32 runs only
// under --precision fp32, and a tensor-core fp32 product would need three
// split products: it stays here. Both products run on the tiles of
// csrc/stream_tile.cuh, which all three kernels share: raw_tile, a 16 x 16
// thread block over a [rows, 64] tile of raw dots fed by float4 reads from
// row-major chunks of 32 features, two stages filled by cp.async so that
// the next chunk is in flight; and (backward) accumulate, which adds dz for
// the tile (in shared memory) times the streamed rows (staged by cp.async
// too) into 8 output rows x DPT features a thread. Each raw_ij is one fmaf
// chain over the features in order from zero and each output element one
// fmaf chain over the streamed rows in order, so the forward's lse and the
// backward's p meet on the same bits of raw, as on the tensor cores. dA and
// dB hold at most 768 features of a row (DPT = 12); wider rows take feature
// slices along the grid's z axis, each recomputing raw.
// A block owns 64 rows of a (forward), 32 of a (dA) or 32 of b (dB), so at
// a local-loss step's M = 256, N = 1024 the row blocks alone would be 4, 8
// and 32 for 132 SMs, each walking every tile of the other matrix in
// series. So each kernel also splits the streamed rows: the grid is (row
// blocks) x (S slices of the streamed matrix's whole 64-row tiles), S chosen
// by the wrapper (fp32_fwd_slices, fp32_da_slices, fp32_db_slices: two
// blocks an SM; 16, 16 and 4 at 256 x 1024). Block (i, s) stores its slice's
// partials to scratch: the forward its running (max, sum) and label logit of
// each row, merged by ce_fwd_merge_kernel in slice order (merge_lse) into
// lse = max + log(sum) and loss = lse - z_label; dA and dB their unscaled
// partial rows (and dA's dscale), which reduce_partials adds in slice order
// and multiplies by scale once at the end. The split moves only the order in
// which the partials add up across slices; S = 1 (wherever the row blocks
// fill the card) is the unsplit walk, bit for bit.
//
// Next steps for a later PR: wgmma with TMA, a warpgroup reading the stream
// tile once where each of today's warps re-reads its fragments from shared
// memory; a producer warp that keeps the stream tiles in flight while two
// consumer warpgroups run one tile's epilogue under the next tile's
// products (today one block an SM at D = 512 overlaps nothing).

#include "mma_tile.cuh"
#include "stream_tile.cuh"

namespace {

using namespace colxlip::stream_tile;

constexpr float kNeg = -1e30f;
constexpr int kMaxBf16D = 768;   // the bf16 whole tiles' capacity (Cfg<768>); past it, chunks

// (m, s) <- the logsumexp pair of (m, s) and (m2, s2): max, then each sum
// rescaled to it. The same bits in either order (fp32 + and * commute).
__device__ __forceinline__ void merge_lse(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

constexpr int kFwdRows = kTY * 4;   // rows of a a float32 forward block owns

// The forward's label of row `row` of a: -1 past M and for a label outside
// [0, N), which matches no column (the columns of the last tile past N hold
// -1e30; a label there would pick that up as its logit).
__device__ __forceinline__ int label_of(const int* __restrict__ labels, int row, int m, int n) {
  const int l = row < m ? labels[row] : -1;
  return l < n ? l : -1;
}

// ---------------------------------------------------------------------------
// float32 forward (CUDA cores): one block per tile of 64 rows of a
// (blockIdx.x) and per slice of b's rows (blockIdx.y): slice s is the `per`
// whole tiles of 64 rows from tile s per, walked in order from max = -1e30.
// With one slice the block stores lse and loss; with more it stores its
// running max, running sum and label logit of each row into slice s of
// part [3][S][m] (scratch), for launch_fwd32's merge.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
ce_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const int* __restrict__ labels, const float* __restrict__ scale_ptr,
              float* __restrict__ loss, float* __restrict__ lse, float* __restrict__ part, int m,
              int n, int d, int per, bool vec) {
  constexpr int RPT = 4, CPT = 4;
  constexpr int BN = kTX * CPT;
  __shared__ __align__(16) RawStages<RPT, CPT> st;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int i0 = blockIdx.x * kFwdRows;
  const float scale = *scale_ptr;

  float mx[RPT], sum[RPT], zt[RPT];
  int lab[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i0 + ty + kTY * r;
    mx[r] = kNeg;
    sum[r] = 0.f;
    zt[r] = 0.f;
    lab[r] = label_of(labels, row, m, n);
  }

  const int j_first = int(blockIdx.y) * per * BN;
  const int j_end = min(n, int(blockIdx.y + 1) * per * BN);
  raw_prefetch<RPT, CPT>(st, a, b, i0, j_first, m, n, d, vec);
  for (int j0 = j_first; j0 < j_end; j0 += BN) {
    float acc[RPT][CPT];
    raw_tile<RPT, CPT>(a, b, i0, j0, m, n, d, vec, st, acc);
    if (j0 + BN < j_end) raw_prefetch<RPT, CPT>(st, a, b, i0, j0 + BN, m, n, d, vec);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float tmax = kNeg;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = j0 + tx + kTX * c;
        const float z = col < n ? scale * acc[r][c] : kNeg;
        acc[r][c] = z;
        tmax = fmaxf(tmax, z);
        if (col == lab[r]) zt[r] += z;
      }
      const float mnew = fmaxf(mx[r], row_max(tmax));
      float part_sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) part_sum += expf(acc[r][c] - mnew);  // masked: exp(-1e30) = 0
      sum[r] = sum[r] * expf(mx[r] - mnew) + row_sum(part_sum);
      mx[r] = mnew;
    }
  }

  const int slices = gridDim.y;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i0 + ty + kTY * r;
    const float label_logit = row_sum(zt[r]);
    if (tx == 0 && row < m) {
      if (slices == 1) {
        const float l = mx[r] + logf(sum[r]);
        lse[row] = l;
        loss[row] = l - label_logit;
      } else {
        const size_t at = size_t(blockIdx.y) * m + row;
        part[at] = mx[r];
        part[size_t(slices) * m + at] = sum[r];
        part[2 * size_t(slices) * m + at] = label_logit;
      }
    }
  }
}

// The split forward's second pass: a row's S (max, sum) pairs merged in
// slice order from slice 0's, its label logits added in slice order (one
// slice holds the label column, the others give 0), lse = max + log(sum),
// loss = lse - the label logit.
__global__ void ce_fwd_merge_kernel(const float* __restrict__ part, float* __restrict__ loss,
                                    float* __restrict__ lse, int m, int slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const size_t plane = size_t(slices) * m;
  float mm = part[i], ss = part[plane + i], zz = part[2 * plane + i];
  for (int s = 1; s < slices; ++s) {
    merge_lse(mm, ss, part[size_t(s) * m + i], part[plane + size_t(s) * m + i]);
    zz += part[2 * plane + size_t(s) * m + i];
  }
  const float l = mm + logf(ss);
  lse[i] = l;
  loss[i] = l - zz;
}

// ---------------------------------------------------------------------------
// float32 backward (CUDA cores)
// ---------------------------------------------------------------------------

// dA and per-row dscale: one block per tile of 32 rows of a (blockIdx.x),
// per slice of b's rows (blockIdx.y: slice s is the `per` whole tiles of 64
// rows from tile s per, walked in order) and per feature slice of dA
// (blockIdx.z, feature_slice; one up to 768 features). With one slice of b
// the block stores scale * dA and dscale; with more it stores its unscaled
// partials into slice s of da [S][m][d] and dscale [S][m] (scratch), for
// launch_da's second pass. Feature slice 0 stores dscale.
template <int DPT>
__global__ void __launch_bounds__(kThreads, DPT <= 8 ? 2 : 1)
ce_bwd_da_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const int* __restrict__ labels, const float* __restrict__ scale_ptr,
                 const float* __restrict__ lse, const float* __restrict__ g,
                 float* __restrict__ da, float* __restrict__ dscale, int m, int n, int d, int per,
                 bool vec) {
  constexpr int RPT = kOwn / kTY, CPT = kStream / kTX;
  __shared__ __align__(16) BwdShared<RPT, CPT, DPT> sh;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int i0 = blockIdx.x * kOwn;
  const float scale = *scale_ptr;

  float lse_r[RPT], g_r[RPT], ds[RPT];
  int lab[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i0 + ty + kTY * r;
    const bool in = row < m;
    lse_r[r] = in ? lse[row] : 0.f;
    g_r[r] = in ? g[row] : 0.f;
    lab[r] = in ? labels[row] : -1;
    ds[r] = 0.f;
  }
  float out[kAccRows][DPT];
  zero_owned<DPT>(out);

  const int j_end = min(n, int(blockIdx.y + 1) * per * kStream);
  raw_prefetch<RPT, CPT>(sh.u.raw, a, b, i0, int(blockIdx.y) * per * kStream, m, n, d, vec);
  for (int j0 = int(blockIdx.y) * per * kStream; j0 < j_end; j0 += kStream) {
    float acc[RPT][CPT];
    raw_tile<RPT, CPT>(a, b, i0, j0, m, n, d, vec, sh.u.raw, acc);
    const int count = min(kStream, n - j0);
    acc_prefetch<DPT>(sh.u.rows, b + size_t(j0) * d, count, d, vec);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const bool row_in = i0 + ty + kTY * r < m;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = j0 + tx + kTX * c;
        float v = 0.f;
        if (row_in && col < n) {
          const float p = expf(scale * acc[r][c] - lse_r[r]);
          v = (p - (col == lab[r] ? 1.f : 0.f)) * g_r[r];
        }
        ds[r] = fmaf(v, acc[r][c], ds[r]);
        sh.zt[tx + kTX * c][ty + kTY * r] = v;
      }
    }
    accumulate<DPT>(sh.zt, b + size_t(j0) * d, count, d, vec, sh.u.rows, out);
    if (j0 + kStream < j_end)
      raw_prefetch<RPT, CPT>(sh.u.raw, a, b, i0, j0 + kStream, m, n, d, vec);
  }

  const bool whole = gridDim.y == 1;
  store_owned<DPT>(out, da + size_t(blockIdx.y) * m * d, i0, m, d, whole ? scale : 1.f);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i0 + ty + kTY * r;
    const float total = row_sum(ds[r]);
    if (tx == 0 && row < m && blockIdx.z == 0) dscale[size_t(blockIdx.y) * m + row] = total;
  }
}

// dB: one block per tile of 32 rows of b (blockIdx.x), per slice of a's rows
// (blockIdx.y: the `per` whole tiles of 64 rows from tile s per, in order)
// and per feature slice (blockIdx.z). With one slice of a the block stores
// scale * dB; with more its unscaled partial into slice s of db [S][n][d]
// (scratch), for launch_db's second pass.
template <int DPT>
__global__ void __launch_bounds__(kThreads, DPT <= 8 ? 2 : 1)
ce_bwd_db_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const int* __restrict__ labels, const float* __restrict__ scale_ptr,
                 const float* __restrict__ lse, const float* __restrict__ g,
                 float* __restrict__ db, int m, int n, int d, int per, bool vec) {
  constexpr int RPT = kStream / kTY, CPT = kOwn / kTX;
  __shared__ __align__(16) BwdShared<RPT, CPT, DPT> sh;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int j0 = blockIdx.x * kOwn;
  const float scale = *scale_ptr;

  float out[kAccRows][DPT];
  zero_owned<DPT>(out);

  const int i_end = min(m, int(blockIdx.y + 1) * per * kStream);
  raw_prefetch<RPT, CPT>(sh.u.raw, a, b, int(blockIdx.y) * per * kStream, j0, m, n, d, vec);
  for (int i0 = int(blockIdx.y) * per * kStream; i0 < i_end; i0 += kStream) {
    float acc[RPT][CPT];
    raw_tile<RPT, CPT>(a, b, i0, j0, m, n, d, vec, sh.u.raw, acc);
    const int count = min(kStream, m - i0);
    acc_prefetch<DPT>(sh.u.rows, a + size_t(i0) * d, count, d, vec);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = i0 + ty + kTY * r;
      const bool row_in = row < m;
      const float lse_r = row_in ? lse[row] : 0.f;
      const float g_r = row_in ? g[row] : 0.f;
      const int lab = row_in ? labels[row] : -1;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = j0 + tx + kTX * c;
        float v = 0.f;
        if (row_in && col < n) {
          const float p = expf(scale * acc[r][c] - lse_r);
          v = (p - (col == lab ? 1.f : 0.f)) * g_r;
        }
        sh.zt[ty + kTY * r][tx + kTX * c] = v;
      }
    }
    accumulate<DPT>(sh.zt, a + size_t(i0) * d, count, d, vec, sh.u.rows, out);
    if (i0 + kStream < i_end)
      raw_prefetch<RPT, CPT>(sh.u.raw, a, b, i0 + kStream, j0, m, n, d, vec);
  }

  store_owned<DPT>(out, db + size_t(blockIdx.y) * n * d, j0, n, d, gridDim.y == 1 ? scale : 1.f);
}

// The backward kernels' arguments, as the C entry points receive them.
struct Args {
  const void* a;
  const void* b;
  const int* labels;
  const float* scale;
  const float* lse;
  const float* g;
  int m, n, d;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the forward, and one body for dA (DA) and dB
// ---------------------------------------------------------------------------

namespace ce_mma {

namespace mma = colxlip::mma;
using mma::bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStreamRows = 64;  // rows of the streamed matrix a tile
constexpr int kPad = 8;          // elements of padding a staged row

// Tile geometry at feature capacity DC (64, 128, 256, 512 or 768; D <= DC).
template <int DC>
struct Cfg {
  static constexpr int kOwn = DC <= 512 ? 64 : 32;       // rows a block owns
  static constexpr int kWR = kOwn / 16;                  // row groups of warps
  static constexpr int kWC = kWarps / kWR;               // column groups: 2 or 4
  static constexpr int kRS = DC + kPad;                  // row stride of the tiles
  static constexpr int kDzRS = kStreamRows + kPad;       // row stride of dz
  static constexpr int kRawNT = kStreamRows / kWC / 8;   // n-tiles of raw a warp
  static constexpr int kOutCols = DC / kWC;              // output features a warp
  static constexpr int kOutNT = kOutCols / 8;
  static constexpr size_t kOwnBytes = size_t(kOwn) * kRS * 2;
  static constexpr size_t kStreamBytes = size_t(kStreamRows) * kRS * 2;
  static constexpr size_t kStatBytes = 3 * kStreamRows * 4;  // lse, g, label (dB)
  static constexpr size_t kDzBytes = 2 * size_t(kOwn) * kDzRS * 2;
  static constexpr size_t kPartBytes = size_t(kWC) * kOwn * 4;
  static constexpr size_t bytes(int stages) {
    return kOwnBytes + stages * (kStreamBytes + kStatBytes) + kDzBytes + kPartBytes;
  }
  static constexpr int kStages = bytes(2) <= colxlip::kMaxSharedBytes ? 2 : 1;
  static constexpr size_t kBytes = bytes(kStages);
};

// The forward's shared memory: the same own and stream tiles, no dz, and the
// (max, sum, label logit) of each own row from each column group.
template <int DC>
struct FwdCfg : Cfg<DC> {
  using B = Cfg<DC>;
  static constexpr size_t kPartBytes = 3 * size_t(B::kWC) * B::kOwn * 4;
  static constexpr size_t bytes(int stages) {
    return B::kOwnBytes + stages * B::kStreamBytes + kPartBytes;
  }
  static constexpr int kStages = bytes(2) <= colxlip::kMaxSharedBytes ? 2 : 1;
  static constexpr size_t kBytes = bytes(kStages);
};

constexpr int kChunk = 256;               // features a chunk of the chunked walk
constexpr int kChunkRS = kChunk + kPad;   // row stride of a staged chunk

// The chunked walk's shared memory (D > kMaxBf16D, Cfg<kMaxBf16D>'s
// geometry): two stages of (own rows, stream rows) of one chunk each; the
// backward adds the stream tile's output slice (a Cfg<768> stream tile), its
// lse / g / label rows, the dz halves and dscale's partials, the forward its
// (max, sum, label logit) partials.
struct ChunkCfg {
  using C = Cfg<kMaxBf16D>;
  static constexpr size_t kOwnChunk = size_t(C::kOwn) * kChunkRS * 2;
  static constexpr size_t kStage = kOwnChunk + size_t(kStreamRows) * kChunkRS * 2;
  static constexpr size_t kSliceAt = 2 * kStage;
  static constexpr size_t kStatAt = kSliceAt + C::kStreamBytes;
  static constexpr size_t kDzAt = kStatAt + C::kStatBytes;
  static constexpr size_t kBytes = kDzAt + C::kDzBytes + C::kPartBytes;
  static constexpr size_t kFwdBytes = kSliceAt + FwdCfg<kMaxBf16D>::kPartBytes;
};
static_assert(ChunkCfg::kBytes <= colxlip::kMaxSharedBytes, "chunked tiles overflow");

// Rows row0 .. row0 + ROWS - 1 of a [n, d] bf16 matrix (d a multiple of 8,
// 16-byte aligned rows) into a tile of row stride DC + kPad; rows past n and
// features past d are zeros. The caller commits.
template <int DC, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int n, int d) {
  constexpr int P = DC / 8;  // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < ROWS * P; idx += kThreads) {
    const int r = idx / P, c = (idx - r * P) * 8;
    const bool live = row0 + r < n && c < d;
    mma::cp_async_16(dst + r * (DC + kPad) + c, live ? src + size_t(row0 + r) * d + c : src,
                     live);
  }
}

// Rows row0 .. row0 + ROWS - 1, features f0 .. f0 + 8 pieces - 1 of a [n, d]
// bf16 matrix into a tile of row stride RS; rows past n and features past d
// are zeros. The caller commits.
template <int RS, int ROWS>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int n, int d, int f0, int pieces) {
  for (int idx = threadIdx.x; idx < ROWS * pieces; idx += kThreads) {
    const int r = idx / pieces, c = (idx - r * pieces) * 8;
    const bool live = row0 + r < n && f0 + c < d;
    mma::cp_async_16(dst + r * RS + c, live ? src + size_t(row0 + r) * d + f0 + c : src, live);
  }
}

// Step 1 of all three bf16 kernels: raw[nt] = the warp's 16 own rows times NT
// n-tiles of 8 stream rows, X_own . X_stream^T, in C-fragment layout. `pa` is
// the lane's ldmatrix address in the own tile (row 16 wr + lane % 16, feature
// 8 (lane / 16)), `cols` the stream tile at the warp's first column. Each
// k-step of 16 features is taken from a zero accumulator and added in fp32
// rounding to nearest, in k order. An m16n8k16 result for (i, j) depends only
// on the 16 values of a_i and of b_j in its k-step, so every kernel that
// calls this with the same padded d gets the same bits of raw_ij, whatever
// its warp layout: the forward's lse and the backward's p agree.
template <int NT>
__device__ __forceinline__ void zero_tile(float (&raw)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) raw[nt][i] = 0.f;
}

// logit_tile's k-steps added to raw as it stands (the chunked walk's chunks).
template <int NT, int RS>
__device__ __forceinline__ void logit_tile_add(float (&raw)[NT][4], const bf16* pa,
                                               const bf16* cols, int ksteps, int lane) {
  const bf16* pb = cols + ((lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 8;
#pragma unroll 4
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t af[4];
    mma::ldmatrix_x4(af, pa + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bfr[4];
      mma::ldmatrix_x4(bfr, pb + np * 16 * RS + kk * 16);
      mma::mma_16816_rn(raw[2 * np], af, bfr[0], bfr[1]);
      mma::mma_16816_rn(raw[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

template <int NT, int RS>
__device__ __forceinline__ void logit_tile(float (&raw)[NT][4], const bf16* pa, const bf16* cols,
                                           int ksteps, int lane) {
  zero_tile<NT>(raw);
  logit_tile_add<NT, RS>(raw, pa, cols, ksteps, lane);
}

// Step 1 of the chunked walk: raw of stream tile `tile` over `chunks` chunks
// of kChunk features. Step s = tile * chunks + c sits in stage s & 1 of
// ChunkCfg; stage(s) stages step s and commits, and step s + 1 flies while
// step s multiplies. `pa_off` is the lane's ldmatrix offset in an own chunk,
// `col_off` the warp's first column in a stream chunk.
template <int NT, typename Stage>
__device__ __forceinline__ void chunked_logit_tile(float (&raw)[NT][4], unsigned char* smem,
                                                   int tile, int chunks, int steps, int ksteps,
                                                   int pa_off, int col_off, int lane,
                                                   Stage&& stage) {
  zero_tile<NT>(raw);
  for (int c = 0; c < chunks; ++c) {
    const int s = tile * chunks + c;
    // step s has arrived, and every warp is done with the stage step s + 1 takes
    mma::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < steps) stage(s + 1);
    const bf16* own = reinterpret_cast<const bf16*>(smem + (s & 1) * ChunkCfg::kStage);
    const bf16* cols = reinterpret_cast<const bf16*>(smem + (s & 1) * ChunkCfg::kStage +
                                                     ChunkCfg::kOwnChunk);
    logit_tile_add<NT, kChunkRS>(raw, own + pa_off, cols + col_off,
                                 min(kChunk / 16, ksteps - c * (kChunk / 16)), lane);
  }
}

// The forward (#11): own = a [M] (labels per own row), stream = b [N]; out
// loss and lse [M]. Per tile, raw by logit_tile, then in registers z = scale
// raw (-1e30 past N) and the thread's running (max, sum) for its two rows over
// the columns it holds: tile max, the sum rescaled, then expf(z - max) added
// in column order; the thread whose column is the row's label keeps z. At
// the end the pairs merge in a fixed order: the quad's four lanes by
// shuffles, then the kWC column groups in order through shared memory.
// CHUNKED (DC = kMaxBf16D, D past it): raw by chunked_logit_tile.
template <int DC, bool CHUNKED = false>
__global__ void __launch_bounds__(kThreads, 2)
ce_fwd_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                  const int* __restrict__ labels, const float* __restrict__ scale_ptr,
                  float* __restrict__ loss, float* __restrict__ lse, int m, int n, int d) {
  using C = FwdCfg<DC>;
  constexpr int RS = C::kRS;
  constexpr int TILE = kStreamRows * RS;
  constexpr size_t kPartAt =
      CHUNKED ? ChunkCfg::kSliceAt : C::kOwnBytes + C::kStages * C::kStreamBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* own_s = reinterpret_cast<bf16*>(smem);
  bf16* stream_s = reinterpret_cast<bf16*>(smem + C::kOwnBytes);
  float* part = reinterpret_cast<float*>(smem + kPartAt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / C::kWC, wc = warp % C::kWC;
  const int own0 = blockIdx.x * C::kOwn;
  const int tiles = (n + kStreamRows - 1) / kStreamRows;
  const float scale = *scale_ptr;
  const int chunks = (d + kChunk - 1) / kChunk;
  // the chunked walk's step s: chunk s % chunks of the own rows and of
  // stream tile s / chunks into stage s & 1
  auto stage_step = [&](int s) {
    unsigned char* at = smem + (s & 1) * ChunkCfg::kStage;
    const int f0 = (s % chunks) * kChunk;
    stage_cols<kChunkRS, C::kOwn>(reinterpret_cast<bf16*>(at), a, own0, m, d, f0, kChunk / 8);
    stage_cols<kChunkRS, kStreamRows>(reinterpret_cast<bf16*>(at + ChunkCfg::kOwnChunk), b,
                                      (s / chunks) * kStreamRows, n, d, f0, kChunk / 8);
    mma::cp_async_commit();
  };

  if constexpr (CHUNKED) {
    stage_step(0);
  } else {
    stage_rows<DC, C::kOwn>(own_s, a, own0, m, d);
    stage_rows<DC, kStreamRows>(stream_s, b, 0, n, d);
    mma::cp_async_commit();
  }

  // this thread's two rows (fragment rows g and g + 8 of the warp's 16)
  const int lr0 = wr * 16 + g;
  const int r0 = own0 + lr0, r1 = r0 + 8;
  const int lab[2] = {label_of(labels, r0, m, n), label_of(labels, r1, m, n)};
  float mx[2] = {kNeg, kNeg}, sum[2] = {0.f, 0.f}, zl[2] = {0.f, 0.f};

  const int ksteps = (d + 15) >> 4;
  const int raw_col0 = wc * (kStreamRows / C::kWC);
  const bf16* pa = own_s + (wr * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
  const int pa_chunk = (wr * 16 + (lane & 15)) * kChunkRS + (lane >> 4) * 8;

  for (int tile = 0; tile < tiles; ++tile) {
    float raw[C::kRawNT][4];
    if constexpr (CHUNKED) {
      chunked_logit_tile<C::kRawNT>(raw, smem, tile, chunks, tiles * chunks, ksteps, pa_chunk,
                                    raw_col0 * kChunkRS, lane, stage_step);
    } else {
      const int buf = C::kStages == 2 ? (tile & 1) : 0;
      mma::cp_async_wait<0>();
      __syncthreads();
      if (C::kStages == 2 && tile + 1 < tiles) {
        stage_rows<DC, kStreamRows>(stream_s + (buf ^ 1) * TILE, b, (tile + 1) * kStreamRows, n,
                                    d);
        mma::cp_async_commit();
      }
      logit_tile<C::kRawNT, RS>(raw, pa, stream_s + buf * TILE + raw_col0 * RS, ksteps, lane);
    }

    const int c0 = tile * kStreamRows + raw_col0 + 2 * t;   // the thread's first column
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = kNeg;
#pragma unroll
      for (int nt = 0; nt < C::kRawNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + nt * 8 + e;
          const float z = col < n ? scale * raw[nt][2 * h + e] : kNeg;
          raw[nt][2 * h + e] = z;
          tmax = fmaxf(tmax, z);
          if (col == lab[h]) zl[h] += z;
        }
      const float mnew = fmaxf(mx[h], tmax);
      float p = 0.f;
#pragma unroll
      for (int nt = 0; nt < C::kRawNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) p += expf(raw[nt][2 * h + e] - mnew);   // masked: 0
      sum[h] = sum[h] * expf(mx[h] - mnew) + p;
      mx[h] = mnew;
    }
    if (!CHUNKED && C::kStages == 1 && tile + 1 < tiles) {
      __syncthreads();   // every warp is done with the one stage
      stage_rows<DC, kStreamRows>(stream_s, b, (tile + 1) * kStreamRows, n, d);
      mma::cp_async_commit();
    }
  }

  // a row's pairs: its quad (lanes t ^ 1, then t ^ 2), then its column groups
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx[h], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, sum[h], off);
      zl[h] += __shfl_xor_sync(0xffffffffu, zl[h], off);
      merge_lse(mx[h], sum[h], m2, s2);
    }
  float* part_m = part;
  float* part_s = part + C::kWC * C::kOwn;
  float* part_z = part + 2 * C::kWC * C::kOwn;
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = wc * C::kOwn + lr0 + 8 * h;
      part_m[at] = mx[h];
      part_s[at] = sum[h];
      part_z[at] = zl[h];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < C::kOwn; r += kThreads) {
    if (own0 + r >= m) continue;
    float mm = part_m[r], ss = part_s[r], zz = part_z[r];
#pragma unroll
    for (int w = 1; w < C::kWC; ++w) {
      merge_lse(mm, ss, part_m[w * C::kOwn + r], part_s[w * C::kOwn + r]);
      zz += part_z[w * C::kOwn + r];
    }
    const float l = mm + logf(ss);
    lse[own0 + r] = l;
    loss[own0 + r] = l - zz;
  }
}

// DA: own = a [M], stream = b [N]; out = dA [M, d], dscale [M].
// !DA: own = b [N], stream = a [M]; out = dB [N, d]. lse, g and labels are
// indexed by rows of a either way. The block writes output features d0 ..
// d0 + width - 1, d0 = blockIdx.y slice (the whole row where slice = d).
// CHUNKED (DC = kMaxBf16D, D past it): raw by chunked_logit_tile, and step 3
// on the stream tile's slice, staged once a tile.
template <int DC, bool DA, bool CHUNKED = false>
__global__ void __launch_bounds__(kThreads, 1)
ce_bwd_mma_kernel(const bf16* __restrict__ own_g, const bf16* __restrict__ stream_g,
                  const int* __restrict__ labels, const float* __restrict__ scale_ptr,
                  const float* __restrict__ lse, const float* __restrict__ g_rows,
                  float* __restrict__ out, float* __restrict__ dscale, int own_n,
                  int stream_n, int d, int slice) {
  using C = Cfg<DC>;
  constexpr int RS = C::kRS;
  constexpr int TILE = kStreamRows * RS;
  constexpr size_t kStatAt =
      CHUNKED ? ChunkCfg::kStatAt : C::kOwnBytes + C::kStages * C::kStreamBytes;
  constexpr size_t kDzAt =
      CHUNKED ? ChunkCfg::kDzAt : C::kOwnBytes + C::kStages * (C::kStreamBytes + C::kStatBytes);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* own_s = reinterpret_cast<bf16*>(smem);
  bf16* stream_s = reinterpret_cast<bf16*>(smem + (CHUNKED ? ChunkCfg::kSliceAt : C::kOwnBytes));
  float* stat_s = reinterpret_cast<float*>(smem + kStatAt);
  bf16* dzh = reinterpret_cast<bf16*>(smem + kDzAt);
  bf16* dzl = dzh + C::kOwn * C::kDzRS;
  float* part = reinterpret_cast<float*>(dzl + C::kOwn * C::kDzRS);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / C::kWC, wc = warp % C::kWC;
  const int own0 = blockIdx.x * C::kOwn;
  const int tiles = (stream_n + kStreamRows - 1) / kStreamRows;
  const float scale = *scale_ptr;
  const int d0 = blockIdx.y * slice;
  const int width = min(slice, d - d0);
  const int chunks = (d + kChunk - 1) / kChunk;

  // stream tile `tile` into stage `buf` (the chunked walk: its output slice
  // into the one slice tile), with (dB) the lse, g and label of its rows;
  // dead rows get zeros, which the masks below never use
  auto stage_stream = [&](int tile, int buf) {
    const int s0 = tile * kStreamRows;
    if constexpr (CHUNKED)
      stage_cols<RS, kStreamRows>(stream_s, stream_g, s0, stream_n, d, d0, (width + 15) / 16 * 2);
    else
      stage_rows<DC, kStreamRows>(stream_s + buf * TILE, stream_g, s0, stream_n, d);
    if constexpr (!DA) {
      for (int idx = threadIdx.x; idx < 3 * kStreamRows; idx += kThreads) {
        const int which = idx / kStreamRows, c = idx - which * kStreamRows;
        const bool live = s0 + c < stream_n;
        const float* src = which == 0 ? lse : which == 1 ? g_rows
                                                         : reinterpret_cast<const float*>(labels);
        mma::cp_async_4(stat_s + buf * 3 * kStreamRows + idx, src + (live ? s0 + c : 0), live);
      }
    }
  };
  // the chunked walk's step s: chunk s % chunks of the own rows and of
  // stream tile s / chunks into stage s & 1
  auto stage_step = [&](int s) {
    unsigned char* at = smem + (s & 1) * ChunkCfg::kStage;
    const int f0 = (s % chunks) * kChunk;
    stage_cols<kChunkRS, C::kOwn>(reinterpret_cast<bf16*>(at), own_g, own0, own_n, d, f0,
                                  kChunk / 8);
    stage_cols<kChunkRS, kStreamRows>(reinterpret_cast<bf16*>(at + ChunkCfg::kOwnChunk),
                                      stream_g, (s / chunks) * kStreamRows, stream_n, d, f0,
                                      kChunk / 8);
    mma::cp_async_commit();
  };

  if constexpr (CHUNKED) {
    stage_step(0);
  } else {
    stage_rows<DC, C::kOwn>(own_s, own_g, own0, own_n, d);
  }
  stage_stream(0, 0);
  mma::cp_async_commit();

  // this thread's two own rows (fragment rows g and g + 8 of the warp's 16)
  const int lr0 = wr * 16 + g;
  const int r0 = own0 + lr0, r1 = r0 + 8;
  float lse_r[2] = {0.f, 0.f}, g_r[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
  int lab_r[2] = {-1, -1};
  if constexpr (DA) {
    if (r0 < own_n) lse_r[0] = lse[r0], g_r[0] = g_rows[r0], lab_r[0] = labels[r0];
    if (r1 < own_n) lse_r[1] = lse[r1], g_r[1] = g_rows[r1], lab_r[1] = labels[r1];
  }

  float acc[C::kOutNT][4];
#pragma unroll
  for (int nt = 0; nt < C::kOutNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  const int ksteps = (d + 15) >> 4;
  const int raw_col0 = wc * (kStreamRows / C::kWC);   // the warp's first tile column
  const int out_col0 = wc * C::kOutCols;              // the warp's first output feature
  const bf16* pa = own_s + (wr * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
  const int pa_chunk = (wr * 16 + (lane & 15)) * kChunkRS + (lane >> 4) * 8;

  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = !CHUNKED && C::kStages == 2 ? (tile & 1) : 0;
    const int s0 = tile * kStreamRows;
    const bf16* st = stream_s + buf * TILE;

    // 1. raw = X_own . X_stream^T, the forward's logit tile
    float raw[C::kRawNT][4];
    if constexpr (CHUNKED) {
      // the tile's chunks; their waits also land the slice and stat rows
      // staged after the tile before
      chunked_logit_tile<C::kRawNT>(raw, smem, tile, chunks, tiles * chunks, ksteps, pa_chunk,
                                    raw_col0 * kChunkRS, lane, stage_step);
    } else {
      // tile `tile` has arrived, and every warp is done with the stage and
      // the dz halves of the tile before
      mma::cp_async_wait<0>();
      __syncthreads();
      if (C::kStages == 2 && tile + 1 < tiles) {
        stage_stream(tile + 1, buf ^ 1);
        mma::cp_async_commit();
      }
      logit_tile<C::kRawNT, RS>(raw, pa, st + raw_col0 * RS, ksteps, lane);
    }

    // 2. dz in registers, masked; dscale (dA); the two bf16 halves to shared
    const float* sst = stat_s + buf * 3 * kStreamRows;
#pragma unroll
    for (int nt = 0; nt < C::kRawNT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int own_row = h ? r1 : r0;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lc = raw_col0 + nt * 8 + 2 * t + e;
          const int col = s0 + lc;
          const float x = raw[nt][2 * h + e];
          float dz = 0.f;
          if (own_row < own_n && col < stream_n) {
            if constexpr (DA) {
              const float p = expf(scale * x - lse_r[h]);
              dz = (p - (col == lab_r[h] ? 1.f : 0.f)) * g_r[h];
            } else {
              const float p = expf(scale * x - sst[lc]);
              const int lab = __float_as_int(sst[2 * kStreamRows + lc]);
              dz = (p - (own_row == lab ? 1.f : 0.f)) * sst[kStreamRows + lc];
            }
          }
          if constexpr (DA) ds[h] = fmaf(dz, x, ds[h]);
          v[e] = dz;
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(v[0] - __low2float(hi), v[1] - __high2float(hi));
        const int off = (lr0 + 8 * h) * C::kDzRS + raw_col0 + nt * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dzh + off) = hi;
        *reinterpret_cast<__nv_bfloat162*>(dzl + off) = lo;
      }
    }
    __syncthreads();

    // 3. out += dz_hi . X_stream + dz_lo . X_stream over the tile's 64 rows
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma::ldm_a(ah[kk], dzh + wr * 16 * C::kDzRS + kk * 16, C::kDzRS, lane);
      mma::ldm_a(al[kk], dzl + wr * 16 * C::kDzRS + kk * 16, C::kDzRS, lane);
    }
    const bf16* qb = st + (lane & 15) * RS + (lane >> 4) * 8 + out_col0;
#pragma unroll
    for (int np = 0; np < C::kOutNT / 2; ++np) {
      if (out_col0 + np * 16 >= width) continue;   // the same in every lane
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bfr[4];
        mma::ldmatrix_x4_trans(bfr, qb + kk * 16 * RS + np * 16);
        mma::mma_16816(d0, ah[kk], bfr[0], bfr[1]);
        mma::mma_16816(d0, al[kk], bfr[0], bfr[1]);
        mma::mma_16816(d1, ah[kk], bfr[2], bfr[3]);
        mma::mma_16816(d1, al[kk], bfr[2], bfr[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[2 * np][i] += d0[i];
        acc[2 * np + 1][i] += d1[i];
      }
    }
    if ((CHUNKED || C::kStages == 1) && tile + 1 < tiles) {
      __syncthreads();   // every warp is done with the one stage (the slice tile)
      stage_stream(tile + 1, 0);
      mma::cp_async_commit();
    }
  }

  // scale * out, rows g and g + 8, features d0 + out_col0 + 8 nt + 2t (+1)
#pragma unroll
  for (int nt = 0; nt < C::kOutNT; ++nt) {
    const int col = out_col0 + nt * 8 + 2 * t;
    if (col >= width) continue;
    if (r0 < own_n)
      *reinterpret_cast<float2*>(out + size_t(r0) * d + d0 + col) =
          make_float2(scale * acc[nt][0], scale * acc[nt][1]);
    if (r1 < own_n)
      *reinterpret_cast<float2*>(out + size_t(r1) * d + d0 + col) =
          make_float2(scale * acc[nt][2], scale * acc[nt][3]);
  }
  if constexpr (DA) {
    // a row's dscale: its quad, then its kWC column groups in order
    const float s0 = mma::quad_sum(ds[0]), s1 = mma::quad_sum(ds[1]);
    if (t == 0) {
      part[wc * C::kOwn + lr0] = s0;
      part[wc * C::kOwn + lr0 + 8] = s1;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < C::kOwn; r += kThreads) {
      if (own0 + r >= own_n || blockIdx.y != 0) continue;   // one slice writes dscale
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < C::kWC; ++w) total += part[w * C::kOwn + r];
      dscale[own0 + r] = total;
    }
  }
}

template <int DC, bool DA>
cudaError_t launch(const Args& x, float* out, float* dscale) {
  using C = Cfg<DC>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(ce_bwd_mma_kernel<DC, DA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(C::kBytes));
  if (attr != cudaSuccess) return attr;
  const int own_n = DA ? x.m : x.n, stream_n = DA ? x.n : x.m;
  const bf16* own = static_cast<const bf16*>(DA ? x.a : x.b);
  const bf16* streamed = static_cast<const bf16*>(DA ? x.b : x.a);
  ce_bwd_mma_kernel<DC, DA><<<(own_n + C::kOwn - 1) / C::kOwn, kThreads, C::kBytes, x.stream>>>(
      own, streamed, x.labels, x.scale, x.lse, x.g, out, dscale, own_n, stream_n, x.d, x.d);
  return cudaGetLastError();
}

// D > kMaxBf16D: the chunked walk, the output in near-equal feature slices
// of at most kMaxBf16D (a multiple of 16) along the grid's y axis.
template <bool DA>
cudaError_t launch_chunked(const Args& x, float* out, float* dscale) {
  using C = Cfg<kMaxBf16D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ce_bwd_mma_kernel<kMaxBf16D, DA, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ChunkCfg::kBytes));
  if (attr != cudaSuccess) return attr;
  const int own_n = DA ? x.m : x.n, stream_n = DA ? x.n : x.m;
  const int slices = (x.d + kMaxBf16D - 1) / kMaxBf16D;
  const int slice = ((x.d + slices - 1) / slices + 15) / 16 * 16;
  const dim3 grid((own_n + C::kOwn - 1) / C::kOwn, slices);
  ce_bwd_mma_kernel<kMaxBf16D, DA, true><<<grid, kThreads, ChunkCfg::kBytes, x.stream>>>(
      static_cast<const bf16*>(DA ? x.a : x.b), static_cast<const bf16*>(DA ? x.b : x.a),
      x.labels, x.scale, x.lse, x.g, out, dscale, own_n, stream_n, x.d, slice);
  return cudaGetLastError();
}

// bf16 rows must be a multiple of 8 features on 16-byte aligned bases (the
// wrapper pads and copies where they are not).
bool misaligned(const Args& x) {
  return x.d % 8 != 0 || (reinterpret_cast<uintptr_t>(x.a) & 15) != 0 ||
         (reinterpret_cast<uintptr_t>(x.b) & 15) != 0;
}

template <bool DA>
cudaError_t dispatch(const Args& x, float* out, float* dscale) {
  if (misaligned(x)) return cudaErrorInvalidValue;
  if (x.d <= 64) return launch<64, DA>(x, out, dscale);
  if (x.d <= 128) return launch<128, DA>(x, out, dscale);
  if (x.d <= 256) return launch<256, DA>(x, out, dscale);
  if (x.d <= 512) return launch<512, DA>(x, out, dscale);
  if (x.d <= kMaxBf16D) return launch<768, DA>(x, out, dscale);
  return launch_chunked<DA>(x, out, dscale);
}

template <int DC, bool CHUNKED = false>
cudaError_t launch_fwd(const Args& x, float* loss, float* lse) {
  using C = FwdCfg<DC>;
  constexpr size_t bytes = CHUNKED ? ChunkCfg::kFwdBytes : C::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ce_fwd_mma_kernel<DC, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  ce_fwd_mma_kernel<DC, CHUNKED><<<(x.m + C::kOwn - 1) / C::kOwn, kThreads, bytes, x.stream>>>(
      static_cast<const bf16*>(x.a), static_cast<const bf16*>(x.b), x.labels, x.scale, loss, lse,
      x.m, x.n, x.d);
  return cudaGetLastError();
}

cudaError_t dispatch_fwd(const Args& x, float* loss, float* lse) {
  if (misaligned(x)) return cudaErrorInvalidValue;
  if (x.d <= 64) return launch_fwd<64>(x, loss, lse);
  if (x.d <= 128) return launch_fwd<128>(x, loss, lse);
  if (x.d <= 256) return launch_fwd<256>(x, loss, lse);
  if (x.d <= 512) return launch_fwd<512>(x, loss, lse);
  if (x.d <= kMaxBf16D) return launch_fwd<768>(x, loss, lse);
  return launch_fwd<kMaxBf16D, true>(x, loss, lse);
}

}  // namespace ce_mma

// ---------------------------------------------------------------------------
// float32 launchers
// ---------------------------------------------------------------------------

// float32 rows take 16-byte copies where they are a multiple of 4 features on
// 16-byte aligned bases, 4-byte copies otherwise.
bool vec_rows(const Args& x) {
  return x.d % 4 == 0 && (reinterpret_cast<uintptr_t>(x.a) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(x.b) & 15) == 0;
}

// Feature slices of dA and dB: one up to kSliceD features, then as few as
// keep each within it.
int feature_slices(int d) { return (d + kSliceD - 1) / kSliceD; }

// `slices` slices of b's 64-row tiles (the wrapper's fp32_fwd_slices), cut
// so that none is empty. Past one, the blocks' (max, sum, label logit) go to
// scratch [3][S][m] and ce_fwd_merge_kernel merges them in slice order.
cudaError_t launch_fwd32(const Args& x, float* loss, float* lse, float* scratch, int slices) {
  const int tiles = (x.n + kStream - 1) / kStream;
  const int per = (tiles + slices - 1) / slices;
  slices = (tiles + per - 1) / per;
  ce_fwd_kernel<<<dim3((x.m + kFwdRows - 1) / kFwdRows, slices), kThreads, 0, x.stream>>>(
      static_cast<const float*>(x.a), static_cast<const float*>(x.b), x.labels, x.scale, loss,
      lse, scratch, x.m, x.n, x.d, per, vec_rows(x));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  ce_fwd_merge_kernel<<<(x.m + 255) / 256, 256, 0, x.stream>>>(scratch, loss, lse, x.m, slices);
  return cudaGetLastError();
}

// `slices` slices of b's 64-row tiles (the wrapper's fp32_da_slices), cut
// so that none is empty. Past one, the blocks' partials go to scratch (dA
// [S][m][d], then dscale [S][m]) and reduce_partials adds them in slice
// order, dA times scale once after the whole sum.
template <int DPT>
cudaError_t launch_da(const Args& x, float* da, float* dscale, float* scratch, int slices) {
  const int tiles = (x.n + kStream - 1) / kStream;
  const int per = (tiles + slices - 1) / slices;
  slices = (tiles + per - 1) / per;
  float* part_da = slices > 1 ? scratch : da;
  float* part_ds = slices > 1 ? scratch + size_t(slices) * x.m * x.d : dscale;
  const dim3 grid((x.m + kOwn - 1) / kOwn, slices, feature_slices(x.d));
  ce_bwd_da_kernel<DPT><<<grid, kThreads, 0, x.stream>>>(
      static_cast<const float*>(x.a), static_cast<const float*>(x.b), x.labels, x.scale, x.lse,
      x.g, part_da, part_ds, x.m, x.n, x.d, per, vec_rows(x));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const cudaError_t err_da =
      reduce_partials(part_da, da, slices, x.m * x.d, x.stream, Finish{x.scale, nullptr, 1});
  if (err_da != cudaSuccess) return err_da;
  return reduce_partials(part_ds, dscale, slices, x.m, x.stream);
}

// `slices` slices of a's 64-row tiles (the wrapper's fp32_db_slices), cut so
// that none is empty. Past one, the blocks' partials go to scratch (dB
// [S][n][d]) and reduce_partials adds them in slice order, times scale once
// after the whole sum.
template <int DPT>
cudaError_t launch_db(const Args& x, float* db, float* scratch, int slices) {
  const int tiles = (x.m + kStream - 1) / kStream;
  const int per = (tiles + slices - 1) / slices;
  slices = (tiles + per - 1) / per;
  float* part_db = slices > 1 ? scratch : db;
  const dim3 grid((x.n + kOwn - 1) / kOwn, slices, feature_slices(x.d));
  ce_bwd_db_kernel<DPT><<<grid, kThreads, 0, x.stream>>>(
      static_cast<const float*>(x.a), static_cast<const float*>(x.b), x.labels, x.scale, x.lse,
      x.g, part_db, x.m, x.n, x.d, per, vec_rows(x));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  return reduce_partials(part_db, db, slices, x.n * x.d, x.stream, Finish{x.scale, nullptr, 1});
}

// float32: the features a thread holds of each of its 8 output rows are a
// template argument (the accumulators live in registers): 64 DPT covers the
// widest feature slice, slice_width(d, feature_slices(d)) <= 768.
int features_per_thread(int d) {
  const int w = slice_width(d, feature_slices(d));
  return w <= 256 ? 4 : w <= 512 ? 8 : 12;
}

cudaError_t dispatch_da(const Args& x, float* da, float* dscale, float* scratch, int slices) {
  switch (features_per_thread(x.d)) {
    case 4: return launch_da<4>(x, da, dscale, scratch, slices);
    case 8: return launch_da<8>(x, da, dscale, scratch, slices);
    default: return launch_da<12>(x, da, dscale, scratch, slices);
  }
}

cudaError_t dispatch_db(const Args& x, float* db, float* scratch, int slices) {
  switch (features_per_thread(x.d)) {
    case 4: return launch_db<4>(x, db, scratch, slices);
    case 8: return launch_db<8>(x, db, scratch, slices);
    default: return launch_db<12>(x, db, scratch, slices);
  }
}

// Any D in either dtype. Every split needs its scratch, and bf16 takes no
// split of the streamed rows.
bool bad_shape(int m, int n, int d, int dtype, int slices, const void* scratch) {
  return m < 1 || n < 1 || d < 1 || (dtype != 0 && dtype != 1) ||
         (dtype == 1 && slices != 1) || slices < 1 ||
         (slices > 1 && scratch == nullptr);
}

}  // namespace

// a [M, D], b [N, D] (dtype 0 = float32, 1 = bfloat16), labels [M] int32,
// scale: one float32 on the device; out loss [M], lse [M] float32. Returns a
// cudaError_t (0 = launched). bfloat16 takes the tensor-core kernel, whose rows
// must be a multiple of 8 features on 16-byte aligned bases
// (cudaErrorInvalidValue otherwise), slices 1; float32 the CUDA
// cores in `slices` slices of b's rows, with scratch 3 * slices * M float32
// where slices > 1.
extern "C" int colxlip_fused_ce_fwd(const void* a, const void* b, const void* labels,
                                    const void* scale, void* loss, void* lse, void* scratch, int m,
                                    int n, int d, int slices, int dtype, void* stream) {
  if (bad_shape(m, n, d, dtype, slices, scratch)) return cudaErrorInvalidValue;
  const Args x{a, b, static_cast<const int*>(labels), static_cast<const float*>(scale),
               nullptr, nullptr, m, n, d, static_cast<cudaStream_t>(stream)};
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == 1) return ce_mma::dispatch_fwd(x, lo, ls);
  return launch_fwd32(x, lo, ls, static_cast<float*>(scratch), slices);
}

// As the forward, plus lse [M] and g [M] float32 (the cotangent of the loss
// rows); out da [M, D] and dscale [M] float32. bfloat16 takes the
// tensor-core kernel, whose rows must be a multiple of 8 features on 16-byte
// aligned bases (cudaErrorInvalidValue otherwise), slices 1;
// float32 the CUDA cores in `slices` slices of b's rows, with scratch
// slices * M * (D + 1) float32 where slices > 1.
extern "C" int colxlip_fused_ce_bwd_da(const void* a, const void* b, const void* labels,
                                       const void* scale, const void* lse, const void* g,
                                       void* da, void* dscale, void* scratch, int m, int n, int d,
                                       int slices, int dtype, void* stream) {
  if (bad_shape(m, n, d, dtype, slices, scratch)) return cudaErrorInvalidValue;
  const Args x{a, b, static_cast<const int*>(labels), static_cast<const float*>(scale),
               static_cast<const float*>(lse), static_cast<const float*>(g), m, n, d,
               static_cast<cudaStream_t>(stream)};
  float* out = static_cast<float*>(da);
  float* ds = static_cast<float*>(dscale);
  return dtype == 0 ? dispatch_da(x, out, ds, static_cast<float*>(scratch), slices)
                    : ce_mma::dispatch<true>(x, out, ds);
}

// As colxlip_fused_ce_bwd_da; out db [N, D] float32, float32 in `slices`
// slices of a's rows with scratch slices * N * D float32 where slices > 1.
extern "C" int colxlip_fused_ce_bwd_db(const void* a, const void* b, const void* labels,
                                       const void* scale, const void* lse, const void* g,
                                       void* db, void* scratch, int m, int n, int d, int slices,
                                       int dtype, void* stream) {
  if (bad_shape(m, n, d, dtype, slices, scratch)) return cudaErrorInvalidValue;
  const Args x{a, b, static_cast<const int*>(labels), static_cast<const float*>(scale),
               static_cast<const float*>(lse), static_cast<const float*>(g), m, n, d,
               static_cast<cudaStream_t>(stream)};
  float* out = static_cast<float*>(db);
  return dtype == 0 ? dispatch_db(x, out, static_cast<float*>(scratch), slices)
                    : ce_mma::dispatch<false>(x, out, nullptr);
}
