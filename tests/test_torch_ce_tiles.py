"""The tile algorithm of the bf16 streaming-CE kernels, emulated on the CPU.

In bfloat16 ``csrc/fused_ce.cu`` runs all three kernels on one tensor-core
logit tile. A block owns rows of one matrix (a for the forward and dA, b for
dB; 64 rows at D <= 512, 32 above) and walks the other in tiles of 64 rows.
Per tile every kernel takes raw = X_own . X_stream^T through one function,
``logit_tile``: one k-step of 16 features at a time from zero, added in
fp32. The forward then keeps, for each of a thread's two rows, a running
(max, sum) over the columns the thread holds (z = scale raw, -1e30 past N;
tile max, the sum rescaled, exp(z - max) added in column order) and the
label logit, and merges the pairs in a fixed order at the end: the quad's
four lanes (t ^ 1, then t ^ 2), then the column groups in order. The
backward's epilogue makes dz = (exp(scale raw - lse) - onehot) g with rows
past either end masked to 0, adds dz * raw into dscale (dA), and splits dz
into dz_hi = bf16(dz) and dz_lo = bf16(dz - dz_hi); then
out += dz_hi . X_stream + dz_lo . X_stream, the tile's sum from zero added
to the fp32 output, and the output is scaled at the end. The wrapper pads
rows to a multiple of 8 features with zeros. A CUDA kernel cannot run here,
so this file writes the same algorithm in plain PyTorch (a bf16 x bf16
product is exact in fp32; each k-step sums its 16 products per (i, j) from a
[own, stream, 16] tensor, so the sum does not depend on which matrix is own;
step 3 likewise, k-step by k-step in fp32, dz_hi then dz_lo)
and holds it against the unchanged plain versions ``fused_ce_fwd_plain``
(``chip_smoke.py``'s 1e-5 of 1 + |loss|) and ``fused_ce_bwd_da_plain`` /
``fused_ce_bwd_db_plain`` (1e-4 of the largest |grad|, dscale included), and
against the JAX package's Pallas kernels in interpret mode through
``fused_contrastive_ce`` and its ``jax.vjp``. The forward's raw equals the
backward's bit for bit, and b = a at scale 100 ("tied-100") meets the bar
when the backward is fed the tiled forward's lse. A control rounds dz to
bf16 once instead of splitting it and fails the same bar where every label
logit dominates. Past 768 features the kernels take the chunked walk
(768's geometry, the logit tile over chunks of 256 features, raw added
across them; the backward's output in feature slices of at most 768, each
recomputing raw): emulated here at D = 1000 and 1024 against the plain
versions and the Pallas kernels, and forced at D <= 768, where it must give
today's whole-tile walk's bits. The emulation is used by nothing in the
package.
"""
from __future__ import annotations

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.ops.fused_ce import fused_contrastive_ce as jax_fused_ce
from colxlip_tpu_torch.ops import fused_ce

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = REPO / "colxlip_tpu_torch" / "csrc" / "fused_ce.cu"
WARPS = 8                               # kWarps
STREAM_ROWS = 64                        # kStreamRows: rows of the streamed matrix a tile
PAD = 8                                 # kPad: elements of padding a staged row
KSTEP = 16                              # features an mma k-step
CAPACITIES = (64, 128, 256, 512, 768)   # the feature capacities DC the dispatch takes
CHUNK = 256                             # kChunk: features a chunk of the chunked walk
MAX_SHARED = 232448                     # common.cuh kMaxSharedBytes
CE_FWD_TOL = 1e-5
CE_BWD_TOL = 1e-4
NEG = -1e30                             # kNeg: the running max's start, and columns past N
SHAPES = [
    # M, N, D, logit scale
    (256, 256, 512, 1 / 0.07),   # one step of the entry point
    (33, 129, 64, 30.0),         # ragged, M != N
    (100, 70, 40, 100.0),        # D = 40: a ragged k-step, the scale at its clamp
    (130, 200, 36, 20.0),        # D = 36: padded to 40 by the wrapper
    (70, 65, 768, 50.0),         # ViT-L-14's embed_dim: 32 own rows, one stage
]


def own_rows(capacity: int) -> int:
    """Cfg<DC>::kOwn."""
    return 64 if capacity <= 512 else 32


def capacity(d: int) -> int:
    """The feature capacity (the geometry) the dispatch picks for rows of d
    features: past the widest, the chunked walk in the widest's geometry."""
    return next((c for c in CAPACITIES if d <= c), CAPACITIES[-1])


def chunked_slices(dp: int):
    """launch_chunked's output slices: as few as keep each within 768
    features, near-equal, a multiple of 16: (slices, width)."""
    slices = -(-dp // CAPACITIES[-1])
    return slices, -(-(-(-dp // slices)) // 16) * 16


def chunked_bytes() -> tuple:
    """ChunkCfg: (the backward's shared bytes, the forward's)."""
    own, rs = own_rows(CAPACITIES[-1]), CHUNK + PAD
    stages = 2 * (own * rs * 2 + STREAM_ROWS * rs * 2)
    wide = CAPACITIES[-1] + PAD
    wc = WARPS // (own // 16)
    bwd = (stages + STREAM_ROWS * wide * 2 + 3 * STREAM_ROWS * 4
           + 2 * own * (STREAM_ROWS + PAD) * 2 + wc * own * 4)
    return bwd, stages + 3 * wc * own * 4


def shared_bytes(dc: int, stages: int) -> int:
    """Cfg<DC>::bytes(stages): the own tile, the stream stages with their
    lse / g / label rows, the two dz halves, dscale's partial sums."""
    own, rs = own_rows(dc), dc + PAD
    wc = WARPS // (own // 16)
    return (own * rs * 2 + stages * (STREAM_ROWS * rs * 2 + 3 * STREAM_ROWS * 4)
            + 2 * own * (STREAM_ROWS + PAD) * 2 + wc * own * 4)


def fwd_shared_bytes(dc: int, stages: int) -> int:
    """FwdCfg<DC>::bytes(stages): the own tile, the stream stages, and the
    (max, sum, label logit) of each own row from each column group."""
    own, rs = own_rows(dc), dc + PAD
    wc = WARPS // (own // 16)
    return own * rs * 2 + stages * STREAM_ROWS * rs * 2 + 3 * wc * own * 4


def _inputs(m, n, d, scale, seed=0, tied=False):
    """Unit rows in bf16 (as the towers' l2_normalize returns them), labels,
    per-row cotangents g, and lse from the plain forward."""
    rng = np.random.default_rng(seed)

    def unit(rows):
        x = rng.standard_normal((rows, d))
        return torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
            np.float32)).bfloat16()

    a = unit(m)
    b = a.clone() if tied else unit(n)
    labels = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
    g = torch.from_numpy((rng.random(m) / m).astype(np.float32))
    s = torch.tensor(scale, dtype=torch.float32)
    _, lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    return a, b, labels, s, lse, g


def _staged(x: torch.Tensor, row0: int, rows: int, width: int) -> torch.Tensor:
    """Rows row0 .. row0 + rows - 1 of x as a tile sees them: fp32, zeros past
    the last row and past the last feature."""
    out = torch.zeros(rows, width)
    live = x[row0:row0 + rows].float()
    out[:live.shape[0], :live.shape[1]] = live
    return out


def logit_tile(x: torch.Tensor, y: torch.Tensor, raw=None) -> torch.Tensor:
    """The kernels' shared step 1: raw = x . y^T for an own tile x [rows, kp]
    and a stream tile y [64, kp], one k-step of 16 features at a time from
    zero, added in fp32 (to ``raw`` as it stands: logit_tile_add). A k-step
    sums the 16 exact products of (i, j) from a [rows, 64, 16] tensor, so
    raw_ij has the same bits whichever matrix owns the rows."""
    raw = torch.zeros(x.shape[0], y.shape[0]) if raw is None else raw
    for k0 in range(0, x.shape[1], KSTEP):
        raw = raw + (x[:, None, k0:k0 + KSTEP] * y[None, :, k0:k0 + KSTEP]).sum(dim=-1)
    return raw


def chunked_logit_tile(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The chunked walk's step 1: the own and stream rows staged one chunk of
    256 features at a time (zeros past D), each chunk's k-steps added to raw
    in order; a chunk takes only the k-steps that reach D."""
    raw = torch.zeros(x.shape[0], y.shape[0])
    for f0 in range(0, x.shape[1], CHUNK):
        raw = logit_tile(x[:, f0:f0 + CHUNK], y[:, f0:f0 + CHUNK], raw)
    return raw


def tile_product(dz: torch.Tensor, y: torch.Tensor, split: bool = True) -> torch.Tensor:
    """Step 3's tile sum from zero, in the kernel's order: for each of the
    tile's k-steps of 16 stream rows, the 16 exact bf16 x bf16 products of
    dz_hi (then of dz_lo) with a column of y summed in fp32 and added to the
    tile's fp32 sum (one mma each), which the caller adds to acc. A column's
    sum reads only that column of y (an mma n-tile), so the columns of a
    slice of y get the bits the whole y gives them."""
    hi = dz.bfloat16().float()
    halves = (hi, (dz - hi).bfloat16().float()) if split else (hi,)
    yt = y.T.contiguous()
    tile = torch.zeros(dz.shape[0], y.shape[1])
    for k0 in range(0, dz.shape[1], KSTEP):
        for half in halves:
            tile = tile + (half[:, None, k0:k0 + KSTEP] * yt[None, :, k0:k0 + KSTEP]).sum(-1)
    return tile


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small tensor operations: one intra-op thread, so that the
    suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _merge(m1, s1, m2, s2):
    """The kernel's merge_lse: the larger max, each sum rescaled to it."""
    mm = torch.maximum(m1, m2)
    return mm, s1 * torch.exp(m1 - mm) + s2 * torch.exp(m2 - mm)


def tiled_forward(a, b, labels, scale, raws=None, chunked=None):
    """The forward kernel's algorithm: (loss [M], lse [M]) fp32. ``raws``, if
    a list, collects each (own block, stream tile)'s raw. ``chunked`` (by
    default past 768 features) takes the chunked walk's step 1."""
    m, d = a.shape
    n = b.shape[0]
    dp = -(-d // 8) * 8
    kp = -(-dp // KSTEP) * KSTEP
    chunked = dp > CAPACITIES[-1] if chunked is None else chunked
    step1 = chunked_logit_tile if chunked else logit_tile
    rows = own_rows(capacity(dp))
    wc = WARPS // (rows // 16)                   # column groups of warps
    nt = STREAM_ROWS // wc // 8                  # n-tiles a warp holds
    scale = torch.as_tensor(scale, dtype=torch.float32)
    labels = labels.long()
    loss, lse = torch.zeros(m), torch.zeros(m)
    for o0 in range(0, m, rows):
        x = _staged(a, o0, rows, kp)
        lab = torch.full((rows,), -1, dtype=torch.long)
        lab[:min(rows, m - o0)] = labels[o0:o0 + rows]
        lab = torch.where(lab < n, lab, -1)          # label_of: past N, no column
        # a thread's state: [row, column group, lane t of the quad]
        mx = torch.full((rows, wc, 4), NEG)
        sm = torch.zeros(rows, wc, 4)
        zl = torch.zeros(rows, wc, 4)
        for s0 in range(0, n, STREAM_ROWS):
            raw = step1(x, _staged(b, s0, STREAM_ROWS, kp))
            if raws is not None:
                raws.append(((o0, s0), raw))
            col = torch.arange(s0, s0 + STREAM_ROWS)
            z = torch.where(col[None, :] < n, scale * raw, torch.tensor(NEG))

            def by_thread(t):   # column group, quad lane, then its nt x 2 columns in order
                return t.reshape(t.shape[0], wc, nt, 4, 2).transpose(2, 3).reshape(
                    t.shape[0], wc, 4, 2 * nt)

            zt, ct = by_thread(z), by_thread(col[None, :].expand(rows, -1))
            zl = zl + torch.where(ct == lab[:, None, None, None], zt, torch.zeros(())).sum(-1)
            mnew = torch.maximum(mx, zt.amax(dim=-1))
            p = torch.zeros(rows, wc, 4)
            for i in range(2 * nt):
                p = p + torch.exp(zt[..., i] - mnew)
            sm = sm * torch.exp(mx - mnew) + p
            mx = mnew
        # the quad: lanes t ^ 1, then t ^ 2
        m01, s01 = _merge(mx[..., 0], sm[..., 0], mx[..., 1], sm[..., 1])
        m23, s23 = _merge(mx[..., 2], sm[..., 2], mx[..., 3], sm[..., 3])
        mq, sq = _merge(m01, s01, m23, s23)
        zq = (zl[..., 0] + zl[..., 1]) + (zl[..., 2] + zl[..., 3])
        # the column groups in order
        mm, ss, zz = mq[:, 0], sq[:, 0], zq[:, 0]
        for w in range(1, wc):
            mm, ss = _merge(mm, ss, mq[:, w], sq[:, w])
            zz = zz + zq[:, w]
        live = min(rows, m - o0)
        row_lse = mm + torch.log(ss)
        lse[o0:o0 + live] = row_lse[:live]
        loss[o0:o0 + live] = (row_lse - zz)[:live]
    return loss, lse


def tiled_backward(a, b, labels, scale, lse, g, da: bool, split: bool = True, raws=None,
                   chunked=None, slices=None):
    """The kernel's algorithm: dA [M, D] and dscale rows [M] (da), or dB
    [N, D]; ``split=False`` is the control that rounds dz to bf16 once.
    ``chunked`` (by default past 768 features) takes the chunked walk: raw by
    chunks, the output in ``slices`` feature slices (launch_chunked's by
    default), each walking every stream tile and recomputing raw; slice 0
    writes dscale."""
    m, d = a.shape
    n = b.shape[0]
    dp = -(-d // 8) * 8                   # the wrapper's padding
    kp = -(-dp // KSTEP) * KSTEP          # the k-steps the logit tile takes
    chunked = dp > CAPACITIES[-1] if chunked is None else chunked
    step1 = chunked_logit_tile if chunked else logit_tile
    if not chunked:
        slices, width = 1, kp
    elif slices is None:
        slices, width = chunked_slices(dp)
    else:
        width = -(-(-(-dp // slices)) // 16) * 16
    rows = own_rows(capacity(dp))
    own, stream = (a, b) if da else (b, a)
    own_n, stream_n = (m, n) if da else (n, m)
    scale = float(scale)
    labels = labels.long()
    out = torch.zeros(own_n, dp)
    dscale = torch.zeros(m)
    for o0, f0 in ((o0, sl * width) for o0 in range(0, own_n, rows) for sl in range(slices)):
        x = _staged(own, o0, rows, kp)
        own_idx = torch.arange(o0, o0 + rows)
        own_live = own_idx < own_n
        acc = torch.zeros(rows, min(width, kp - f0))
        ds = torch.zeros(rows)
        for s0 in range(0, stream_n, STREAM_ROWS):
            y = _staged(stream, s0, STREAM_ROWS, kp)
            col_idx = torch.arange(s0, s0 + STREAM_ROWS)
            col_live = col_idx < stream_n
            raw = step1(x, y)
            if raws is not None and f0 == 0:
                raws.append(((o0, s0), raw))
            if da:
                at = own_idx.clamp(max=m - 1)
                lse_t, g_t = lse[at][:, None], g[at][:, None]
                onehot = col_idx[None, :] == labels[at][:, None]
            else:
                at = col_idx.clamp(max=m - 1)
                lse_t, g_t = lse[at][None, :], g[at][None, :]
                onehot = own_idx[:, None] == labels[at][None, :]
            p = torch.exp(scale * raw - lse_t)
            dz = torch.where(own_live[:, None] & col_live[None, :],
                             (p - onehot.float()) * g_t, torch.zeros(()))
            if da:
                ds = ds + (dz * raw).sum(dim=1)
            acc = acc + tile_product(dz, y[:, f0:f0 + acc.shape[1]], split)
        live = min(rows, own_n - o0)
        out[o0:o0 + live, f0:f0 + acc.shape[1]] = scale * acc[:live, :dp - f0]
        if da and f0 == 0:
            dscale[o0:o0 + live] = ds[:live]
    out = out[:, :d]
    return (out, dscale) if da else out


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _errors(a, b, labels, s, lse, g, split=True):
    da, ds = tiled_backward(a, b, labels, s, lse, g, True, split)
    db = tiled_backward(a, b, labels, s, lse, g, False, split)
    want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, lse, g)
    want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, lse, g)
    return _rel(da, want_da), _rel(ds, want_ds), _rel(db, want_db)


def test_constants_are_the_kernels_own():
    """The emulation's tile sizes are the source's, its feature capacities
    the dispatch's, and its bar chip_smoke.py's."""
    src = SOURCE.read_text()
    for name, value in (("kWarps", WARPS), ("kStreamRows", STREAM_ROWS), ("kPad", PAD)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "static constexpr int kOwn = DC <= 512 ? 64 : 32;" in src
    assert [int(c) for c in re.findall(r"return launch<(\d+), DA>", src)] == list(CAPACITIES)
    assert [int(c) for c in re.findall(r"if \(x\.d <= (\d+)\) return launch<", src)] == \
        list(CAPACITIES[:-1])
    # past the widest capacity the chunked walk: both dtypes take any D
    assert not hasattr(fused_ce, "MAX_FEATURES")
    assert f"constexpr int kMaxBf16D = {CAPACITIES[-1]};" in src
    assert f"constexpr int kChunk = {CHUNK};" in src
    assert "if (x.d <= kMaxBf16D) return launch<768, DA>(x, out, dscale);" in src
    assert "return launch_chunked<DA>(x, out, dscale);" in src
    assert "return launch_fwd<kMaxBf16D, true>(x, loss, lse);" in src
    assert "const int slice = ((x.d + slices - 1) / slices + 15) / 16 * 16;" in src
    assert "mma::mma_16816_rn(raw[2 * np]" in src        # k-steps from zero, added in fp32
    # the forward: the same capacities and geometry, its own shared memory,
    # and step 1 through the one function the backward calls
    assert [int(c) for c in re.findall(r"return launch_fwd<(\d+)>", src)] == list(CAPACITIES)
    assert "struct FwdCfg : Cfg<DC>" in src
    assert "static constexpr size_t kPartBytes = 3 * size_t(B::kWC) * B::kOwn * 4;" in src
    assert "return B::kOwnBytes + stages * B::kStreamBytes + kPartBytes;" in src
    assert len(re.findall(r"logit_tile<C::kRawNT, RS>\(raw, pa,", src)) == 2
    assert "constexpr float kNeg = -1e30f;" in src and NEG == -1e30
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.CE_BWD_TOL == CE_BWD_TOL and smoke.CE_FWD_TOL == CE_FWD_TOL


@pytest.mark.parametrize("dc", CAPACITIES)
def test_tiles_fit_and_ldmatrix_rows_are_conflict_free(dc):
    """Two stream stages fit in shared memory up to D = 512, one at 768; the
    tiles' and dz's row strides put the eight 16-byte rows of an ldmatrix
    phase in eight bank groups; the output a thread holds stays at most 128
    fp32 registers."""
    stages = 2 if shared_bytes(dc, 2) <= MAX_SHARED else 1
    assert stages == (2 if dc <= 512 else 1)
    assert shared_bytes(dc, stages) <= MAX_SHARED
    for rs in (dc + PAD, STREAM_ROWS + PAD):
        assert len({(r * rs * 2 // 16) % 8 for r in range(8)}) == 8, rs
    assert own_rows(dc) * dc // (WARPS * 32) <= 128


@pytest.mark.parametrize("dc", CAPACITIES)
def test_forward_tiles_fit(dc):
    """The forward holds no dz: two stream stages up to D = 512, one at 768,
    and two blocks an SM (228 KB of shared memory) up to D = 256."""
    stages = 2 if fwd_shared_bytes(dc, 2) <= MAX_SHARED else 1
    assert stages == (2 if dc <= 512 else 1)
    assert fwd_shared_bytes(dc, stages) <= min(MAX_SHARED, shared_bytes(dc, stages))
    assert (2 * (fwd_shared_bytes(dc, stages) + 1024) <= 233472) == (dc <= 256)


def test_wrapper_pads_rows_to_eight_features():
    a, b = torch.ones(5, 36, dtype=torch.bfloat16), torch.ones(7, 36, dtype=torch.bfloat16)
    pa, pb = fused_ce.mma_operands(a, b)
    assert pa.shape == (5, 40) and pb.shape == (7, 40)
    assert torch.equal(pa[:, :36], a) and not pa[:, 36:].any() and not pb[:, 36:].any()
    a, b = torch.ones(5, 40, dtype=torch.bfloat16), torch.ones(7, 40, dtype=torch.bfloat16)
    assert all(x is y for x, y in zip(fused_ce.mma_operands(a, b), (a, b)))


@pytest.mark.parametrize("m,n,d,scale", SHAPES)
def test_tiled_backward_matches_plain(m, n, d, scale):
    errs = _errors(*_inputs(m, n, d, scale))
    assert max(errs) <= CE_BWD_TOL, errs


@pytest.mark.parametrize("m,n,d,scale", SHAPES)
def test_tiled_forward_matches_plain(m, n, d, scale):
    a, b, labels, s, want_lse, _ = _inputs(m, n, d, scale)
    want_loss, _ = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    loss, lse = tiled_forward(a, b, labels, s)
    for got, want in ((loss, want_loss), (lse, want_lse)):
        assert ((got - want).abs() / (1 + want.abs())).max().item() <= CE_FWD_TOL


def test_labels_past_n_match_no_column():
    """A label in [N, the last tile's end) matches no column, as in the
    plain version (its row's loss is its logsumexp), where the tile's
    columns past N hold -1e30; labels at and past the tile's end too."""
    a, b, _, s, _, _ = _inputs(40, 70, 64, 30.0, seed=23)
    labels = torch.arange(40, dtype=torch.int32) * 3          # 72..117: inside tile 1, past N
    want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    loss, lse = tiled_forward(a, b, labels, s)
    assert torch.equal(want_loss[labels >= 70], want_lse[labels >= 70])
    for got, want in ((loss, want_loss), (lse, want_lse)):
        assert ((got - want).abs() / (1 + want.abs())).max().item() <= CE_FWD_TOL


def test_tiled_forward_matches_jax_pallas():
    """The emulated forward's mean loss against the JAX package's Pallas
    forward (interpret mode); M != N, D = 40 and a ragged last tile."""
    m, n, d, scale = 70, 100, 40, 30.0
    a, b, labels, s, _, _ = _inputs(m, n, d, scale, seed=5)
    want = float(jax_fused_ce(jnp.asarray(a.float().numpy()), jnp.asarray(b.float().numpy()),
                              jnp.asarray(labels.numpy()), jnp.float32(scale), block_m=8,
                              block_n=128, interpret=True))
    loss, _ = tiled_forward(a, b, labels, s)
    assert abs(loss.mean().item() - want) <= CE_FWD_TOL * (1 + abs(want))


@pytest.mark.parametrize("m,n,d", [(130, 200, 36), (70, 65, 768), (40, 70, 1000)])
def test_forward_and_backward_take_the_same_raw(m, n, d):
    """raw of every (own block, stream tile) in the forward is the dA
    kernel's bit for bit, and the dB kernel's (own and stream swapped) is its
    transpose bit for bit: one helper, one k order."""
    a, b, labels, s, lse, g = _inputs(m, n, d, 20.0, seed=7)
    fwd, bwd_a, bwd_b = [], [], []
    tiled_forward(a, b, labels, s, raws=fwd)
    tiled_backward(a, b, labels, s, lse, g, True, raws=bwd_a)
    tiled_backward(a, b, labels, s, lse, g, False, raws=bwd_b)
    assert [k for k, _ in fwd] == [k for k, _ in bwd_a]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(fwd, bwd_a))
    # one full own block of dB against the forward's tiles it covers
    full = torch.cat([torch.cat([r for (o0, s0), r in fwd if s0 == c0], 0)
                      for c0 in range(0, -(-n // STREAM_ROWS) * STREAM_ROWS, STREAM_ROWS)], 1)
    rows = own_rows(capacity(-(-d // 8) * 8))
    for (o0, s0), raw in bwd_b:
        want = full[s0:s0 + STREAM_ROWS, o0:o0 + rows].T
        assert torch.equal(raw[:want.shape[0], :want.shape[1]], want)


def test_chunked_tiles_fit_and_slice_the_output():
    """The chunked walk's two stages of 256-feature chunks, the slice tile
    and the rest fit in shared memory, the forward's twice an SM; the
    output slices are near-equal multiples of 16 within 768 features."""
    bwd, fwd = chunked_bytes()
    assert bwd <= MAX_SHARED and 2 * (fwd + 1024) <= 233472
    assert len({(r * (CHUNK + PAD) * 2 // 16) % 8 for r in range(8)}) == 8
    assert chunked_slices(776) == (2, 400) and chunked_slices(1000) == (2, 512)
    assert chunked_slices(1024) == (2, 512) and chunked_slices(4096) == (6, 688)
    for dp in range(776, 4200, 8):
        slices, width = chunked_slices(dp)
        assert width <= CAPACITIES[-1] and width % 16 == 0
        assert (slices - 1) * width < dp <= slices * width


@pytest.mark.parametrize("m,n,d,scale", [(70, 130, 1000, 30.0), (33, 100, 1024, 50.0)])
def test_chunked_walk_matches_plain(m, n, d, scale):
    """Past 768 features (the widths bf16 used to refuse): the forward within
    1e-5 of 1 + |loss|, dA, dscale and dB within 1e-4 of max|grad| of the
    plain versions; ragged M and N."""
    a, b, labels, s, want_lse, g = _inputs(m, n, d, scale, seed=13)
    want_loss, _ = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    loss, lse = tiled_forward(a, b, labels, s)
    for got, want in ((loss, want_loss), (lse, want_lse)):
        assert ((got - want).abs() / (1 + want.abs())).max().item() <= CE_FWD_TOL
    errs = _errors(a, b, labels, s, want_lse, g)
    assert max(errs) <= CE_BWD_TOL, errs


def test_chunked_walk_matches_jax_pallas():
    """The chunked walk at D = 1000 against the Pallas kernels (interpret
    mode): the mean loss, and dA, dB, dscale through jax.vjp."""
    m, n, d, scale = 40, 90, 1000, 30.0
    a, b, labels, s, lse, _ = _inputs(m, n, d, scale, seed=17)
    g = torch.full((m,), 1.0 / m)

    def loss(a_, b_, s_):
        return jax_fused_ce(a_, b_, jnp.asarray(labels.numpy()), s_, block_m=8, block_n=128,
                            interpret=True)

    want, vjp = jax.vjp(loss, jnp.asarray(a.float().numpy()), jnp.asarray(b.float().numpy()),
                        jnp.float32(scale))
    got, _ = tiled_forward(a, b, labels, s)
    assert abs(got.mean().item() - float(want)) <= CE_FWD_TOL * (1 + abs(float(want)))
    want_da, want_db, want_ds = (torch.from_numpy(np.array(x)) for x in vjp(jnp.float32(1.0)))
    da, ds = tiled_backward(a, b, labels, s, lse, g, True)
    db = tiled_backward(a, b, labels, s, lse, g, False)
    assert _rel(da, want_da) <= CE_BWD_TOL and _rel(db, want_db) <= CE_BWD_TOL
    np.testing.assert_allclose(ds.sum().item(), float(want_ds), rtol=CE_BWD_TOL)


@pytest.mark.parametrize("m,n,d,slices", [(70, 65, 768, 2), (40, 90, 600, 3)])
def test_chunked_walk_gives_the_whole_tiles_bits(m, n, d, slices):
    """Forced at D <= 768 (768's geometry), the chunked walk with the output
    in feature slices gives today's whole-tile walk's bits: loss, lse, dA,
    dscale and dB."""
    a, b, labels, s, lse, g = _inputs(m, n, d, 40.0, seed=19)
    for chunked in (False, True):
        got = (*tiled_forward(a, b, labels, s, chunked=chunked),
               *tiled_backward(a, b, labels, s, lse, g, True, chunked=chunked, slices=slices),
               tiled_backward(a, b, labels, s, lse, g, False, chunked=chunked, slices=slices))
        if chunked:
            assert all(torch.equal(x, y) for x, y in zip(got, whole))
        whole = got


def test_tied_100_meets_the_bar_with_the_tiled_forward():
    """b = a at logit scale 100 ("tied-100"): the emulated backward fed the
    emulated forward's lse (the kernels' path: both from one logit tile)
    against the plain backward fed the plain lse holds 1e-4 of max|grad| for
    dA, dB and dscale; the forward holds its own bar too."""
    a, b, labels, s, want_lse, g = _inputs(512, 512, 512, 100.0, seed=11, tied=True)
    want_loss, _ = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    loss, lse = tiled_forward(a, b, labels, s)
    assert ((loss - want_loss).abs() / (1 + want_loss.abs())).max().item() <= CE_FWD_TOL
    da, ds = tiled_backward(a, b, labels, s, lse, g, True)
    db = tiled_backward(a, b, labels, s, lse, g, False)
    want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, want_lse, g)
    want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, want_lse, g)
    errs = (_rel(da, want_da), _rel(ds, want_ds), _rel(db, want_db))
    assert max(errs) <= CE_BWD_TOL, errs


def test_label_logits_that_dominate_need_the_split():
    """b = a at scale 100: every row's own column is its largest logit and
    the label term (p - 1) g is the largest of most rows. The split meets the
    bar; dz rounded to bf16 once (the control) does not."""
    args = _inputs(192, 192, 512, 100.0, seed=3, tied=True)
    assert max(_errors(*args)) <= CE_BWD_TOL
    control = _errors(*args, split=False)
    assert min(control[0], control[2]) > 2 * CE_BWD_TOL, control


def test_tiled_backward_matches_jax_pallas():
    """The emulated kernels against the JAX package's Pallas backward
    (interpret mode) through jax.vjp of the mean loss: g = 1 / M on every
    row; M != N, D = 40 and a ragged last tile."""
    m, n, d, scale = 70, 100, 40, 30.0
    a, b, labels, s, lse, _ = _inputs(m, n, d, scale, seed=5)
    g = torch.full((m,), 1.0 / m)

    def loss(a_, b_, s_):
        return jax_fused_ce(a_, b_, jnp.asarray(labels.numpy()), s_, block_m=8, block_n=128,
                            interpret=True)

    _, vjp = jax.vjp(loss, jnp.asarray(a.float().numpy()), jnp.asarray(b.float().numpy()),
                     jnp.float32(scale))
    want_da, want_db, want_ds = (torch.from_numpy(np.array(x)) for x in vjp(jnp.float32(1.0)))
    da, ds = tiled_backward(a, b, labels, s, lse, g, True)
    db = tiled_backward(a, b, labels, s, lse, g, False)
    assert _rel(da, want_da) <= CE_BWD_TOL
    assert _rel(db, want_db) <= CE_BWD_TOL
    np.testing.assert_allclose(ds.sum().item(), float(want_ds), rtol=CE_BWD_TOL)


def test_register_report_names_each_kernel_of_a_namespace(monkeypatch):
    """build.resource_usage keys each kernel by its name and template
    arguments without its namespaces, so the five capacities of both
    directions of ce_bwd_mma_kernel (in ce_mma) are five rows each, not one."""
    from colxlip_tpu_torch.ops import build

    entries = [("(anonymous namespace)::ce_mma::ce_bwd_mma_kernel<512, true>", 180, 0),
               ("(anonymous namespace)::ce_mma::ce_bwd_mma_kernel<768, false>", 150, 8),
               ("(anonymous namespace)::ce_fwd_kernel<float>", 64, 0),
               ("colxlip::stream_tile::reduce_partials_kernel<0>", 32, 0)]
    text = "".join(
        f"ptxas info    : Compiling entry function 'void {name}(int)' for 'sm_90a'\n"
        f"ptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for name, regs, spill in entries)

    class Done:
        returncode, stderr = 0, text

        def __init__(self, stdout=""):
            self.stdout = stdout

    def run(cmd, input=None, **kwargs):
        return Done(input) if cmd[0] == "c++filt" else Done()

    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    assert build.resource_usage(["fused_ce"]) == {
        "ce_bwd_mma_kernel<512, true>": (180, 0, 0, 0),
        "ce_bwd_mma_kernel<768, false>": (150, 0, 8, 8),
        "ce_fwd_kernel<float>": (64, 0, 0, 0),
        "reduce_partials_kernel<0>": (32, 0, 0, 0)}
