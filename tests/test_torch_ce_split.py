"""The float32 CE dA kernel split across the streamed columns, emulated on
the CPU.

``csrc/fused_ce.cu`` ``ce_bwd_da_kernel<float, DPT>`` gives a block 32 rows
of a (16 x 16 threads, ``stream_tile.cuh``) and walks b in tiles of 64
rows. Per tile: raw_ij = <a_i, b_j> as one fmaf chain over D in order
(``raw_tile``), dz_ij = (exp(scale raw - lse_i) - [j == label_i]) g_i with
rows and columns past either end 0, each thread's dscale sum fmaf(dz, raw,
ds) over its columns (tx + 16 c of each tile, in order), and dz B added
column by column into the block's fp32 rows (``accumulate``: one fmaf chain
over the columns in order an element). At the end the 16 column lanes of a
row add up by the xor butterfly (8, 4, 2, 1) and dA is stored times scale.

Split: the grid is (row blocks) x (S slices of b's whole 64-row tiles,
``ops.fused_ce.fp32_da_slices``). Block (i, s) walks only its slice's tiles
and stores its unscaled partial dA and dscale rows; ``reduce_partials`` adds
the slices in slice order from zero, and dA times scale once after the sum.
With one slice the kernel is the unsplit walk. A CUDA kernel cannot run
here, so this file writes both walks in plain PyTorch (every fmaf a float64
product and sum rounded once to fp32) and holds the split walk, S in 1, 3
and 16 at ragged M, N and D = 40 with labels offset past M, to the unsplit
walk (S = 1 bit for bit), to ``fused_ce_bwd_da_plain`` and to the JAX
package's Pallas backward in interpret mode through ``jax.vjp``, all at
``chip_smoke.py``'s CE_BWD_TOL (1e-4 of the largest |grad|); it also pins
the slice rule and the source's split. The emulation is used by nothing in
the package.

The float32 forward and dB split the same way. ``ce_fwd_kernel`` gives a
block 64 rows of a and S slices of b's tiles (``fp32_fwd_slices``); each
slice walks its tiles from max = -1e30 with the unsplit kernel's per-thread
recurrence (tile max, the sum rescaled, exp(z - max) added over the
thread's 4 columns in order, the 16 lanes added by the xor butterfly) and
stores its (max, sum, label logit) rows; ``ce_fwd_merge_kernel`` merges the
pairs in slice order from slice 0's and adds the label logits in slice
order. ``ce_bwd_db_kernel`` gives a block 32 rows of b and S slices of a's
tiles (``fp32_db_slices``), its unscaled partial dB added in slice order and
times scale once. Both are emulated at the same shape and held to the same
oracles (the forward's loss rows and lse at 1e-5 of 1 + |value|). The tiles
that all three kernels share (``stream_tile.cuh``) are emulated at the
thread level: ``raw_tile``'s row-major chunks with their padded stride and
float4 reads, and ``accumulate``'s staged rows with a thread's 8 rows x DPT
features, each against the scalar walk (feature-major chunks read one
scalar at a time; a warp's 4 rows over lanes + 32 c read from device
memory), bit for bit; the wide rows' feature slices at D = 1000 against the
plain versions and the JAX package.
"""
from __future__ import annotations

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.ops.fused_ce import fused_contrastive_ce as jax_fused_ce
from colxlip_tpu_torch.ops import fused_ce

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "colxlip_tpu_torch" / "csrc" / "fused_ce.cu"
STREAM = 64             # stream_tile.cuh kStream: rows of b a tile
LANES = 16              # kTX: column lanes of a row
CE_BWD_TOL = 1e-4       # chip_smoke.py CE_BWD_TOL
M, N, D, SCALE, OFFSET = 70, 1000, 40, 30.0, 700   # 16 tiles of b, the last 40 rows
SLICES = [1, 3, 16]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small tensor operations: one intra-op thread, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Unit rows in fp32, labels M offset by OFFSET (the rows of a later rank's
    block), per-row cotangents g = 1 / M (the mean loss) and lse from the
    plain forward."""
    rng = np.random.default_rng(21)

    def unit(rows):
        x = rng.standard_normal((rows, D))
        return torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))

    a, b = unit(M), unit(N)
    labels = torch.arange(M, dtype=torch.int32) + OFFSET
    s = torch.tensor(SCALE, dtype=torch.float32)
    g = torch.full((M,), 1.0 / M)
    _, lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    return a, b, labels, s, lse, g


def fma_products(a_mk: torch.Tensor, b_kn: torch.Tensor) -> torch.Tensor:
    """C = A . B in fp32, each element one fmaf chain over K in order from
    zero (the product exact in float64, the sum rounded to fp32 once)."""
    at, b = a_mk.double().T.contiguous(), b_kn.double()
    acc = torch.zeros(at.shape[1], b.shape[1])
    for k in range(at.shape[0]):
        acc = (torch.outer(at[k], b[k]) + acc.double()).float()
    return acc


def raw_and_dz(a, b, labels, scale, lse, g):
    """raw [M, N] (raw_tile) and dz [M, N] as the kernel's epilogue makes it."""
    raw = fma_products(a, b.T)
    dz = torch.exp(scale * raw - lse[:, None])
    onehot = torch.arange(b.shape[0])[None, :] == labels.long()[:, None]
    return raw, (dz - onehot.float()) * g[:, None]


def lane_dscale(dz, raw, cols: range) -> torch.Tensor:
    """A row's dscale over the columns ``cols``: lane t chains fmaf(dz, raw)
    over its columns (those = t mod 16) in order, then the xor butterfly."""
    lanes = torch.zeros(dz.shape[0], LANES)
    for j in cols:
        t = j % LANES
        lanes[:, t] = (dz[:, j].double() * raw[:, j].double() + lanes[:, t].double()).float()
    for o in (8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(LANES) ^ o]
    return lanes[:, 0]


def walk_fp32_da(a, b, labels, scale, lse, g):
    """The unsplit kernel: every tile of b in order into one running dA and
    dscale; dA times scale at the end."""
    n = b.shape[0]
    raw, dz = raw_and_dz(a, b, labels, scale, lse, g)
    out = torch.zeros(a.shape)
    for j0 in range(0, n, STREAM):
        for j in range(j0, min(n, j0 + STREAM)):     # accumulate: column by column
            out = (torch.outer(dz[:, j].double(), b[j].double()) + out.double()).float()
    return scale * out, lane_dscale(dz, raw, range(n))


def split_fp32_da(a, b, labels, scale, lse, g, slices: int):
    """The split kernel: slice s walks tiles [s per, (s + 1) per) of b
    (per = ceil(tiles / slices), so that none is empty); each slice's
    unscaled partial dA and dscale from zero, added in slice order from zero
    (reduce_partials), dA times scale once after the sum."""
    n = b.shape[0]
    tiles = -(-n // STREAM)
    per = -(-tiles // slices)
    raw, dz = raw_and_dz(a, b, labels, scale, lse, g)
    da, ds = torch.zeros(a.shape), torch.zeros(a.shape[0])
    for j0 in range(0, n, per * STREAM):
        cols = range(j0, min(n, j0 + per * STREAM))
        da = da + fma_products(dz[:, cols.start:cols.stop], b[cols.start:cols.stop])
        ds = ds + lane_dscale(dz, raw, cols)
    return scale * da, ds


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@functools.lru_cache(maxsize=None)
def _jax_vjp(which: str = "split"):
    """The JAX package's mean loss and its dA, dB and dscale (Pallas kernels
    in interpret mode, through jax.vjp) on ``which``'s inputs."""
    a, b, labels, _, _, _ = _inputs() if which == "split" else _wide_inputs()

    def loss(a_, b_, s_):
        return jax_fused_ce(a_, b_, jnp.asarray(labels.numpy()), s_, block_m=40, block_n=512,
                            interpret=True)

    value, vjp = jax.vjp(loss, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                         jnp.float32(SCALE))
    da, db, ds = vjp(jnp.float32(1.0))
    return (float(value), torch.from_numpy(np.array(da)), torch.from_numpy(np.array(db)),
            float(ds))


def _jax_grads():
    """dA and dscale of the JAX package's Pallas backward (interpret mode)
    through jax.vjp of the mean loss."""
    _, da, _, ds = _jax_vjp()
    return da, ds


def test_one_slice_is_the_unsplit_walk():
    """S = 1 walks every tile in the order the unsplit kernel does: dA and
    dscale bit for bit."""
    args = _inputs()
    want_da, want_ds = walk_fp32_da(*args)
    da, ds = split_fp32_da(*args, 1)
    assert torch.equal(da, want_da) and torch.equal(ds, want_ds)


@pytest.mark.parametrize("slices", SLICES)
def test_split_da_matches_plain(slices):
    """Every S within CE_BWD_TOL of ``fused_ce_bwd_da_plain`` (dA and the
    dscale rows); S > 1 moves only the order of the sums across slices."""
    args = _inputs()
    want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(*args)
    da, ds = split_fp32_da(*args, slices)
    assert torch.isfinite(da).all() and torch.isfinite(ds).all()
    assert _rel(da, want_da) <= CE_BWD_TOL
    assert _rel(ds, want_ds) <= CE_BWD_TOL
    whole_da, _ = split_fp32_da(*args, 1)
    assert _rel(da, whole_da) <= 1e-6


@pytest.mark.parametrize("slices", SLICES)
def test_split_da_matches_jax_pallas(slices):
    """Every S within CE_BWD_TOL of the JAX ``_bwd_call`` through jax.vjp in
    interpret mode (g = 1 / M), dscale summed over the rows."""
    want_da, want_ds = _jax_grads()
    da, ds = split_fp32_da(*_inputs(), slices)
    assert _rel(da, want_da) <= CE_BWD_TOL
    np.testing.assert_allclose(ds.sum().item(), want_ds, rtol=CE_BWD_TOL)


def test_slice_rule_is_the_sources():
    """fp32_da_slices: two blocks an SM from the 32-row blocks, at most one
    tile a slice and 32 slices, the partials within their scratch, none
    empty; 1 wherever the row blocks fill the card. The kernel's grid, slice
    walk and second pass are as the emulation above takes them."""
    sms = 132
    assert fused_ce.fp32_da_slices(256, 1024, 512, sms) == 16
    assert fused_ce.fp32_da_slices(4096, 4096, 512, sms) == 2
    assert fused_ce.fp32_da_slices(M, N, D, sms) == 16
    for m in (4225, 8192, 32768):                        # more than 132 row blocks
        assert fused_ce.fp32_da_slices(m, 32768, 512, sms) == 1
    assert fused_ce.fp32_da_slices(32, 32768, 512, sms) == 32
    assert fused_ce.fp32_da_slices(256, 100, 512, sms) == 2   # two tiles of b
    for m, n, d in ((256, 1024, 512), (33, 129, 64), (4096, 4096, 768), (1024, 1024, 512),
                    (32, 32768, 768), (300, 3000, 700)):
        s = fused_ce.fp32_da_slices(m, n, d, sms)
        tiles = -(-n // STREAM)
        per = -(-tiles // s)
        assert 1 <= s <= min(32, tiles) and (s - 1) * per < tiles <= s * per, (m, n, d, s)
        assert s == 1 or 4 * s * m * (d + 1) <= fused_ce.FP32_DA_SCRATCH_BYTES
    assert 4 * 16 * 256 * 513 <= 8.1 * 2**20            # 256 x 1024, D 512: about 8 MiB
    src = SOURCE.read_text()
    for line in ("const int j_end = min(n, int(blockIdx.y + 1) * per * kStream);",
                 "for (int j0 = int(blockIdx.y) * per * kStream; j0 < j_end; j0 += kStream) {",
                 "store_owned<DPT>(out, da + size_t(blockIdx.y) * m * d, i0, m, d, "
                 "whole ? scale : 1.f);",
                 "const int per = (tiles + slices - 1) / slices;",
                 "slices = (tiles + per - 1) / per;",
                 "reduce_partials(part_da, da, slices, x.m * x.d, x.stream, "
                 "Finish{x.scale, nullptr, 1});",
                 "return reduce_partials(part_ds, dscale, slices, x.m, x.stream);"):
        assert line in src, line
    tile = (SOURCE.parent / "stream_tile.cuh").read_text()
    assert "constexpr int kStream = 64;" in tile and "constexpr int kRedGroups = 32;" in tile
    assert "if (f.scale != nullptr) total = *f.scale * total;" in tile
    assert fused_ce.FP32_MAX_DA_SLICES == 32 and fused_ce.FP32_STREAM_ROWS == STREAM


# --- the float32 forward and dB, split the same way ------------------------

FWD_ROWS = 64           # fused_ce.cu kFwdRows: rows of a a forward block owns
OWN = 32                # stream_tile.cuh kOwn: rows of b a dB block owns
CE_FWD_TOL = 1e-5       # chip_smoke.py CE_FWD_TOL
NEG = -1e30             # kNeg
WIDE_M, WIDE_N, WIDE_D, WIDE_OFFSET = 70, 300, 1000, 200   # two feature slices of 500


def butterfly_sum(lanes: torch.Tensor) -> torch.Tensor:
    """row_sum: the 16 lanes of a row [..., 16] added by the xor butterfly
    (8, 4, 2, 1); every lane ends with the same bits."""
    for o in (8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(LANES) ^ o]
    return lanes[..., 0]


def fwd_partials(raw, labels, scale, j_first: int, j_end: int):
    """One forward block's walk over the columns [j_first, j_end) of raw
    [M, N], tile by tile from max = -1e30: per row the running (max, sum) and
    the label logit, as the kernel's threads make them (thread tx holds
    columns j0 + tx + 16 c, c < 4)."""
    m, n = raw.shape
    mx, total = torch.full((m,), NEG), torch.zeros(m)
    zt = torch.zeros(m, LANES)
    lab = labels.long()[:, None, None]
    for j0 in range(j_first, j_end, STREAM):
        cols = (j0 + torch.arange(STREAM)).reshape(4, LANES)          # [c, tx]
        live = cols < n
        z = torch.where(live, scale * raw[:, cols.clamp(max=n - 1)], torch.tensor(NEG))
        zt = zt + torch.where(cols[None] == lab, z, torch.zeros(())).sum(dim=1)
        mnew = torch.maximum(mx, z.amax(dim=(1, 2)))
        part = torch.zeros(m, LANES)
        for c in range(4):
            part = part + torch.exp(z[:, c] - mnew[:, None])
        total = total * torch.exp(mx - mnew) + butterfly_sum(part)
        mx = mnew
    return mx, total, butterfly_sum(zt)


def walk_fp32_fwd(a, b, labels, scale):
    """The unsplit forward: every tile of b in order; (loss, lse)."""
    mx, total, label_logit = fwd_partials(fma_products(a, b.T), labels, scale, 0, b.shape[0])
    lse = mx + torch.log(total)
    return lse - label_logit, lse


def split_fp32_fwd(a, b, labels, scale, slices: int):
    """The split forward: slice s walks tiles [s per, (s + 1) per) of b;
    with one slice the block stores (loss, lse) itself, with more the merge
    takes the slices' pairs in order from slice 0's (merge_lse) and adds
    their label logits in order."""
    n = b.shape[0]
    tiles = -(-n // STREAM)
    per = -(-tiles // slices)
    raw = fma_products(a, b.T)
    parts = [fwd_partials(raw, labels, scale, j0, min(n, j0 + per * STREAM))
             for j0 in range(0, n, per * STREAM)]
    if len(parts) == 1:
        mx, total, label_logit = parts[0]
        lse = mx + torch.log(total)
        return lse - label_logit, lse
    mm, ss, zz = parts[0]
    for m2, s2, z2 in parts[1:]:
        top = torch.maximum(mm, m2)
        ss = ss * torch.exp(mm - top) + s2 * torch.exp(m2 - top)
        mm, zz = top, zz + z2
    lse = mm + torch.log(ss)
    return lse - zz, lse


def walk_fp32_db(a, b, labels, scale, lse, g):
    """The unsplit dB: every tile of a in order, each element of dB one fmaf
    chain over the rows of a; times scale at the end."""
    _, dz = raw_and_dz(a, b, labels, scale, lse, g)
    out = torch.zeros(b.shape)
    for i in range(a.shape[0]):
        out = (torch.outer(dz[i].double(), a[i].double()) + out.double()).float()
    return scale * out


def split_fp32_db(a, b, labels, scale, lse, g, slices: int):
    """The split dB: slice s walks tiles [s per, (s + 1) per) of a from
    zero; the partials added in slice order from zero (reduce_partials), times
    scale once after the sum."""
    m = a.shape[0]
    tiles = -(-m // STREAM)
    per = -(-tiles // slices)
    _, dz = raw_and_dz(a, b, labels, scale, lse, g)
    db = torch.zeros(b.shape)
    for i0 in range(0, m, per * STREAM):
        rows = slice(i0, min(m, i0 + per * STREAM))
        db = db + fma_products(dz[rows].T, a[rows])
    return scale * db


def _unit(got, want):
    return ((got - want).abs() / (1 + want.abs())).max().item()


def test_one_slice_is_the_unsplit_forward_and_db():
    """S = 1: the forward's loss and lse and dB bit for bit the unsplit walks'."""
    a, b, labels, s, lse, g = _inputs()
    for got, want in zip(split_fp32_fwd(a, b, labels, s, 1), walk_fp32_fwd(a, b, labels, s)):
        assert torch.equal(got, want)
    assert torch.equal(split_fp32_db(a, b, labels, s, lse, g, 1),
                       walk_fp32_db(a, b, labels, s, lse, g))


@pytest.mark.parametrize("slices", SLICES)
def test_split_forward_matches_plain_and_jax(slices):
    """Every S: loss rows and lse within CE_FWD_TOL of ``fused_ce_fwd_plain``
    (1e-5 of 1 + |value|), the mean loss of the JAX ``_fwd_call`` (interpret
    mode) too; the split moves only the order of the merge."""
    a, b, labels, s, want_lse, _ = _inputs()
    want_loss, _ = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    loss, lse = split_fp32_fwd(a, b, labels, s, slices)
    assert torch.isfinite(loss).all() and torch.isfinite(lse).all()
    assert _unit(loss, want_loss) <= CE_FWD_TOL and _unit(lse, want_lse) <= CE_FWD_TOL
    jax_loss = _jax_vjp()[0]
    assert abs(loss.mean().item() - jax_loss) <= CE_FWD_TOL * (1 + abs(jax_loss))


@pytest.mark.parametrize("slices", SLICES)
def test_split_db_matches_plain_and_jax(slices):
    """Every S: dB within CE_BWD_TOL of ``fused_ce_bwd_db_plain`` and of the
    JAX ``_bwd_call`` through jax.vjp (interpret mode, g = 1 / M)."""
    args = _inputs()
    db = split_fp32_db(*args, slices)
    assert torch.isfinite(db).all()
    assert _rel(db, fused_ce.fused_ce_bwd_db_plain(*args)) <= CE_BWD_TOL
    assert _rel(db, _jax_vjp()[2]) <= CE_BWD_TOL
    assert _rel(db, split_fp32_db(*args, 1)) <= 1e-6


def test_fwd_and_db_slice_rules_are_the_sources():
    """fp32_fwd_slices and fp32_db_slices: fp32_da_slices' rule from the
    forward's 64-row and dB's 32-row blocks (16 and 4 at the local-loss
    256 x 1024), 1 where the row blocks fill 132 SMs, none empty; the grids,
    walks and second passes as the emulation above takes them."""
    sms = 132
    assert fused_ce.fp32_fwd_slices(256, 1024, sms) == 16
    assert fused_ce.fp32_fwd_slices(4096, 4096, sms) == 4
    assert fused_ce.fp32_fwd_slices(M, N, sms) == 16
    assert fused_ce.fp32_db_slices(256, 1024, 512, sms) == 4
    assert fused_ce.fp32_db_slices(4096, 4096, 512, sms) == 2
    assert fused_ce.fp32_db_slices(M, N, D, sms) == 2                 # two tiles of a
    for rows in (64 * 132 + 1, 16384, 32768):                          # more than 132 blocks
        assert fused_ce.fp32_fwd_slices(rows, 32768, sms) == 1
    for rows in (32 * 132 + 1, 8192, 32768):
        assert fused_ce.fp32_db_slices(32768, rows, 512, sms) == 1
    for m, n, d in ((256, 1024, 512), (33, 129, 64), (4096, 4096, 768), (1024, 300, 1000),
                    (32, 32768, 768), (300, 3000, 700)):
        for s, tiles in ((fused_ce.fp32_fwd_slices(m, n, sms), -(-n // STREAM)),
                         (fused_ce.fp32_db_slices(m, n, d, sms), -(-m // STREAM))):
            per = -(-tiles // s)
            assert 1 <= s <= min(32, tiles) and (s - 1) * per < tiles <= s * per, (m, n, d, s)
    assert fused_ce.FP32_FWD_ROWS == FWD_ROWS and fused_ce.FP32_OWN_ROWS == OWN
    src = SOURCE.read_text()
    for line in ("constexpr int kFwdRows = kTY * 4;",
                 "const int j_end = min(n, int(blockIdx.y + 1) * per * BN);",
                 "const int i_end = min(m, int(blockIdx.y + 1) * per * kStream);",
                 "merge_lse(mm, ss, part[size_t(s) * m + i], part[plane + size_t(s) * m + i]);",
                 "zz += part[2 * plane + size_t(s) * m + i];",
                 "store_owned<DPT>(out, db + size_t(blockIdx.y) * n * d, j0, n, d, "
                 "gridDim.y == 1 ? scale : 1.f);",
                 "return reduce_partials(part_db, db, slices, x.n * x.d, x.stream, "
                 "Finish{x.scale, nullptr, 1});",
                 "const int tiles = (x.m + kStream - 1) / kStream;"):
        assert line in src, line


# --- the shared tiles at the thread level ----------------------------------

THREADS = 256           # kThreads: 16 x 16
KC = 32                 # stream_tile.cuh kKC: features a chunk of raw_tile
KS = KC + 4             # kKS: its row stride
ACC_ROWS = 8            # kAccRows: output rows a thread holds
ACC_COLS = 64           # kAccCols: float4 columns of a row the threads cover
SLICE_D = 768           # kSliceD
ZS = OWN + 4            # kZS: row stride of the dz tile
TILE_SOURCE = SOURCE.parent / "stream_tile.cuh"


def fmaf(x, y, acc):
    return (x.double() * y.double() + acc.double()).float()


def stage_rows(src, r0, rows, f0, f1, n_rows, width, rs, vec):
    """stream_tile.cuh stage_rows into a flat buffer of n_rows x rs floats:
    thread t's piece i is idx = t + 256 i, row idx / (width / 4), features
    4 (idx % (width / 4)) .. + 3; zeros past `rows` and from f1 on (a whole
    16-byte piece when vec). Floats no piece writes stay NaN, so a read of
    one shows in the result."""
    buf = torch.full((n_rows * rs,), float("nan"))
    q = width // 4
    assert n_rows * q % THREADS == 0
    d = src.shape[1]
    for i in range(n_rows * q // THREADS):
        idx = torch.arange(THREADS) + THREADS * i
        r, f = idx // q, (idx % q) * 4
        for e in range(4):
            live = (r0 + r < rows) & ((f0 + f < f1) if vec else (f0 + f + e < f1))
            val = src[(r0 + r).clamp(max=src.shape[0] - 1), (f0 + f + e).clamp(max=d - 1)]
            buf[r * rs + f + e] = torch.where(live, val, torch.zeros(()))
    return buf


def new_raw_tile(a, b, i0, j0, rpt, cpt, vec):
    """raw_tile: chunks of 32 features staged row-major (stride 36), thread
    (tx, ty) reading float4 of rows ty + 16 r of a and tx + 16 c of b.
    Returns acc [thread, r, c]."""
    m, d = a.shape
    n = b.shape[0]
    tx, ty = torch.arange(THREADS) % LANES, torch.arange(THREADS) // LANES
    acc = torch.zeros(THREADS, rpt, cpt)
    arow = ty[:, None] + LANES * torch.arange(rpt)[None]
    bcol = tx[:, None] + LANES * torch.arange(cpt)[None]
    for k0 in range(0, d, KC):
        sa = stage_rows(a, i0, m, k0, min(d, k0 + KC), LANES * rpt, KC, KS, vec)
        sb = stage_rows(b, j0, n, k0, min(d, k0 + KC), LANES * cpt, KC, KS, vec)
        for k in range(0, KC, 4):
            for e in range(4):            # a float4's x, y, z, w in order
                av, bv = sa[arow * KS + k + e], sb[bcol * KS + k + e]
                acc = fmaf(av[:, :, None], bv[:, None, :], acc)
    return acc


def old_raw_tile(a, b, i0, j0, rpt, cpt):
    """The scalar raw_tile: chunks of 32 features staged feature-major
    (as[dd][row], stride rows + 1), read one scalar at a time."""
    m, d = a.shape
    n = b.shape[0]
    tx, ty = torch.arange(THREADS) % LANES, torch.arange(THREADS) // LANES
    acc = torch.zeros(THREADS, rpt, cpt)
    arow = ty[:, None] + LANES * torch.arange(rpt)[None]
    bcol = tx[:, None] + LANES * torch.arange(cpt)[None]

    def staged(x, r0, rows, k0, width):
        out = torch.zeros(KC, width + 1)
        for dd in range(KC):
            for r in range(width):
                if r0 + r < rows and k0 + dd < d:
                    out[dd, r] = x[r0 + r, k0 + dd]
        return out

    for k0 in range(0, d, KC):
        sa, sb = staged(a, i0, m, k0, LANES * rpt), staged(b, j0, n, k0, LANES * cpt)
        for dd in range(KC):
            acc = fmaf(sa[dd][arow][:, :, None], sb[dd][bcol][:, None, :], acc)
    return acc


def new_accumulate(z, rows, count, f0, f1, dpt, vec):
    """accumulate: dz [32 own, 64 streamed] in zt [s][own] (stride 36), the
    streamed rows staged a few at a time (width 64 DPT), thread t holding
    rows 8 (t / 64) + r and features f0 + 4 (t % 64 + 64 q) + e. Returns
    out [own row, feature - f0] over the slice."""
    stage = 8 if dpt <= 8 else 4
    width = ACC_COLS * dpt
    zt = torch.full((64 * ZS,), float("nan"))
    for s in range(count):
        zt[s * ZS + torch.arange(OWN)] = z[:, s]
    t = torch.arange(THREADS)
    row0, col0 = ACC_ROWS * (t // 64), t % 64
    out = torch.zeros(THREADS, ACC_ROWS, dpt)
    feats = torch.stack([4 * (col0 + ACC_COLS * (c // 4)) + c % 4 for c in range(dpt)], 1)
    for c0 in range(0, count, stage):
        st = stage_rows(rows, c0, count, f0, f1, stage, width, width, vec)
        for s in range(min(stage, count - c0)):
            zr = zt[(c0 + s) * ZS + row0[:, None] + torch.arange(ACC_ROWS)[None]]
            v = st[s * width + feats]
            out = fmaf(zr[:, :, None], v[:, None, :], out)
    got = torch.full((OWN, f1 - f0), float("nan"))
    for r in range(ACC_ROWS):
        for c in range(dpt):
            keep = feats[:, c] < f1 - f0
            got[row0[keep] + r, feats[keep, c]] = out[keep, r, c]
    return got


def old_accumulate(z, rows, count, d):
    """The scalar accumulate: warp w owns rows 4 w .. 4 w + 3 and lanes
    l + 32 c of every feature, reading the streamed rows from device memory."""
    out = torch.zeros(OWN, d)
    for s in range(count):
        out = fmaf(z[:, s][:, None], rows[s][None, :], out)
    return out


def _tile_inputs(d, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((70, d)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((100, d)).astype(np.float32))
    return a, b


@pytest.mark.parametrize("d,vec", [(36, True), (40, True), (40, False)])
def test_new_tiles_give_the_old_walks_bits(d, vec):
    """raw_tile and accumulate as rebuilt for float4 reads from staged rows:
    every element equals the scalar walk bit for bit (ragged D of 36 and 40,
    the 16-byte and the 4-byte copies, a ragged last tile of 40 rows and a
    block past the end of M), and no unwritten padding is ever read."""
    a, b = _tile_inputs(d, d)
    for rpt, cpt, i0, j0 in ((4, 4, 64, 64), (2, 4, 64, 0), (4, 2, 0, 96)):   # fwd, dA, dB
        new = new_raw_tile(a, b, i0, j0, rpt, cpt, vec)
        assert torch.isfinite(new).all()
        assert torch.equal(new, old_raw_tile(a, b, i0, j0, rpt, cpt))
    rng = np.random.default_rng(d + 1)
    z = torch.from_numpy(rng.standard_normal((OWN, 64)).astype(np.float32))
    count = 40
    z[:, count:] = 0.0
    got = new_accumulate(z, b[60:100], count, 0, d, 4, vec)
    assert torch.equal(got, old_accumulate(z, b[60:100], count, d))


def test_feature_slices_give_the_old_walks_bits():
    """Rows past kSliceD take feature slices (slice_width: 2 x 500 at
    D = 1000); each slice's accumulate, DPT = 8, equals the scalar walk on
    its features bit for bit."""
    d = 1000
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((OWN, 64)).astype(np.float32))
    want = old_accumulate(z, rows, 64, d)
    slices = -(-d // SLICE_D)
    width = (-(-d // slices) + 3) & ~3
    assert (slices, width) == (2, 500)
    for f0 in range(0, d, width):
        f1 = min(d, f0 + width)
        assert torch.equal(new_accumulate(z, rows, 64, f0, f1, 8, True), want[:, f0:f1])


@functools.lru_cache(maxsize=None)
def _wide_inputs():
    """D = 1000 (two feature slices of dA and dB), 70 x 300, labels 200..."""
    rng = np.random.default_rng(23)

    def unit(rows):
        x = rng.standard_normal((rows, WIDE_D))
        return torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))

    a, b = unit(WIDE_M), unit(WIDE_N)
    labels = torch.arange(WIDE_M, dtype=torch.int32) + WIDE_OFFSET
    s = torch.tensor(SCALE, dtype=torch.float32)
    g = torch.full((WIDE_M,), 1.0 / WIDE_M)
    _, lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    return a, b, labels, s, lse, g


def test_wide_rows_through_feature_slices_match_plain_and_jax():
    """fp32 at D = 1000: the forward (it streams D), dA and dB in two
    feature slices (each slice's rows from the same raw, its own features),
    against the plain versions and the JAX package's kernels in interpret
    mode."""
    a, b, labels, s, lse, g = _wide_inputs()
    raw, dz = raw_and_dz(a, b, labels, s, lse, g)
    width = (-(-WIDE_D // 2) + 3) & ~3
    da = torch.cat([s * fma_products(dz, b[:, f0:f0 + width]) for f0 in range(0, WIDE_D, width)], 1)
    db = torch.cat([s * fma_products(dz.T, a[:, f0:f0 + width])
                    for f0 in range(0, WIDE_D, width)], 1)
    ds = lane_dscale(dz, raw, range(WIDE_N))
    loss, got_lse = split_fp32_fwd(a, b, labels, s, fused_ce.fp32_fwd_slices(WIDE_M, WIDE_N, 132))
    want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    assert _unit(loss, want_loss) <= CE_FWD_TOL and _unit(got_lse, want_lse) <= CE_FWD_TOL
    want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, lse, g)
    want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, lse, g)
    assert max(_rel(da, want_da), _rel(ds, want_ds), _rel(db, want_db)) <= CE_BWD_TOL
    jax_loss, jax_da, jax_db, jax_ds = _jax_vjp("wide")
    assert abs(loss.mean().item() - jax_loss) <= CE_FWD_TOL * (1 + abs(jax_loss))
    assert _rel(da, jax_da) <= CE_BWD_TOL and _rel(db, jax_db) <= CE_BWD_TOL
    np.testing.assert_allclose(ds.sum().item(), jax_ds, rtol=CE_BWD_TOL)


def test_tile_strides_spread_the_banks_and_fit():
    """raw_tile's stride of 36 floats starts every row on 16 bytes and puts 8
    consecutive rows in 8 bank groups (a half-warp's float4 reads of b's 16
    rows: two wavefronts); the dz tile's stride keeps a thread's 8 rows on 16
    bytes; accumulate's lanes read 512 contiguous bytes. Every block's static
    shared memory stays under 48 KB and two fit an SM; the constants are the
    source's."""
    assert KS * 4 % 16 == 0 and len({(r * KS * 4 // 16) % 8 for r in range(8)}) == 8
    assert ZS * 4 % 16 == 0 and ACC_ROWS * 4 % 16 == 0
    for dpt in (4, 8, 12):
        width = ACC_COLS * dpt
        lanes = [4 * lane * 4 for lane in range(32)]            # bytes of one row, one warp
        assert lanes == list(range(0, 512, 16)) and width * 4 % 16 == 0
        stage = 8 if dpt <= 8 else 4
        for rpt, cpt in ((2, 4), (4, 2)):
            raw = 2 * LANES * (rpt + cpt) * KS * 4
            total = max(raw, 2 * stage * width * 4) + 64 * ZS * 4
            assert total <= 48 * 1024 and 2 * (total + 1024) <= 233472, (dpt, total)
        assert (stage * width // 4) % THREADS == 0
    assert 2 * LANES * 8 * KS * 4 <= 48 * 1024                   # the forward: 36,864 bytes
    tile = TILE_SOURCE.read_text()
    for line in ("constexpr int kKC = 32;", "constexpr int kKS = kKC + 4;",
                 "constexpr int kAccRows = 8;", "constexpr int kAccCols = 64;",
                 "constexpr int kSliceD = 768;", "constexpr int kZS = kOwn + 4;",
                 "static constexpr int kRows = DPT <= 8 ? 8 : 4;",
                 "return ((d + slices - 1) / slices + 3) & ~3;",
                 "return kAccRows * (threadIdx.x >> 6);", "return threadIdx.x & 63;"):
        assert line in tile, line
    src = SOURCE.read_text()
    assert "return w <= 256 ? 4 : w <= 512 ? 8 : 12;" in src
