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
def _jax_grads():
    """dA and dscale of the JAX package's Pallas backward (interpret mode)
    through jax.vjp of the mean loss."""
    a, b, labels, _, _, _ = _inputs()

    def loss(a_, s_):
        return jax_fused_ce(a_, jnp.asarray(b.numpy()), jnp.asarray(labels.numpy()), s_,
                            block_m=40, block_n=512, interpret=True)

    _, vjp = jax.vjp(loss, jnp.asarray(a.numpy()), jnp.float32(SCALE))
    da, ds = vjp(jnp.float32(1.0))
    return torch.from_numpy(np.array(da)), float(ds)


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
