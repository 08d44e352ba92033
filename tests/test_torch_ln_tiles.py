"""The LayerNorm kernels' lane mapping and reductions, emulated on the CPU.

``csrc/fused_ln.cu`` computes y (TPU kernel #7) and dx, dgamma and dbeta
(#8) with one warp a row: a lane holds 16-byte vectors (V = 8 bf16 or 4 fp32 values),
vector lane + 32 c covering elements (lane + 32 c) V .. + V - 1, in a bucket
of PE values a lane (32 PE >= D). A lane sums each vector's values in order
from zero, then its vectors in order, and the warp adds the 32 lane sums by
an xor butterfly (offsets 16, 8, 4, 2, 1); each statistic is that sum times
one fp32 reciprocal of D: the mean, then the centred squares (fma), then
m1 = mean(dy gamma) and m2 = mean(dy gamma xhat) (fma), and
dx = fma(dy gamma, rstd, fma(xhat, -rstd m2, -rstd m1)). Warp w of block b
walks rows b * 8 + w, + 8 blocks, ... and sums dy xhat (fma) and dy over
them in registers; the block's eight warps add up in warp order, each block
writes one partial row, and a second kernel adds the partial rows
(``stream_tile.cuh`` ``reduce_partials``, shared with the MLP): past
kRedGroups partial rows, group r sums partial rows r, r + kRedGroups, ...
in order, then the groups add up in order; at kRedGroups or fewer one
thread a column sums them in order, which is the same order. The forward
takes its statistics through the same helper (``center_row``), so its mu
and rstd are the backward's bit for bit, and writes y = fma(xc rstd,
gamma, beta) rounded once to x's type; a row whose width is not a multiple
of V takes the same walk with scalar loads. A CUDA kernel cannot run here, so this
file writes the same mapping, orders and fmas in plain PyTorch (an fma is a
float64 product and sum rounded once to fp32) and holds it against the
unchanged plain versions ``layernorm_plain`` / ``layernorm_bwd_plain``
under ``chip_smoke.py``'s ``FUSED_FWD_TOL`` / ``FUSED_BWD_TOL`` and against
the JAX package's Pallas kernels in interpret mode, and pins the source's
constants. The emulation is used by nothing in the package.
"""
from __future__ import annotations

import importlib.util
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.ops import fused_ln as jax_ln
from colxlip_tpu_torch.ops import fused_ln

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = REPO / "colxlip_tpu_torch" / "csrc" / "fused_ln.cu"
REDUCE_SOURCE = REPO / "colxlip_tpu_torch" / "csrc" / "stream_tile.cuh"   # reduce_partials
WARPS = 8               # kWarps: rows a block has in flight, one a warp
RED_GROUPS = 32         # kRedGroups: row groups of the partial-row reduce (at > 32 rows)
MAX_D = 1024            # kMaxD
BUCKETS = (256, 512, 768, 1024)   # widths of the buckets PE = 8, 16, 24, 32
RED_BYTES = 2 * MAX_D * 4   # the block's dgamma / dbeta row, gamma's staging before it
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}   # chip_smoke.FUSED_BWD_TOL
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}   # chip_smoke.FUSED_FWD_TOL
CASES = [
    # leading shape, D, blocks (None: as the wrapper picks)
    ((4, 197), 768, None),       # the vision tower's width
    ((3, 77), 512, None),        # the text tower and the token heads
    ((9,), 1024, None),          # ViT-L-14's width, the widest bucket
    ((5, 3), 40, None),          # D not a multiple of 32: one vector a lane, most lanes dead
    ((197 * 3,), 512, 3),        # ragged rows over 3 blocks: 24-25 rows a warp
    ((7, 11), 36, 2),            # bf16: D not a multiple of 8 (the scalar loads)
]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The emulations are many small tensor operations: one intra-op thread,
    so that the suite's parallel workers do not oversubscribe the cores (six
    workers of eight threads each made this module several times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lane_elems(d: int) -> int:
    """PE: values a lane holds, the bucket of d."""
    return 8 * (next(i for i, w in enumerate(BUCKETS) if d <= w) + 1)


def vec(dtype) -> int:
    return 16 // torch.tensor([], dtype=dtype).element_size()


def _warp_sum(s: torch.Tensor) -> torch.Tensor:
    """common.cuh warp_sum over the last axis (32 lanes): the xor butterfly;
    every lane ends with the same value, lane 0's is returned."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ o]
    return s[..., 0]


def _fma(a, b, c):
    """fmaf: a * b + c rounded once to fp32."""
    return (a.double() * b.double() + c.double()).float()


def _lane_sum(t: torch.Tensor, v: int, of=None) -> torch.Tensor:
    """A lane's sum of t [..., PE] (or of fma(t, of, .)): each vector's V
    values in order from zero, then the vectors in order (``in_order``)."""
    parts = []
    for c in range(t.shape[-1] // v):
        p = torch.zeros(t.shape[:-1])
        for j in range(c * v, (c + 1) * v):
            p = p + t[..., j] if of is None else _fma(t[..., j], of[..., j], p)
        parts.append(p)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def lane_layout(d: int, dtype):
    """(V, PE, col, live, at): the element each lane holds, col [32, PE] in
    the kernels' (c, j) order, live = col < d, at = col clamped into the row."""
    v, pe = vec(dtype), lane_elems(d)
    col = ((torch.arange(32)[:, None, None] + 32 * torch.arange(pe // v)[None, :, None]) * v
           + torch.arange(v)[None, None, :]).reshape(32, pe)
    return v, pe, col, col < d, col.clamp(max=d - 1)


def center_row(xv, live, v, d, eps):
    """fused_ln.cu center_row on rows xv [rows, 32, PE] (zeros past d): the
    lane sums, the butterfly, one reciprocal of D. (x - mu, mu, rstd)."""
    inv_d = torch.tensor(1.0 / d, dtype=torch.float32)
    mu = _warp_sum(_lane_sum(xv, v)) * inv_d
    xc = torch.where(live, xv - mu[:, None, None], torch.zeros(()))
    rstd = torch.rsqrt(_warp_sum(_lane_sum(xc, v, of=xc)) * inv_d + eps)
    return xc, mu, rstd


def tiled_ln_forward(x, gamma, beta, eps=1e-5, vectors=None):
    """The forward kernel's algorithm on x [rows, D], gamma and beta [D]
    fp32: (y in x's dtype, mu, rstd). ``vectors`` is the kernel's VEC (16-byte
    loads, D a multiple of V; None: as the launcher picks for aligned rows);
    the scalar walk holds the same lanes in the same order."""
    rows, d = x.shape
    v, pe, col, live, at = lane_layout(d, x.dtype)
    if vectors is None:
        vectors = d % v == 0
    assert not vectors or d % v == 0, "16-byte loads need D a multiple of V"
    zero = torch.zeros(())
    xv = torch.where(live, x.float()[:, at], zero)           # [rows, 32, PE]
    gm = torch.where(live, gamma.float()[at], zero)
    bt = torch.where(live, beta.float()[at], zero)
    xc, mu, rstd = center_row(xv, live, v, d, eps)
    out = _fma(xc * rstd[:, None, None], gm.expand_as(xc), bt.expand_as(xc))
    y = torch.zeros(rows, d)
    y[:, col[live]] = out[:, live]
    return y.to(x.dtype), mu, rstd


def tiled_ln_backward(x, gamma, dy, eps=1e-5, blocks=None, with_stats=False):
    """The kernel's algorithm on x, dy [rows, D], gamma [D] fp32: (dx in x's
    dtype, dgamma fp32, dbeta fp32), and (mu, rstd) with ``with_stats``."""
    rows, d = x.shape
    v, pe, col, live, at = lane_layout(d, x.dtype)
    if blocks is None:
        blocks = min(-(-rows // fused_ln._BWD_ROWS_PER_BLOCK), fused_ln._BWD_BLOCKS)
    zero = torch.zeros(())
    xv = torch.where(live, x.float()[:, at], zero)           # [rows, 32, PE]
    go = torch.where(live, dy.float()[:, at], zero)
    gm = torch.where(live, gamma.float()[at], zero)

    inv_d = torch.tensor(1.0 / d, dtype=torch.float32)
    xc, mu, rstd = center_row(xv, live, v, d, eps)
    xhat = xc * rstd[:, None, None]
    gdo = go * gm
    m1 = _warp_sum(_lane_sum(gdo, v)) * inv_d
    m2 = _warp_sum(_lane_sum(gdo, v, of=xhat)) * inv_d
    a0, a1 = (-rstd * m1)[:, None, None], (-rstd * m2)[:, None, None]
    out = _fma(gdo, rstd[:, None, None].expand_as(gdo), _fma(xhat, a1.expand_as(xhat),
                                                             a0.expand_as(xhat)))
    dx = torch.zeros(rows, d)
    dx[:, col[live]] = out[:, live]

    # dgamma / dbeta: each warp over its rows in order, then the block's
    # warps in order, then the partial rows in the reduce's order
    warps = blocks * WARPS
    dg = torch.zeros(warps, 32, pe)
    db = torch.zeros(warps, 32, pe)
    for k in range(-(-rows // warps)):
        r = torch.arange(warps) + k * warps
        ok = (r < rows)[:, None, None]
        r = r.clamp(max=rows - 1)
        dg = torch.where(ok, _fma(go[r], xhat[r], dg), dg)
        db = db + torch.where(ok, go[r], zero)
    red = torch.zeros(2, blocks, 32, pe)
    for w in range(WARPS):
        red = red + torch.stack((dg, db)).reshape(2, blocks, WARPS, 32, pe)[:, :, w]
    partials = torch.zeros(blocks, 2, d)
    partials[:, :, col[live]] = red[:, :, live].transpose(0, 1)
    total = reduce_partials(partials.reshape(blocks, 2 * d))
    if with_stats:
        return dx.to(x.dtype), total[:d], total[d:], mu, rstd
    return dx.to(x.dtype), total[:d], total[d:]


def reduce_partials(partials: torch.Tensor, sliced: bool | None = None) -> torch.Tensor:
    """stream_tile.cuh reduce_partials on partials [splits, n] fp32: past
    kRedGroups rows (or where ``sliced`` says) row group g adds rows g,
    g + kRedGroups, ... in order and the groups add up in order; else one
    sum over the rows in order."""
    splits, n = partials.shape
    if sliced is None:
        sliced = splits > RED_GROUPS
    if not sliced:
        total = torch.zeros(n)
        for s in range(splits):
            total = total + partials[s]
        return total
    acc = []
    for g in range(RED_GROUPS):
        a = torch.zeros(n)
        for s in range(g, splits, RED_GROUPS):
            a = a + partials[s]
        acc.append(a)
    total = acc[0]
    for a in acc[1:]:
        total = total + a
    return total


def _inputs(lead, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((math.prod(lead), d)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((math.prod(lead), d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(scale),
            torch.from_numpy(dy).to(dtype))


def _bias(d, seed=0):
    return torch.from_numpy((0.1 * np.random.default_rng(seed + 100).standard_normal(d))
                            .astype(np.float32))


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def test_constants_are_the_kernels_own():
    """The emulation's warps, reduce groups and buckets are the source's, the
    wrapper's block rows are its warps, and the bars are chip_smoke.py's."""
    src, reduce_src = SOURCE.read_text(), REDUCE_SOURCE.read_text()
    for name, value in (("kWarps", WARPS), ("kMaxD", MAX_D)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(rf"constexpr int kRedGroups = {RED_GROUPS};", reduce_src)
    assert "colxlip::stream_tile::reduce_partials(part, " in src
    assert [int(w) for w in re.findall(r"if \(a\.d <= (\d+)\) return launch_bwd<T, ", src)] == \
        list(BUCKETS[:-1])
    assert [int(p) for p in re.findall(r"return launch_bwd<T, (\d+)>", src)] == [8, 16, 24, 32]
    assert [int(w) for w in re.findall(r"if \(a\.d <= (\d+)\) return launch_fwd<T, ", src)] == \
        list(BUCKETS[:-1])
    assert [int(p) for p in re.findall(r"return launch_fwd<T, (\d+)>", src)] == [8, 16, 24, 32]
    # one statistics helper, called by both kernels; the forward's output fma
    assert src.count("center_row<T, PE, VEC>(xv, d, inv_d, eps)") == 2
    assert src.count("load_row<T, PE, VEC>(") == 2
    assert "out[j] = fmaf(__fmul_rn(xv[c * V + j], rstd), g[j], b[j]);" in src
    assert "ln_fwd_kernel<T, PE, true><<<fwd_blocks<T, PE, true>(a.rows)" in src
    assert "static constexpr int V = 16 / int(sizeof(T));" in src
    assert "__launch_bounds__(kThreads, sizeof(T) == 2 && PE <= 24 ? 2 : 1)" in src
    assert "const float inv_d = 1.f / float(d);" in src
    assert "out[j] = fmaf(__fmul_rn(o[j], gm[j]), rstd, fmaf(xv[c * V + j], a1, a0));" in src
    assert fused_ln._BWD_ROWS_PER_BLOCK == WARPS and fused_ln.MAX_FEATURES == MAX_D
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {getattr(torch, k): v for k, v in smoke.FUSED_BWD_TOL.items()} == TOL
    assert {getattr(torch, k): v for k, v in smoke.FUSED_FWD_TOL.items()} == FWD_TOL


@pytest.mark.parametrize("pe", [8, 16, 24, 32])
def test_gamma_staging_fits_in_the_reduce_row(pe):
    """gamma, staged lane-major as PE / 4 float4 a lane, fits in the block's
    dgamma / dbeta row that the warps add into after the last row."""
    assert 32 * (pe // 4) * 16 <= RED_BYTES
    for dtype in (torch.float32, torch.bfloat16):
        assert (pe // vec(dtype)) * vec(dtype) == pe


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,d,blocks", CASES)
def test_tiled_backward_matches_plain(lead, d, blocks, dtype):
    x, scale, dy = _inputs(lead, d, dtype)
    got = tiled_ln_backward(x, scale, dy, blocks=blocks)
    want = fused_ln.layernorm_bwd_plain(x, scale, dy)
    for g, w, dt in zip(got, want, (dtype, torch.float32, torch.float32)):
        assert g.dtype == dt and g.shape == w.shape
        assert _rel(g, w) <= TOL[dtype]


@pytest.mark.parametrize("lead,d", [((3, 77), 512), ((2, 5), 768), ((4,), 1024)])
def test_tiled_backward_matches_jax_pallas(lead, d):
    """dx, dscale and dbias against the JAX package's Pallas backward
    (interpret mode) through jax.vjp, fp32."""
    x, scale, dy = _inputs(lead, d, torch.float32, seed=3)
    bias = np.zeros(d, np.float32)
    _, vjp = jax.vjp(lambda x_, s_, b_: jax_ln.fused_layernorm(x_, s_, b_, 1e-5, 0, True),
                     jnp.asarray(x.numpy()), jnp.asarray(scale.numpy()), jnp.asarray(bias))
    want = [torch.from_numpy(np.array(t)) for t in vjp(jnp.asarray(dy.numpy()))]
    got = tiled_ln_backward(x, scale, dy)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL[torch.float32]


def test_every_element_is_one_lanes_once():
    """The lane mapping covers each of D's elements exactly once, in every
    bucket, for both vector widths."""
    for d in (1, 36, 40, 255, 256, 257, 512, 768, 1000, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            v, pe = vec(dtype), lane_elems(d)
            col = ((torch.arange(32)[:, None, None] + 32 * torch.arange(pe // v)[None, :, None])
                   * v + torch.arange(v)[None, None, :]).reshape(-1)
            assert sorted(col[col < d].tolist()) == list(range(d)), (d, dtype)


@pytest.mark.parametrize("splits", [1, 3, 31, 32])
def test_reduce_orders_agree_where_the_helper_may_pick_either(splits):
    """At kRedGroups partial rows or fewer the column-sliced order and the
    serial order give the same bits, so where reduce_partials switches
    between them moves time and no result; past it they are two orders."""
    gen = torch.Generator().manual_seed(splits)
    partials = torch.randn(splits, 100, generator=gen) * 10 ** torch.randn(splits, 1,
                                                                            generator=gen)
    assert torch.equal(reduce_partials(partials, sliced=True),
                       reduce_partials(partials, sliced=False))
    assert "if (splits <= kRedGroups)" in REDUCE_SOURCE.read_text()


FWD_CASES = [
    # leading shape, D
    ((4, 197), 768),       # the vision tower's width
    ((3, 77), 512),        # the text tower and the token heads
    ((9,), 1024),          # ViT-L-14's width, the widest bucket
    ((5, 3), 40),          # one vector a lane, most lanes dead (bf16: scalar loads)
    ((7, 11), 36),         # bf16 and fp32: D not a multiple of V, the scalar walk
    ((197 * 3,), 256),     # the narrowest bucket, full
]


def _fwd_rel(got, want):
    """max |got - want| / max(1, max |want|): FUSED_FWD_TOL's measure."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,d", FWD_CASES)
def test_tiled_forward_matches_plain(lead, d, dtype):
    x, scale, _ = _inputs(lead, d, dtype, seed=1)
    bias = _bias(d, seed=1)
    y, mu, rstd = tiled_ln_forward(x, scale, bias)
    want = fused_ln.layernorm_plain(x, scale, bias)
    assert y.dtype == dtype and y.shape == want.shape
    assert _fwd_rel(y, want) <= FWD_TOL[dtype]
    assert mu.shape == rstd.shape == (x.shape[0],)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,d", [((3, 77), 512), ((2, 5), 1024), ((7, 11), 36)])
def test_tiled_forward_matches_jax_pallas(lead, d, dtype):
    """y against the JAX package's Pallas forward in interpret mode, as
    tests/test_fused_ln.py runs it, in both stream dtypes."""
    x, scale, _ = _inputs(lead, d, dtype, seed=4)
    bias = _bias(d, seed=4)
    as_jax = jnp.asarray(x.float().numpy(), jnp.float32 if dtype == torch.float32
                         else jnp.bfloat16)
    want = jax_ln.fused_layernorm(as_jax, jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
                                  1e-5, 0, True)
    got = tiled_ln_forward(x, scale, bias)[0]
    assert _fwd_rel(got, torch.from_numpy(np.array(want, np.float32))) <= FWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,d", [((4, 197), 768), ((9,), 1024), ((7, 11), 36), ((5, 3), 40)])
def test_forward_statistics_are_the_backwards_bit_for_bit(lead, d, dtype):
    """The forward's mu and rstd equal the ones the backward recomputes, bit
    for bit (one helper, one lane layout, one order), in the vector and the
    scalar walk alike."""
    x, scale, dy = _inputs(lead, d, dtype, seed=2)
    _, mu_f, rstd_f = tiled_ln_forward(x, scale, _bias(d))
    *_, mu_b, rstd_b = tiled_ln_backward(x, scale, dy, with_stats=True)
    assert torch.equal(mu_f, mu_b) and torch.equal(rstd_f, rstd_b)


@pytest.mark.parametrize("d", [36, 37, 1023])
def test_scalar_walk_takes_the_vector_walks_lanes(d):
    """At a width the vectors do not divide (bf16 and fp32: 37, 1023; bf16:
    36) the kernel takes scalar loads in the same lane layout: every element
    is one lane's once, the vector walk is refused, and y meets the bar."""
    for dtype in (torch.float32, torch.bfloat16):
        v, _, col, live, _ = lane_layout(d, dtype)
        if d % v == 0:
            continue
        assert sorted(col[live].tolist()) == list(range(d))
        x, scale, _ = _inputs((6,), d, dtype, seed=3)
        with pytest.raises(AssertionError, match="multiple of V"):
            tiled_ln_forward(x, scale, _bias(d), vectors=True)
        y, *_ = tiled_ln_forward(x, scale, _bias(d), vectors=False)
        assert _fwd_rel(y, fused_ln.layernorm_plain(x, scale, _bias(d))) <= FWD_TOL[dtype]


@pytest.mark.parametrize("pe", [8, 16, 24, 32])
def test_forward_stages_gamma_and_beta_in_its_shared_memory(pe):
    """The forward stages gamma and beta lane-major, 32 lanes x PE / 4 float4
    each, in a static array of two such rows: 8 KB at the widest bucket."""
    src = SOURCE.read_text()
    assert "__shared__ float4 gb[2][8 * PE];" in src
    assert 32 * (pe // 4) == 8 * pe and 2 * 8 * pe * 16 <= 8192
