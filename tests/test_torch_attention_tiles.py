"""The tile algorithms of the attention kernels, emulated on the CPU.

``csrc/fused_attention.cu`` and ``csrc/fused_attention_bwd.cu`` walk K and V
(or Q and dO) in tiles of 64 rows instead of holding a head's N x N scores.
A CUDA kernel cannot run here, so this file writes the same algorithms in
plain PyTorch, tile by tile and sweep by sweep, and holds them against the
unchanged plain versions ``fused_mha_plain`` / ``fused_mha_bwd_plain`` at the
shapes the card will see:

  - bfloat16 (``tiled_forward`` / ``tiled_backward``): the sweeps, the
    kernels' rounding points (bf16 casts where they cast, fp32 sums
    everywhere else), zero-filled ragged rows, the selection of dead pairs
    and causal tile skipping; run in both dtypes.
  - float32 (``tiled_forward_fp32`` / ``tiled_backward_fp32``, the
    ``attention_tile.cuh`` ``attn32`` kernels): one forward sweep with the
    online rescaling, per-thread partial sums over the key columns
    tx + 16 c and their xor butterfly, the dQ pass's two sweeps (online m,
    l and u, then dz) and the dK/dV pass on the transposed tiles.

The emulations are used by nothing in the package.

Tolerances are ``chip_smoke.py``'s, unchanged (a test here pins that):
forward 1e-5 absolute in float32 (summation order only) and 4e-3 in bfloat16
(one rounding step of an output below 1); backward 1e-5 (float32) and 2^-7
(bfloat16, two rounding steps) of the largest |grad|.
"""
from __future__ import annotations

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from colxlip_tpu_torch.ops import attention

REPO = pathlib.Path(__file__).resolve().parents[1]
TILE = 64
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SHAPES = [
    # N, D, causal
    (197, 64, False),   # vision tower: 5 live keys in the fourth tile
    (77, 64, True),     # text tower: 13 live keys in the second tile
    (257, 64, False),   # ViT-L/14: 1 live key in the fifth tile
    (65, 32, True),     # head_dim 32, one live row in the second tile
    (1024, 64, True),   # 16 tiles, most of them skipped under the mask
]
# the float32 kernels take any N: lengths whose K and V would not fit in one
# block's shared memory
FP32_SHAPES = SHAPES + [
    (577, 64, False),   # ViT-L/14 at 336 px: one live key in the tenth tile
    (1024, 32, True),   # head_dim 32, 16 tiles under the mask
]
HEADS = 2
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The emulations are many small tensor operations: one intra-op thread,
    so that the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((BATCH, n, 3 * HEADS * d)).astype(np.float32)
    dout = rng.standard_normal((BATCH, n, HEADS * d)).astype(np.float32)
    return torch.from_numpy(qkv).to(dtype), torch.from_numpy(dout).to(dtype)


def _padded_heads(x, parts, n_tiles):
    """[B, N, parts*H*D] -> [parts, B, H, tiles * 64, D] in fp32; the rows
    past N are zeros, as the kernels' zero-filled copies leave them."""
    x = attention._heads_view(x, parts, HEADS)
    pad = n_tiles * TILE - x.shape[-2]
    return torch.nn.functional.pad(x, (0, 0, 0, pad))


def _tile(x, i):
    return x[..., i * TILE:(i + 1) * TILE, :]


def _dead(rows0, cols0, n, causal):
    """[64, 64] mask of the pairs a (query tile, key tile) must not count:
    key past N, or key after query under the causal mask."""
    rows = rows0 + torch.arange(TILE)[:, None]
    cols = cols0 + torch.arange(TILE)[None, :]
    dead = (cols >= n).expand(TILE, TILE).clone()
    if causal:
        dead |= cols > rows
    return dead


def _score_tile(q, k, qt, kt, n, causal, scale):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    return s.masked_fill(_dead(qt * TILE, kt * TILE, n, causal), float("-inf"))


def _unpad(x, n, parts):
    """[parts, B, H, padded, D] -> [B, N, parts*H*D]."""
    p, b, h, _, d = x.shape
    return x[..., :n, :].permute(1, 3, 0, 2, 4).reshape(b, n, p * h * d)


def tiled_forward(qkv, causal):
    """What ``attn_fwd_mma_kernel`` computes, in its order: per query tile,
    sweep 1 over the key tiles for the row max, sweep 2 for e = exp(s - m),
    l += e (unrounded) and O += e(input dtype) . V; out = O / l."""
    dtype, n = qkv.dtype, qkv.shape[1]
    d = qkv.shape[2] // (3 * HEADS)
    scale = 1.0 / math.sqrt(d)
    tiles = -(-n // TILE)
    q, k, v = _padded_heads(qkv, 3, tiles)
    out = torch.zeros_like(q)
    for qt in range(tiles):
        met = qt + 1 if causal else tiles            # causal: stop at the diagonal
        qq = _tile(q, qt)
        m = torch.full(qq.shape[:-1], float("-inf"))
        for kt in range(met):
            m = torch.maximum(m, _score_tile(qq, _tile(k, kt), qt, kt, n, causal, scale).amax(-1))
        l = torch.zeros_like(m)
        o = torch.zeros_like(qq)
        for kt in range(met):
            e = torch.exp(_score_tile(qq, _tile(k, kt), qt, kt, n, causal, scale) - m[..., None])
            l += e.sum(-1)
            o += torch.matmul(e.to(dtype).float(), _tile(v, kt))
        _tile(out, qt).copy_((o / l[..., None]).to(dtype).float())
    return _unpad(out[None], n, 1).to(dtype)


def tiled_backward(qkv, dout, causal):
    """What the two backward kernels compute, in their order.

    dQ pass, per query tile, three sweeps over the key tiles: the row max m;
    then e, l += e and u += e * dp, giving 1 / l and delta = u / l; then
    dz = (e / l * (dp - delta) * scale) in the input dtype and dQ += dz . K.
    dK/dV pass, per key tile, over the query tiles from the diagonal on: the
    transposed tiles S^T = K . Q^T and dP^T = V . dO^T, p and dz rebuilt from
    the stored m, 1 / l and delta (0 for dead pairs by selection),
    dV += p(input dtype)^T . dO and dK += dz^T . Q."""
    dtype, n = qkv.dtype, qkv.shape[1]
    d = qkv.shape[2] // (3 * HEADS)
    scale = 1.0 / math.sqrt(d)
    tiles = -(-n // TILE)
    q, k, v = _padded_heads(qkv, 3, tiles)
    do = _padded_heads(dout, 1, tiles)[0]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(q)
    row_m = torch.zeros(q.shape[:-1])
    row_il = torch.zeros_like(row_m)
    row_delta = torch.zeros_like(row_m)

    for qt in range(tiles):
        met = qt + 1 if causal else tiles
        qq, dd = _tile(q, qt), _tile(do, qt)
        m = torch.full(qq.shape[:-1], float("-inf"))
        for kt in range(met):
            m = torch.maximum(m, _score_tile(qq, _tile(k, kt), qt, kt, n, causal, scale).amax(-1))
        l, u = torch.zeros_like(m), torch.zeros_like(m)
        for kt in range(met):
            e = torch.exp(_score_tile(qq, _tile(k, kt), qt, kt, n, causal, scale) - m[..., None])
            dp = torch.matmul(dd, _tile(v, kt).transpose(-1, -2))
            l += e.sum(-1)
            u += (e * dp).sum(-1)
        il = 1.0 / l
        delta = u * il
        acc = torch.zeros_like(qq)
        for kt in range(met):
            e = torch.exp(_score_tile(qq, _tile(k, kt), qt, kt, n, causal, scale) - m[..., None])
            dp = torch.matmul(dd, _tile(v, kt).transpose(-1, -2))
            dz = e * il[..., None] * (dp - delta[..., None]) * scale
            acc += torch.matmul(dz.to(dtype).float(), _tile(k, kt))
        _tile(dq, qt).copy_(acc)
        sl = slice(qt * TILE, (qt + 1) * TILE)
        row_m[..., sl], row_il[..., sl], row_delta[..., sl] = m, il, delta

    for kt in range(tiles):
        kk, vv = _tile(k, kt), _tile(v, kt)
        acc_k, acc_v = torch.zeros_like(kk), torch.zeros_like(kk)
        for qt in range(kt if causal else 0, tiles):
            sl = slice(qt * TILE, (qt + 1) * TILE)
            qq, dd = _tile(q, qt), _tile(do, qt)
            st = torch.matmul(kk, qq.transpose(-1, -2)) * scale       # [keys, queries]
            dpt = torch.matmul(vv, dd.transpose(-1, -2))
            dead = _dead(qt * TILE, kt * TILE, n, causal).T
            dead = dead | (qt * TILE + torch.arange(TILE)[None, :] >= n)  # query past N
            p = torch.exp(st - row_m[..., None, sl]) * row_il[..., None, sl]
            p = torch.where(dead, torch.zeros(()), p)
            dz = torch.where(dead, torch.zeros(()), p * (dpt - row_delta[..., None, sl]) * scale)
            acc_v += torch.matmul(p.to(dtype).float(), dd)
            acc_k += torch.matmul(dz.to(dtype).float(), qq)
        _tile(dk, kt).copy_(acc_k)
        _tile(dv, kt).copy_(acc_v)
    return _unpad(torch.stack([dq, dk, dv]), n, 3).to(dtype)


def test_tolerances_are_the_card_checks_own():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        assert smoke.ATTN_TOL[name] == ATTN_TOL[dtype]
        assert smoke.BWD_TOL[name] == BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,causal", SHAPES)
def test_tiled_forward_matches_plain(n, d, causal, dtype):
    qkv, _ = _inputs(n, d, dtype)
    got = tiled_forward(qkv, causal)
    want = attention.fused_mha_plain(qkv, HEADS, causal)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,causal", SHAPES)
def test_tiled_backward_matches_plain(n, d, causal, dtype):
    qkv, dout = _inputs(n, d, dtype, seed=1)
    got = tiled_backward(qkv, dout, causal)
    want = attention.fused_mha_bwd_plain(qkv, dout, HEADS, causal)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    tol = BWD_TOL[dtype] * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def test_stale_rows_would_poison_a_tile_that_is_only_masked():
    """Why the kernels zero-fill rows past N: with NaN bit patterns left in
    the dead rows of V, a probability of exactly 0 still multiplies to NaN."""
    qkv, _ = _inputs(70, 64, torch.bfloat16)
    q, k, v = _padded_heads(qkv, 3, 2)
    s = _score_tile(_tile(q, 0), _tile(k, 1), 0, 1, 70, False, 0.125)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    assert (e[..., 6:] == 0).all()
    assert torch.isfinite(torch.matmul(e, _tile(v, 1))).all()
    stale = _tile(v, 1).clone()
    stale[..., 6:, :] = float("nan")
    assert torch.isnan(torch.matmul(e, stale)).all()


# ---------------------------------------------------------------------------
# float32: attention_tile.cuh attn32 (one 64-row block, key columns tx + 16 c)
# ---------------------------------------------------------------------------

def _row_sum16(partial: torch.Tensor) -> torch.Tensor:
    """attn32 row_sum over the 16 threads of a row, the last axis of
    ``partial`` (thread tx's partial sum): the xor butterfly 1, 2, 4, 8;
    every thread ends with the same value, tx 0's is returned."""
    lanes = torch.arange(16)
    for o in (1, 2, 4, 8):
        partial = partial + partial[..., lanes ^ o]
    return partial[..., 0]


def _by_thread(x: torch.Tensor) -> torch.Tensor:
    """[..., 64 columns] -> [..., 16 tx, 4 c]: column tx + 16 c of a tile is
    thread tx's c-th."""
    return x.reshape(*x.shape[:-1], 4, 16).transpose(-1, -2)


def _online_step(m, parts, s, extra=None):
    """One key tile of the online softmax, per row: m' = max(m, rowmax s),
    a = exp(m - m'), each thread's partial sums rescaled by a plus its own
    four columns (of e, or of e * extra). Returns (m', a, e, parts)."""
    mn = torch.maximum(m, s.amax(-1))
    ref = torch.where(mn == float("-inf"), torch.zeros(()), mn)
    a = torch.exp(m - ref)
    e = torch.exp(s - ref[..., None])
    news = [e] if extra is None else [e, e * extra]
    parts = [p * a[..., None] + _by_thread(t).sum(-1) for p, t in zip(parts, news)]
    return mn, a, e, parts


def tiled_forward_fp32(qkv, causal):
    """What ``attn_fwd_fp32_kernel`` computes, in its order: per query tile
    one sweep over the key tiles (up to the diagonal when causal) with the
    running max m, the threads' partial row sums l rescaled by
    a = exp(m_old - m_new) and O = a O + e . V; at the end l is the
    butterfly sum of the partials and out = O / l."""
    n = qkv.shape[1]
    d = qkv.shape[2] // (3 * HEADS)
    scale = 1.0 / math.sqrt(d)
    tiles = -(-n // TILE)
    q, k, v = _padded_heads(qkv, 3, tiles)
    out = torch.zeros_like(q)
    for qt in range(tiles):
        qq = _tile(q, qt)
        m = torch.full(qq.shape[:-1], float("-inf"))
        parts = [torch.zeros(*qq.shape[:-1], 16)]
        o = torch.zeros_like(qq)
        for kt in range(qt + 1 if causal else tiles):
            s = _score_tile(qq, _tile(k, kt), qt, kt, n, causal, scale)
            m, a, e, parts = _online_step(m, parts, s)
            o = o * a[..., None] + torch.matmul(e, _tile(v, kt))
        _tile(out, qt).copy_(o / _row_sum16(parts[0])[..., None])
    return _unpad(out[None], n, 1)


def tiled_backward_fp32(qkv, dout, causal):
    """What the two float32 backward kernels compute, in their order.

    dQ pass, per query tile, two sweeps over the key tiles: sweep A runs the
    online max m with the partial sums l and u = sum e dp, both rescaled as
    the max grows; their butterfly sums give 1 / l and delta = u / l; sweep B
    computes p = exp(s - m) / l, dz = p (dp - delta) scale and dQ += dz . K.
    dK/dV pass, per key tile, over the query tiles from the diagonal on: the
    transposed tiles S^T = (K . Q^T) scale and dP^T = V . dO^T, p and dz
    rebuilt from the stored statistics (0 for dead pairs by selection),
    dV += p^T . dO and dK += dz^T . Q."""
    n = qkv.shape[1]
    d = qkv.shape[2] // (3 * HEADS)
    scale = 1.0 / math.sqrt(d)
    tiles = -(-n // TILE)
    q, k, v = _padded_heads(qkv, 3, tiles)
    do = _padded_heads(dout, 1, tiles)[0]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(q)
    row_m = torch.zeros(q.shape[:-1])
    row_il = torch.zeros_like(row_m)
    row_delta = torch.zeros_like(row_m)

    for qt in range(tiles):
        met = qt + 1 if causal else tiles
        qq, dd = _tile(q, qt), _tile(do, qt)
        m = torch.full(qq.shape[:-1], float("-inf"))
        parts = [torch.zeros(*qq.shape[:-1], 16), torch.zeros(*qq.shape[:-1], 16)]
        for kt in range(met):
            s = _score_tile(qq, _tile(k, kt), qt, kt, n, causal, scale)
            dp = torch.matmul(dd, _tile(v, kt).transpose(-1, -2))
            m, _, _, parts = _online_step(m, parts, s, dp)
        il = 1.0 / _row_sum16(parts[0])
        delta = _row_sum16(parts[1]) * il
        acc = torch.zeros_like(qq)
        for kt in range(met):
            s = _score_tile(qq, _tile(k, kt), qt, kt, n, causal, scale)
            dp = torch.matmul(dd, _tile(v, kt).transpose(-1, -2))
            p = torch.exp(s - m[..., None]) * il[..., None]
            acc += torch.matmul(p * (dp - delta[..., None]) * scale, _tile(k, kt))
        _tile(dq, qt).copy_(acc)
        sl = slice(qt * TILE, (qt + 1) * TILE)
        row_m[..., sl], row_il[..., sl], row_delta[..., sl] = m, il, delta

    for kt in range(tiles):
        kk, vv = _tile(k, kt), _tile(v, kt)
        acc_k, acc_v = torch.zeros_like(kk), torch.zeros_like(kk)
        for qt in range(kt if causal else 0, tiles):
            sl = slice(qt * TILE, (qt + 1) * TILE)
            qq, dd = _tile(q, qt), _tile(do, qt)
            st = torch.matmul(kk, qq.transpose(-1, -2)) * scale       # [keys, queries]
            dpt = torch.matmul(vv, dd.transpose(-1, -2))
            dead = _dead(qt * TILE, kt * TILE, n, causal).T
            dead = dead | (qt * TILE + torch.arange(TILE)[None, :] >= n)  # query past N
            p = torch.where(dead, torch.zeros(()),
                            torch.exp(st - row_m[..., None, sl]) * row_il[..., None, sl])
            dz = torch.where(dead, torch.zeros(()), p * (dpt - row_delta[..., None, sl]) * scale)
            acc_v += torch.matmul(p, dd)
            acc_k += torch.matmul(dz, qq)
        _tile(dk, kt).copy_(acc_k)
        _tile(dv, kt).copy_(acc_v)
    return _unpad(torch.stack([dq, dk, dv]), n, 3)


@pytest.mark.parametrize("n,d,causal", FP32_SHAPES)
def test_fp32_tiled_forward_matches_plain(n, d, causal):
    """One sweep with online rescaling stays inside the float32 bar: the
    rescaled e differs from exp(s - m) by a few ulp, where the bf16 kernel
    needs two sweeps only to round e against the final max."""
    qkv, _ = _inputs(n, d, torch.float32)
    got = tiled_forward_fp32(qkv, causal)
    want = attention.fused_mha_plain(qkv, HEADS, causal)
    assert got.shape == want.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=ATTN_TOL[torch.float32])


@pytest.mark.parametrize("n,d,causal", FP32_SHAPES)
def test_fp32_tiled_backward_matches_plain(n, d, causal):
    qkv, dout = _inputs(n, d, torch.float32, seed=1)
    got = tiled_backward_fp32(qkv, dout, causal)
    want = attention.fused_mha_bwd_plain(qkv, dout, HEADS, causal)
    assert got.shape == want.shape and torch.isfinite(got).all()
    tol = BWD_TOL[torch.float32] * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_fp32_online_rescaling_equals_the_final_max():
    """The online sweep's l and O, rescaled as the max grows, equal the sums
    taken against the final max to a few fp32 ulp (relative 1e-6), on a row
    whose max arrives in the last key tile, where every earlier term has
    been rescaled."""
    rng = np.random.default_rng(7)
    s = torch.from_numpy(rng.standard_normal((1, 1, TILE, 4 * TILE)).astype(np.float32))
    s[..., -1] += 20.0                           # each row's max in the fourth tile
    v = torch.from_numpy(rng.standard_normal((1, 1, 4 * TILE, 64)).astype(np.float32))
    m = torch.full(s.shape[:-1], float("-inf"))
    parts, o = [torch.zeros(*s.shape[:-1], 16)], torch.zeros(1, 1, TILE, 64)
    for kt in range(4):
        sl = slice(kt * TILE, (kt + 1) * TILE)
        m, a, e, parts = _online_step(m, parts, s[..., sl])
        o = o * a[..., None] + torch.matmul(e, v[..., sl, :])
    e = torch.exp(s - s.amax(-1, keepdim=True))
    torch.testing.assert_close(_row_sum16(parts[0]), e.sum(-1), rtol=1e-6, atol=0)
    torch.testing.assert_close(o, torch.matmul(e, v), rtol=0, atol=1e-6)
