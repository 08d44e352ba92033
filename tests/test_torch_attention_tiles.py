"""The tile algorithm of the bfloat16 attention kernels, emulated on the CPU.

``csrc/fused_attention.cu`` and ``csrc/fused_attention_bwd.cu`` walk K and V
(or Q and dO) in tiles of 64 rows and sweep them more than once instead of
holding a head's N x N scores. A CUDA kernel cannot run here, so this file
writes the same algorithm in plain PyTorch, tile by tile and sweep by sweep,
with the kernels' rounding points (bf16 casts where they cast, fp32 sums
everywhere else), their zero-filled ragged rows, their selection of dead pairs
and their causal tile skipping, and holds it against the unchanged plain
versions ``fused_mha_plain`` / ``fused_mha_bwd_plain`` at the shapes the card
will see. The emulation is used by nothing in the package.

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
HEADS = 2
BATCH = 2


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


@pytest.mark.parametrize("d,backward,limit", [(64, False, 420), (64, True, 383),
                                              (32, False, 792), (32, True, 677)])
def test_fp32_sequence_limit_is_what_shared_memory_holds(d, backward, limit):
    """The float32 kernels keep a head's operands in shared memory: the
    wrapper's limit is the largest N whose bytes fit, and ViT-L/14's 257
    tokens are inside it."""
    assert attention.fp32_max_seq(d, backward) == limit
    assert attention.fp32_shared_bytes(limit, d, backward) <= attention.MAX_SHARED_BYTES
    assert attention.fp32_shared_bytes(limit + 1, d, backward) > attention.MAX_SHARED_BYTES
    assert limit >= 257
