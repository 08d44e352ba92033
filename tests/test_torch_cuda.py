"""colxlip_tpu_torch CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one: a CUDA kernel has no CPU mode. The file imports only torch,
numpy and the port, so it runs where the JAX package is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: fp32 outputs 1e-5 (summation order only); bf16 attention 4e-3
(one bf16 rounding step of an output below 1 in magnitude); bf16 gradients
2^-7 of the largest |grad| (each gradient is summed in fp32 and rounded to
bf16 once, and the attention backward also rounds dz and p to bf16, where
the kernel and the plain version may land one step apart). Streaming CE:
loss rows and lse 1e-5 relative + 1e-5 absolute (fp32 sums of exact
products in another order, at logits up to 100); dA, dB and dscale 1e-4 of
the largest |grad| (the kernel's expf against torch's exp at 1e-7 relative,
times up to N terms). LayerNorm and MLP kernels: forward, of max(1, largest
|out|), 1e-5 in fp32 (summation order, 3072 terms deep in the MLP, and
rsqrtf / expf against torch's) and one bf16 rounding step (2^-7) in bf16,
but the bf16 MLP forward, which is held per element to the exact function
within what its fp32 sums and GELU allow (ops/fused_mlp_check.py);
gradients 1e-4 of the largest |grad| in fp32 (dscale, dbias and dW sum over
every row), 2^-7 of it in bf16. The int8 quantizer: values and scales equal
to the plain version's bit for bit (both compute the same Philox words and
the same IEEE divisions). int8 x int8 -> int32 products: equal to the CPU's
(integer sums are exact). The int8 MaxSim forward: 1e-6 from the CPU's (equal
integers, fp32 rescale).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from colxlip_tpu_torch.factory import create_model
from colxlip_tpu_torch.ops import (
    attention, fused_ce, fused_ln, fused_mlp, fused_mlp_check, maxsim, quantization)
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.serving.server import InferenceEngine
from colxlip_tpu_torch.training.optim import create_optimizer

pytestmark = pytest.mark.cuda

ATTN_SHAPES = [
    # (b, n, heads, hd, causal)
    (2, 197, 12, 768, False),   # vision tower
    (2, 77, 8, 512, True),      # text tower, causal
    (3, 16, 4, 128, True),      # odd batch, head_dim 32
    (1, 256, 2, 128, False),    # four full key tiles
    (1, 257, 16, 1024, False),  # ViT-L/14: one live key in the fifth tile
    (2, 1024, 2, 128, True),    # long causal: 16 key tiles, tile skipping
    (3, 65, 4, 128, True),      # ragged, head_dim 32
]
# float32 holds a head's K and V in shared memory: 1024 keys do not fit
FP32_TOO_LONG = 1024
MAXSIM_SHAPES = [
    # (m, k, lt, li, d)
    (6, 130, 77, 196, 512),     # training widths, K not a multiple of anything
    (3, 5, 80, 256, 40),        # one full 256-column group, D not a multiple of 32
    (4, 7, 32, 16, 128),        # the tiny config's token shapes
    (3, 4, 100, 257, 64),       # two column groups, one live column in the second
    (2, 3, 100, 577, 64),       # ViT-L/14 at 336 px with its CLS token: three groups
    (2, 3, 12, 20, 20),         # rows of 40 bytes: bf16 staged without cp.async
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _qkv(b, n, hd, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, n, 3 * hd)) * 0.5
            ).astype(np.float32)


def _l2(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("b,n,heads,hd,causal", ATTN_SHAPES)
def test_attention_kernel_matches_plain(dev, b, n, heads, hd, causal, dtype, atol):
    if dtype == torch.float32 and n >= FP32_TOO_LONG:
        with pytest.raises(ValueError, match="float32 kernel"):
            attention.fused_mha_packed(torch.zeros(b, n, 3 * hd, device=dev), heads, causal)
        return
    qkv = torch.from_numpy(_qkv(b, n, hd)).to(dev, dtype)
    before = attention.LAUNCHES.value
    with torch.inference_mode():
        got = attention.fused_mha_packed(qkv, heads, causal)
        want = attention.fused_mha_plain(qkv, heads, causal)
    assert attention.LAUNCHES.value == before + 1
    assert got.dtype == dtype and got.shape == (b, n, hd)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def test_attention_kernel_refuses_what_it_does_not_take(dev):
    qkv = torch.zeros(2, 8, 3 * 96, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        attention.fused_mha_packed(qkv, 2)                    # D = 48
    out = attention.fused_mha_packed(torch.zeros(1, 257, 192, device=dev), 2)   # 257 runs
    assert out.shape == (1, 257, 64) and not out.any()
    with pytest.raises(ValueError, match="dtype"):
        attention.fused_mha_packed(qkv.half(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        attention.fused_mha_packed(torch.zeros(8, 2, 192, device=dev).transpose(0, 1), 2)
    with pytest.raises(ValueError, match="head_dim"):   # the autograd entry checks too
        attention.fused_mha_packed(torch.zeros(2, 8, 3 * 96, device=dev,
                                               requires_grad=True), 2)
    qkv = torch.zeros(2, 8, 192, device=dev)
    with pytest.raises(ValueError, match="dout"):
        attention._launch_bwd(qkv, torch.zeros(2, 8, 64, device=dev, dtype=torch.bfloat16), 2,
                              False)
    # bfloat16 from an address that is not a multiple of 16 bytes
    flat = torch.zeros(2 * 8 * 192 + 8, device=dev, dtype=torch.bfloat16)
    odd = flat[1:1 + 2 * 8 * 192].view(2, 8, 192)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention.fused_mha_packed(odd, 1)
    good = flat[:2 * 8 * 192].view(2, 8, 192)
    with pytest.raises(ValueError, match="dout must start at a 16-byte"):
        attention._launch_bwd(good, flat[1:1 + 2 * 8 * 64].view(2, 8, 64), 1, False)
    # float32 past what its shared memory holds, forward and backward
    for backward in (False, True):
        limit = attention.fp32_max_seq(64, backward)
        long = torch.zeros(1, limit + 1, 192, device=dev)
        with pytest.raises(ValueError, match=f"seq <= {limit}"):
            if backward:
                attention._launch_bwd(long, long[..., :64].contiguous(), 1, False)
            else:
                attention.fused_mha_packed(long, 1)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_attention_fp32_kernel_runs_at_its_limit(dev, d, backward):
    """The longest float32 sequence the wrapper admits launches and agrees."""
    n = attention.fp32_max_seq(d, backward)
    qkv = torch.from_numpy(_qkv(1, n, 2 * d, seed=3)).to(dev)
    if backward:
        dout = torch.from_numpy(_qkv(1, n, 2 * d, seed=4)[..., :2 * d].copy()).to(dev)
        got = attention._launch_bwd(qkv, dout, 2, True)
        want = attention.fused_mha_bwd_plain(qkv, dout, 2, True)
    else:
        got = attention.fused_mha_packed(qkv, 2, True)
        want = attention.fused_mha_plain(qkv, 2, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [64, 5, 1])
def test_mma_tile_layouts_match_matmul(dev, rows):
    """A bare 64 x 64 x 64 product through csrc/mma_tile.cuh (cp.async with
    zero fill, ldmatrix, mma.sync, the accumulator reused as an A operand,
    and the transposed product A^T B of the MLP's weight gradients) against
    torch.matmul: products of bf16 values summed in fp32, so the first and
    third products differ by summation order only (1e-4 of values up to 30)
    and the second by bf16 roundings of the first that land one step apart
    (2^-8 relative, summed over 64 terms)."""
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).to(dev)
    a, b = a.bfloat16(), b.bfloat16()
    got_abt, got_pb, got_tn = attention.mma_tile_check(a, b, rows)
    torch.cuda.synchronize()
    a32, b32 = a.float(), b.float()
    a32[rows:], b32[rows:] = 0, 0
    want_abt = a32 @ b32.T
    torch.testing.assert_close(got_abt, want_abt, rtol=0, atol=1e-4)
    # the tiles read k-major (ldmatrix.trans for A as well as B): A^T B
    torch.testing.assert_close(got_tn, a32.T @ b32, rtol=0, atol=1e-4)
    want_pb = want_abt.bfloat16().float() @ b32
    torch.testing.assert_close(got_pb, want_pb, rtol=0,
                               atol=2.0 ** -6 * want_pb.abs().max().item())


@pytest.mark.parametrize("mask_mode", ["nonzero", "plain", "valid"])
@pytest.mark.parametrize("m,k,lt,li,d", MAXSIM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxsim_kernel_matches_plain(dev, mask_mode, m, k, lt, li, d, dtype):
    rng = np.random.default_rng(0)
    t = _l2(rng.standard_normal((m, lt, d))).astype(np.float32)
    t[0, lt // 2:] = 0.0
    i = _l2(rng.standard_normal((k, li, d))).astype(np.float32)
    mask = (rng.random((m, lt)) > 0.3).astype(np.float32)
    t, i = torch.from_numpy(t).to(dev, dtype), torch.from_numpy(i).to(dev, dtype)
    tmask = torch.from_numpy(mask).to(dev)
    before = maxsim.LAUNCHES.value
    with torch.inference_mode():
        got = maxsim.maxsim(t, i, mask_mode=mask_mode, text_mask=tmask)
        want = maxsim.maxsim_plain(t, i, mask_mode=mask_mode, text_mask=tmask)
    assert maxsim.LAUNCHES.value == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, k)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["device", "mask_dtype", "dtype_pair", "float16",
                                  "contiguous"])
def test_maxsim_kernel_refuses_what_it_does_not_take(dev, case):
    """What the kernels do not take raises, forward and backward; no token
    count is refused any more (Lt = 81 runs)."""
    t = torch.zeros(2, 81, 16, device=dev)
    i = torch.zeros(3, 9, 16, device=dev)
    g = torch.zeros(2, 3, device=dev)
    assert maxsim.maxsim(t, i).shape == (2, 3)
    mask, mode = None, "nonzero"
    if case == "device":
        i, match = i.cpu(), "both must be on one CUDA device"
    elif case == "mask_dtype":
        mask, mode = torch.ones(2, 81, device=dev, dtype=torch.float64), "valid"
        match = "text_mask must be"
    elif case == "dtype_pair":
        i, match = i.bfloat16(), "dtypes"
    elif case == "float16":
        t, i, match = t.half(), i.half(), "dtypes"
    else:
        t, match = torch.zeros(81, 2, 16, device=dev).transpose(0, 1), "contiguous"
    with pytest.raises(ValueError, match=match):
        maxsim.maxsim(t, i, mask_mode=mode, text_mask=mask)
    with pytest.raises(ValueError, match=match):
        maxsim._backward(t, i, g, mode, mask)


def test_tiny_model_kernels_match_plain_path(dev, monkeypatch):
    """The tiny config (head_dim 32) in fp32 on the card: the encode through
    the kernels equals the encode with the plain attention."""
    model, _ = create_model("ViT-S-16-test-colxlip", dev, torch.float32, seed=0)
    eng = InferenceEngine(model, dev, max_batch=4)
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    txts = np.zeros((3, 32), np.int32)
    txts[:, 0], txts[:, 1:9], txts[:, 9] = 49406, rng.integers(1, 49000, (3, 8)), 49407
    before = attention.LAUNCHES.value
    got = [eng.run("image", imgs), eng.run("text", txts)]
    assert attention.LAUNCHES.value == before + 4  # 2 layers x 2 towers
    monkeypatch.setattr(attention, "fused_mha_packed", attention.fused_mha_plain)
    want = [eng.run("image", imgs), eng.run("text", txts)]
    for g_tower, w_tower in zip(got, want):
        for g, w in zip(g_tower, w_tower):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def _bf16_tol(want: torch.Tensor, dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 2.0 ** -7 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,hd,causal", ATTN_SHAPES)
def test_attention_bwd_kernel_matches_plain(dev, b, n, heads, hd, causal, dtype):
    if dtype == torch.float32 and n >= FP32_TOO_LONG:
        with pytest.raises(ValueError, match="float32 kernel"):
            attention._launch_bwd(torch.zeros(b, n, 3 * hd, device=dev),
                                  torch.zeros(b, n, hd, device=dev), heads, causal)
        return
    qkv = torch.from_numpy(_qkv(b, n, hd)).to(dev, dtype)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal((b, n, hd))
                            .astype(np.float32)).to(dev, dtype)
    before = attention.BWD_LAUNCHES.value
    got = attention._launch_bwd(qkv, dout, heads, causal)
    want = attention.fused_mha_bwd_plain(qkv, dout, heads, causal)
    torch.cuda.synchronize()
    assert attention.BWD_LAUNCHES.value == before + 1
    assert got.dtype == dtype and got.shape == qkv.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_bf16_tol(want.float(), dtype))


def test_attention_bwd_kernel_is_deterministic(dev):
    """No atomics: two runs of the backward give the same bits."""
    qkv = torch.from_numpy(_qkv(4, 197, 768)).to(dev, torch.bfloat16)
    dout = torch.from_numpy(_qkv(4, 197, 256, seed=2)).to(dev, torch.bfloat16)
    first = attention._launch_bwd(qkv, dout, 12, False)
    second = attention._launch_bwd(qkv, dout, 12, False)
    assert torch.equal(first, second)


def test_attention_autograd_launches_both_kernels(dev):
    qkv = torch.from_numpy(_qkv(3, 77, 512)).to(dev, torch.bfloat16).requires_grad_()
    dout = torch.randn(3, 77, 512, device=dev, dtype=torch.bfloat16)
    before = (attention.LAUNCHES.value, attention.BWD_LAUNCHES.value)
    out = attention.fused_mha_packed(qkv, 8, True)
    (got,) = torch.autograd.grad(out, qkv, dout)
    assert (attention.LAUNCHES.value, attention.BWD_LAUNCHES.value) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, attention._launch_bwd(qkv.detach(), dout, 8, True),
                               rtol=0, atol=0)


def _maxsim_inputs(m, k, lt, li, d, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    t = _l2(rng.standard_normal((m, lt, d))).astype(np.float32)
    t[0, lt // 2:] = 0.0
    i = _l2(rng.standard_normal((k, li, d))).astype(np.float32)
    mask = (rng.random((m, lt)) > 0.3).astype(np.float32)
    g = rng.standard_normal((m, k)).astype(np.float32)
    return (torch.from_numpy(t).to(dev, dtype), torch.from_numpy(i).to(dev, dtype),
            torch.from_numpy(mask).to(dev), torch.from_numpy(g).to(dev))


@pytest.mark.parametrize("mask_mode", ["nonzero", "plain", "valid"])
@pytest.mark.parametrize("m,k,lt,li,d", MAXSIM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxsim_bwd_kernel_matches_plain(dev, mask_mode, m, k, lt, li, d, dtype):
    t, i, tmask, g = _maxsim_inputs(m, k, lt, li, d, dev, dtype)
    before = maxsim.BWD_LAUNCHES.value
    got = maxsim._launch_bwd(t, i, g, mask_mode, tmask)
    want = maxsim.maxsim_bwd_plain(t, i, g, mask_mode=mask_mode, text_mask=tmask)
    torch.cuda.synchronize()
    assert maxsim.BWD_LAUNCHES.value == before + 1
    for a, w, x in zip(got, want, (t, i)):
        assert a.dtype == dtype and a.shape == x.shape
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=_bf16_tol(w.float(), dtype))


def test_maxsim_bwd_kernel_routes_every_tie(dev):
    """Image tokens 3 and 7 identical, text tokens equal to them: both tied
    tokens get the full cotangent, as in the plain version."""
    t, i, _, g = _maxsim_inputs(4, 3, 12, 20, 64, dev, torch.float32, seed=1)
    i[:, 7] = i[:, 3]
    t[1, :4] = i[1, 3]
    dt, di = maxsim._launch_bwd(t, i, g, "nonzero", None)
    want = maxsim.maxsim_bwd_plain(t, i, g)
    torch.testing.assert_close(di, want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(dt, want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(di[1, 3], di[1, 7], rtol=0, atol=1e-6)
    assert di[1, 7].abs().max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxsim_bwd_kernel_settles_near_ties(dev, dtype):
    """Image token 9 differs from tokens 3 and 7 (equal) in one feature of
    about 0.02 by two percent: for the text tokens equal to token 3 it comes
    within the route pass's margin under the max (8e-6 below it), and the
    settle pass must leave it out, as the plain version does, and keep both
    exact ties."""
    t, i, _, g = _maxsim_inputs(4, 3, 12, 20, 64, dev, torch.float32, seed=1)
    i[:, 7] = i[:, 3]
    i[:, 9] = i[:, 3]
    j = (i[1, 9].abs() - 0.02).abs().argmin()
    i[:, 9, j] *= 0.98
    t[1, :4] = i[1, 3]
    t, i = t.to(dtype), i.to(dtype)
    dt, di = maxsim._launch_bwd(t, i, g, "nonzero", None)
    want = maxsim.maxsim_bwd_plain(t, i, g)
    for a, w in ((dt, want[0]), (di, want[1])):
        torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=_bf16_tol(w.float(), dtype))
    assert torch.equal(di[1, 3], di[1, 7]) and di[1, 3].abs().max() > 1e-3
    torch.testing.assert_close(di[1, 9].float(), want[1][1, 9].float(), rtol=0,
                               atol=_bf16_tol(want[1].float(), dtype))


def test_maxsim_bwd_kernel_one_token_collects_every_tie(dev):
    """Every text token near one direction and image token 5 of every image
    on it, as one token collects the max at random init: dI's owning warp
    adds every text row into one token; against the plain version, and two
    runs bit for bit."""
    t, i, _, g = _maxsim_inputs(6, 9, 77, 196, 256, dev, torch.float32, seed=2)
    u = torch.nn.functional.normalize(torch.randn(256, device=dev), dim=0)
    t = torch.nn.functional.normalize(u + 0.5 * t, dim=-1).contiguous()
    i[:, 5] = u
    for dtype in (torch.float32, torch.bfloat16):
        tt, ii = t.to(dtype), i.to(dtype)
        got = maxsim._launch_bwd(tt, ii, g, "nonzero", None)
        again = maxsim._launch_bwd(tt, ii, g, "nonzero", None)
        want = maxsim.maxsim_bwd_plain(tt, ii, g)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, w in zip(got, want):
            torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                       atol=_bf16_tol(w.float(), dtype))
        assert got[1][:, 5].abs().amax() > 10 * got[1][:, 6:].abs().amax()


def test_maxsim_autograd_launches_both_kernels(dev):
    t, i, _, g = _maxsim_inputs(5, 9, 77, 196, 64, dev, torch.bfloat16)
    t.requires_grad_(), i.requires_grad_()
    before = (maxsim.LAUNCHES.value, maxsim.BWD_LAUNCHES.value)
    s = maxsim.maxsim(t, i)
    got = torch.autograd.grad(s, (t, i), g)
    assert (maxsim.LAUNCHES.value, maxsim.BWD_LAUNCHES.value) == (before[0] + 1, before[1] + 1)
    # a second launch: no atomics anywhere, so the same bits
    want = maxsim._launch_bwd(t.detach(), i.detach(), g, "nonzero", None)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_maxsim_bwd_kernel_is_deterministic(dev):
    """dI adds in one fixed order (no float atomics): two runs of the
    backward at the training widths give the same bits, dT and dI."""
    t, i, _, g = _maxsim_inputs(6, 130, 77, 196, 512, dev, torch.bfloat16)
    first = maxsim._launch_bwd(t, i, g, "nonzero", None)
    second = maxsim._launch_bwd(t, i, g, "nonzero", None)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("li", [20, 196])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxsim_kernels_on_rows_whose_similarities_are_all_negative(dev, li, dtype):
    """Image tokens with positive entries only, text tokens with negative
    ones: every similarity is negative, so a zero-filled padding column that
    took part in the max would give 0. Both kernels against the plain ones."""
    rng = np.random.default_rng(5)
    t = -_l2(np.abs(rng.standard_normal((3, 12, 64)))).astype(np.float32)
    i = _l2(np.abs(rng.standard_normal((4, li, 64)))).astype(np.float32)
    g = rng.standard_normal((3, 4)).astype(np.float32)
    t, i = torch.from_numpy(t).to(dev, dtype), torch.from_numpy(i).to(dev, dtype)
    g = torch.from_numpy(g).to(dev)
    with torch.inference_mode():
        got = maxsim.maxsim(t, i)
        want = maxsim.maxsim_plain(t, i)
    assert (want < 0).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got_b = maxsim._launch_bwd(t, i, g, "nonzero", None)
    want_b = maxsim.maxsim_bwd_plain(t, i, g)
    for a, w in zip(got_b, want_b):
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=_bf16_tol(w.float(), dtype))


def test_maxsim_bwd_refuses_what_it_does_not_take(dev):
    t, i, _, g = _maxsim_inputs(2, 3, 8, 9, 16, dev, torch.float32)
    with pytest.raises(ValueError, match="g must be"):
        maxsim._launch_bwd(t, i, g[:1], "nonzero", None)
    with pytest.raises(ValueError, match="D=4104"):
        maxsim._launch_bwd(torch.zeros(2, 8, 4104, device=dev),
                           torch.zeros(3, 9, 4104, device=dev), g, "nonzero", None)
    with pytest.raises(ValueError, match="dtypes"):
        maxsim._launch_bwd(t, i.bfloat16(), g, "nonzero", None)


def _plain_kernels(monkeypatch):
    """Route CUDA tensors through the plain versions (the on-card oracle)."""
    monkeypatch.setattr(attention, "_launch_fwd", attention.fused_mha_plain)
    monkeypatch.setattr(attention, "_launch_bwd", attention.fused_mha_bwd_plain)
    monkeypatch.setattr(maxsim, "_launch_fwd", lambda t, i, mode, mask: maxsim.maxsim_plain(
        t, i, mask_mode=mode, text_mask=mask))
    monkeypatch.setattr(maxsim, "_launch_bwd", lambda t, i, g, mode, mask: maxsim.maxsim_bwd_plain(
        t, i, g, mask_mode=mode, text_mask=mask))
    monkeypatch.setattr(fused_ln, "_launch_fwd", fused_ln.layernorm_plain)
    monkeypatch.setattr(fused_ln, "_launch_bwd", fused_ln.layernorm_bwd_plain)
    monkeypatch.setattr(fused_mlp, "_launch_fwd", fused_mlp.fused_mlp_plain)
    monkeypatch.setattr(fused_mlp, "_launch_bwd", fused_mlp.fused_mlp_bwd_plain)


def test_tiny_train_step_kernels_match_plain_path(dev, monkeypatch):
    """One colclip train step of the tiny config in fp32 on the card: the
    losses and every gradient through the kernels equal those through the
    plain versions (1e-4 of each tensor's largest |g|)."""
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.standard_normal((6, 64, 64, 3)).astype(np.float32)).to(dev)
    txts = np.zeros((6, 32), np.int64)
    txts[:, 0], txts[:, 1:9], txts[:, 9] = 49406, rng.integers(1, 49000, (6, 8)), 49407
    txts = torch.from_numpy(txts).to(dev)
    results = []
    for plain in (False, True):
        if plain:
            _plain_kernels(monkeypatch)
        model, _ = create_model("ViT-S-16-test-colxlip", dev, torch.float32, seed=0)
        step = make_train_step(model.train(), create_optimizer(model, 1e-3), None,
                               TrainStepConfig(loss_type="colclip"))
        launches = (attention.BWD_LAUNCHES.value, maxsim.BWD_LAUNCHES.value)
        metrics = step(imgs, txts)
        if not plain:
            assert attention.BWD_LAUNCHES.value == launches[0] + 4   # 2 layers x 2 towers
            assert maxsim.BWD_LAUNCHES.value == launches[1] + 1
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        results.append((metrics, grads))
    (m_k, g_k), (m_p, g_p) = results
    for key in m_p:
        torch.testing.assert_close(m_k[key], m_p[key], rtol=1e-5, atol=0)
    for key, w in g_p.items():
        torch.testing.assert_close(g_k[key], w, rtol=0, atol=1e-4 * w.abs().max().item())


CE_SHAPES = [
    # (m, n, d, scale)
    (256, 256, 512, 14.3),      # one train step at batch 256
    (33, 129, 64, 30.0),        # ragged, M != N
    (100, 70, 40, 100.0),       # D not a multiple of 32, the scale at its clamp
    (65, 1000, 768, 50.0),      # the widest D the kernels take
    (130, 200, 36, 20.0),       # D not a multiple of 8: bf16 rows padded to 40
]


def _ce_inputs(m, n, d, scale, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(_l2(rng.standard_normal((m, d))).astype(np.float32)).to(dev, dtype)
    b = torch.from_numpy(_l2(rng.standard_normal((n, d))).astype(np.float32)).to(dev, dtype)
    labels = torch.from_numpy(rng.integers(0, n, m).astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.random(m).astype(np.float32) / m).to(dev)
    return a, b, labels, torch.tensor(scale, device=dev), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,d,scale", CE_SHAPES)
def test_fused_ce_kernels_match_plain(dev, m, n, d, scale, dtype):
    a, b, labels, s, g = _ce_inputs(m, n, d, scale, dev, dtype)
    before = (fused_ce.FWD_LAUNCHES.value, fused_ce.BWD_DA_LAUNCHES.value,
              fused_ce.BWD_DB_LAUNCHES.value)
    loss, lse = fused_ce._launch_fwd(a, b, labels, s)
    da, ds = fused_ce._launch_bwd_da(a, b, labels, s, lse, g)
    db = fused_ce._launch_bwd_db(a, b, labels, s, lse, g)
    torch.cuda.synchronize()
    assert (fused_ce.FWD_LAUNCHES.value, fused_ce.BWD_DA_LAUNCHES.value,
            fused_ce.BWD_DB_LAUNCHES.value) == tuple(x + 1 for x in before)
    want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(loss).all()
    # both backwards from the plain lse, so only the kernels under test differ
    want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, want_lse, g)
    want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, want_lse, g)
    for got, want in ((da, want_da), (db, want_db), (ds, want_ds)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_kernels_match_plain_when_b_is_a(dev, dtype):
    """b = a: each row's own column is its largest logit (p near 1) beside a
    label term near -g, so dz's two largest terms cancel in every row; at
    the entry point's logit scale."""
    a, _, labels, s, g = _ce_inputs(300, 300, 512, 1 / 0.07, dev, dtype, seed=1)
    b = a.clone()
    loss, lse = fused_ce._launch_fwd(a, b, labels, s)
    da, ds = fused_ce._launch_bwd_da(a, b, labels, s, lse, g)
    db = fused_ce._launch_bwd_db(a, b, labels, s, lse, g)
    want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, want_lse, g)
    want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, want_lse, g)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    for got, want in ((da, want_da), (db, want_db), (ds, want_ds)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())


def test_fused_ce_bf16_tied_at_scale_100(dev):
    """b = a at logit scale 100 ("tied-100"), bf16: each row's own logit is
    about 100, so a few fp32 steps between the forward's and the backward's
    sums of <a_i, a_i> would move p by 100 times as much. All three bf16
    kernels take raw from one logit tile, so the backward fed the kernel's
    lse meets the bar against the plain backward fed the plain lse."""
    a, _, labels, s, g = _ce_inputs(1024, 1024, 512, 100.0, dev, torch.bfloat16, seed=2)
    b = a.clone()
    loss, lse = fused_ce._launch_fwd(a, b, labels, s)
    da, ds = fused_ce._launch_bwd_da(a, b, labels, s, lse, g)
    db = fused_ce._launch_bwd_db(a, b, labels, s, lse, g)
    want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, want_lse, g)
    want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, want_lse, g)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    for got, want in ((da, want_da), (db, want_db), (ds, want_ds)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_forward_repeats_bit_for_bit(dev, dtype):
    """The forward merges its (max, sum) pairs in a fixed order: two calls
    give the same bits, one launch each."""
    a, b, labels, s, _ = _ce_inputs(300, 1000, 512, 30.0, dev, dtype, seed=3)
    before = fused_ce.FWD_LAUNCHES.value
    first = fused_ce._launch_fwd(a, b, labels, s)
    second = fused_ce._launch_fwd(a, b, labels, s)
    assert fused_ce.FWD_LAUNCHES.value == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_fused_ce_bf16_forward_takes_ragged_and_unaligned_rows(dev):
    """The wrapper pads bf16 rows to a multiple of 8 features (D = 36) and
    copies a base that is not 16-byte aligned; the result equals the call on
    aligned copies bit for bit."""
    a, b, labels, s, _ = _ce_inputs(70, 90, 36, 20.0, dev, torch.bfloat16, seed=4)
    want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    loss, lse = fused_ce._launch_fwd(a, b, labels, s)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    a, b, labels, s, _ = _ce_inputs(70, 90, 64, 20.0, dev, torch.bfloat16, seed=4)
    shifted = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
    shifted[1:] = a.reshape(-1)
    off = shifted[1:].view(a.shape)             # contiguous, base 2 bytes past 16
    assert off.data_ptr() % 16 != 0
    got = fused_ce._launch_fwd(off, b, labels, s)
    assert all(torch.equal(x, y) for x, y in zip(got, fused_ce._launch_fwd(a, b, labels, s)))


def test_fused_ce_autograd_launches_three_kernels_and_repeats_bit_for_bit(dev):
    a, b, labels, s, _ = _ce_inputs(300, 200, 512, 20.0, dev, torch.bfloat16)
    runs = []
    for _ in range(2):
        a_, b_, s_ = a.clone().requires_grad_(), b.clone().requires_grad_(), \
            s.clone().requires_grad_()
        before = (fused_ce.FWD_LAUNCHES.value, fused_ce.BWD_DA_LAUNCHES.value,
                  fused_ce.BWD_DB_LAUNCHES.value)
        loss = fused_ce.fused_contrastive_ce(a_, b_, labels, s_)
        grads = torch.autograd.grad(loss, (a_, b_, s_))
        assert (fused_ce.FWD_LAUNCHES.value, fused_ce.BWD_DA_LAUNCHES.value,
                fused_ce.BWD_DB_LAUNCHES.value) == tuple(x + 1 for x in before)
        assert grads[0].dtype == torch.bfloat16 and grads[2].shape == s.shape
        runs.append((loss.detach(), *grads))
    for first, second in zip(*runs):     # no atomics: the same bits twice
        assert torch.equal(first, second)
    want = torch.nn.functional.cross_entropy(s * a.float() @ b.float().T, labels.long())
    torch.testing.assert_close(runs[0][0], want, rtol=1e-5, atol=0)


def test_fused_ce_at_32768_holds_no_logit_matrix(dev):
    """M = N = 32768, D = 512, bf16: dense fp32 logits would be 4 GiB; the
    kernel path's peak stays under 0.5 GiB above its inputs."""
    m = 32768
    gen = torch.Generator(device="cpu").manual_seed(0)
    a = torch.nn.functional.normalize(torch.randn(m, 512, generator=gen), dim=-1).to(
        dev, torch.bfloat16).requires_grad_()
    b = torch.nn.functional.normalize(torch.randn(m, 512, generator=gen), dim=-1).to(
        dev, torch.bfloat16).requires_grad_()
    labels = torch.arange(m, device=dev)
    s = torch.tensor(100.0, device=dev, requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    loss = fused_ce.fused_contrastive_ce(a, b, labels, s)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak < 0.5 * 2**30, peak
    assert torch.isfinite(loss) and torch.isfinite(a.grad).all() and torch.isfinite(s.grad)
    want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a.detach(), b.detach(), labels, s.detach())
    torch.testing.assert_close(loss.detach(), want_loss.mean(), rtol=1e-5, atol=0)


def test_fused_ce_refuses_what_it_does_not_take(dev):
    a, b, labels, s, g = _ce_inputs(8, 9, 16, 10.0, dev, torch.float32)
    with pytest.raises(ValueError, match="D=776"):
        fused_ce.fused_contrastive_ce(torch.zeros(4, 776, device=dev),
                                      torch.zeros(5, 776, device=dev), labels[:4], s)
    with pytest.raises(ValueError, match="dtypes"):
        fused_ce.fused_contrastive_ce(a, b.bfloat16(), labels, s)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ce.fused_contrastive_ce(torch.zeros(16, 8, device=dev).T, b, labels, s)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_ce.fused_contrastive_ce(a, b.cpu(), labels, s)
    with pytest.raises(ValueError, match="labels must be"):
        fused_ce.fused_contrastive_ce(a, b, labels[:3], s)
    with pytest.raises(ValueError, match="lse must be"):
        fused_ce._launch_bwd_da(a, b, labels, s, g[:3], g)


LN_SHAPES = [
    # leading shape, D
    ((4, 197), 768),      # vision tower
    ((4, 77), 512),       # text tower and the token heads
    ((197 * 3,), 512),    # a row count that no block size divides
    ((5, 3), 40),         # D not a multiple of 32
    ((9,), 1024),         # the widest row the kernels take
]


def _ln_inputs(lead, d, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*lead, d)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((*lead, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return (torch.from_numpy(x).to(dev, dtype), torch.from_numpy(scale).to(dev),
            torch.from_numpy(bias).to(dev), torch.from_numpy(dy).to(dev, dtype))


def _fwd_tol(want: torch.Tensor, dtype) -> float:
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    return rel * max(1.0, want.abs().max().item())


def _grad_tol(want: torch.Tensor, dtype) -> float:
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    return rel * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,d", LN_SHAPES)
def test_layernorm_kernels_match_plain(dev, lead, d, dtype):
    x, scale, bias, dy = _ln_inputs(lead, d, dev, dtype)
    before = (fused_ln.FWD_LAUNCHES.value, fused_ln.BWD_LAUNCHES.value)
    y = fused_ln._launch_fwd(x, scale, bias, 1e-5)
    got = fused_ln._launch_bwd(x, scale, dy, 1e-5)
    again = fused_ln._launch_bwd(x, scale, dy, 1e-5)
    torch.cuda.synchronize()
    assert (fused_ln.FWD_LAUNCHES.value, fused_ln.BWD_LAUNCHES.value) == (
        before[0] + 1, before[1] + 2)
    want_y = fused_ln.layernorm_plain(x, scale, bias, 1e-5)
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), want_y.float(), rtol=0,
                               atol=_fwd_tol(want_y.float(), dtype))
    want = fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5)
    for g, w, dt in zip(got, want, (dtype, torch.float32, torch.float32)):
        assert g.dtype == dt and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=_grad_tol(w.float(), dtype))
    for first, second in zip(got, again):     # no atomics: the same bits twice
        assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,d", [((16, 197), 768), ((3, 5), 36), ((2, 7), 1020)])
def test_layernorm_backward_vectors_and_scalar_rows(dev, lead, d, dtype):
    """The backward at 3,152 rows of 768 (each warp walks two rows, its next
    row in flight) and at widths that are not a multiple of 8 (bf16: the same
    body with scalar loads): against the plain version, the same bits twice,
    one launch a call."""
    x, scale, _, dy = _ln_inputs(lead, d, dev, dtype, seed=5)
    before = fused_ln.BWD_LAUNCHES.value
    got = fused_ln._launch_bwd(x, scale, dy, 1e-5)
    again = fused_ln._launch_bwd(x, scale, dy, 1e-5)
    assert fused_ln.BWD_LAUNCHES.value == before + 2
    want = fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=_grad_tol(w.float(), dtype))
    for first, second in zip(got, again):
        assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_backward_unaligned_rows_take_the_same_arithmetic(dev, dtype):
    """x whose base is not 16-byte aligned takes the scalar loads; the lane
    mapping and the sums are the vector path's, so dx, dscale and dbias equal
    the aligned call's bit for bit."""
    x, scale, _, dy = _ln_inputs((6, 77), 512, dev, dtype, seed=6)
    shifted = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    shifted[1:] = x.reshape(-1)
    off = shifted[1:].view(x.shape)
    assert off.data_ptr() % 16 != 0
    got = fused_ln._launch_bwd(off, scale, dy, 1e-5)
    want = fused_ln._launch_bwd(x, scale, dy, 1e-5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_layernorm_autograd_launches_both_kernels(dev):
    x, scale, bias, dy = _ln_inputs((3, 77), 512, dev, torch.bfloat16)
    x.requires_grad_(), scale.requires_grad_(), bias.requires_grad_()
    before = (fused_ln.FWD_LAUNCHES.value, fused_ln.BWD_LAUNCHES.value)
    tokens = fused_ln.fused_layernorm(x[:, 1:], scale, bias)      # a view, as the token head's
    got = torch.autograd.grad(tokens, (x, scale, bias), dy[:, 1:])
    assert (fused_ln.FWD_LAUNCHES.value, fused_ln.BWD_LAUNCHES.value) == (
        before[0] + 1, before[1] + 1)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    want = fused_ln._launch_bwd(x.detach()[:, 1:].contiguous(), scale.detach(),
                                dy[:, 1:].contiguous(), 1e-5)
    assert torch.equal(got[0][:, 1:], want[0]) and not got[0][:, 0].any()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_layernorm_refuses_what_it_does_not_take(dev):
    x, scale, bias, dy = _ln_inputs((4,), 64, dev, torch.float32)
    assert not fused_ln.fused_ln_supported((4, 1025), torch.float32)
    assert not fused_ln.fused_ln_supported((4, 64), torch.float16)
    assert fused_ln.fused_ln_supported((4, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="outside the kernels' range"):
        fused_ln.fused_layernorm(torch.zeros(4, 1025, device=dev), torch.ones(1025, device=dev),
                                 torch.zeros(1025, device=dev))
    with pytest.raises(ValueError, match="outside the kernels' range"):
        fused_ln.fused_layernorm(x.half(), scale, bias)
    # the module under 'fused' raises too: it never gives way to F.layer_norm
    from colxlip_tpu_torch.models import layers
    with pytest.raises(ValueError, match="outside the kernels' range"):
        layers.LayerNorm(1025, impl="fused").to(dev)(torch.zeros(4, 1025, device=dev))
    with pytest.raises(ValueError, match="outside the kernels' range"):
        layers.LayerNorm(64, impl="fused").to(dev)(x.half())
    with pytest.raises(ValueError, match="scale and bias must be"):
        fused_ln.fused_layernorm(x, scale.bfloat16(), bias)
    with pytest.raises(ValueError, match="unsupported devices"):
        fused_ln.fused_layernorm(x, scale.cpu(), bias)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ln._launch_fwd(torch.zeros(64, 4, device=dev).T, scale, bias, 1e-5)
    with pytest.raises(ValueError, match="dy must be"):
        fused_ln._launch_bwd(x, scale, dy.bfloat16(), 1e-5)


MLP_SHAPES = [
    # (b, n, d, h)
    (2, 197, 768, 3072),    # vision tower
    (3, 77, 512, 2048),     # text tower, a row count that no tile divides
    (2, 17, 128, 512),      # the tiny config
    (1, 70, 40, 100),       # D and H that no tile divides (float32 only: bf16 needs 8 | H)
    (1, 70, 40, 104),       # D and H that no tile divides, multiples of 8 as bf16 needs
    (1, 300, 64, 96),       # several row ranges in the dW passes
    (16, 257, 1024, 4096),  # ViT-L/14: float32 cuts the owned features into two slices
    (1, 70, 1000, 4000),    # float32 past 768 at a D and H that no tile or slice divides
]


def _mlp_inputs(b, n, d, h, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(
            dev, dtype)

    return (t((b, n, d), 1.0), t((h, d), d ** -0.5), t((h,), 0.1), t((h, d), h ** -0.5),
            t((d,), 0.1), t((b, n, d), 1.0))


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,h", MLP_SHAPES)
def test_mlp_kernels_match_plain(dev, b, n, d, h, dtype, approximate):
    x, w1, b1, w2, b2, dy = _mlp_inputs(b, n, d, h, dev, dtype)
    if dtype == torch.bfloat16 and (d % 8 or h % 8):
        with pytest.raises(ValueError, match="multiples of 8"):
            fused_mlp._launch_fwd(x, w1, b1, w2, b2, approximate)
        return
    before = (fused_mlp.FWD_LAUNCHES.value, fused_mlp.BWD_LAUNCHES.value)
    out = fused_mlp._launch_fwd(x, w1, b1, w2, b2, approximate)
    got = fused_mlp._launch_bwd(x, w1, b1, w2, dy, approximate)
    again = fused_mlp._launch_bwd(x, w1, b1, w2, dy, approximate)
    torch.cuda.synchronize()
    assert (fused_mlp.FWD_LAUNCHES.value, fused_mlp.BWD_LAUNCHES.value) == (
        before[0] + 1, before[1] + 2)
    assert out.dtype == dtype and out.shape == x.shape
    if dtype == torch.bfloat16:
        _assert_inside_mlp_bar(out, fused_mlp_check.forward_bar(x, w1, b1, w2, b2, approximate))
    else:
        want_out = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, approximate)
        torch.testing.assert_close(out.float(), want_out.float(), rtol=0,
                                   atol=_fwd_tol(want_out.float(), dtype))
    want = fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, approximate)
    for g, w, dt in zip(got, want, (dtype,) + (torch.float32,) * 4):
        assert g.dtype == dt and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=_grad_tol(w.float(), dtype))
    for first, second in zip(got, again):     # no atomics: the same bits twice
        assert torch.equal(first, second)


def _assert_inside_mlp_bar(out, bar):
    report = fused_mlp_check.check_forward(out, bar)
    assert report["ok"], fused_mlp_check.describe(report)


def _mlp_draw(seed, dev):
    """scripts/torch_mlp_bench.py's inputs(256, 197, 768, 3072, seed): the
    vision shape."""
    gen = torch.Generator().manual_seed(seed)

    def t(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(dev, torch.bfloat16)

    b, n, d, h = 256, 197, 768, 3072
    return (t((b, n, d), 1.0), t((h, d), d ** -0.5), t((h,), 0.1), t((h, d), h ** -0.5),
            t((d,), 0.1))


# The two draws of 32 on which the forward missed the former bar (2^-7 of
# max(1, max |out|) against the plain version's cuBLAS sums): one element two
# bf16 steps off where the bias add rounds a one-step difference of the sum
# to two. The per-element bar allows that only where the exact sum lies
# within the fp32 error of a rounding midpoint.
@pytest.mark.parametrize("seed", [24, 25])
def test_mlp_bf16_forward_meets_its_bar_on_the_witness_draw(dev, seed):
    args = _mlp_draw(seed, dev)
    out = fused_mlp._launch_fwd(*args, False)
    _assert_inside_mlp_bar(out, fused_mlp_check.forward_bar(*args, False))


def test_mlp_bf16_forward_bar_refuses_its_controls(dev):
    """The bar is no formality: the forward with its K sums kept in bf16
    (rounded every k-step of 16) and the kernel's output with one element
    moved three bf16 steps both fail it."""
    x, w1, b1, w2, b2 = _mlp_draw(24, dev)
    x = x[:8]                                     # 1,576 rows
    bar = fused_mlp_check.forward_bar(x, w1, b1, w2, b2, False)
    out = fused_mlp._launch_fwd(x, w1, b1, w2, b2, False)
    _assert_inside_mlp_bar(out, bar)
    with pytest.raises(AssertionError, match="OUTSIDE"):
        _assert_inside_mlp_bar(fused_mlp_check.bf16_sum_forward(x, w1, b1, w2, b2, False), bar)
    with pytest.raises(AssertionError, match="OUTSIDE"):
        _assert_inside_mlp_bar(fused_mlp_check.moved_three_steps(out, bar), bar)


def test_mlp_autograd_launches_both_kernels(dev):
    tensors = _mlp_inputs(2, 77, 512, 2048, dev, torch.bfloat16)
    x, w1, b1, w2, b2 = (t.requires_grad_() for t in tensors[:5])
    before = (fused_mlp.FWD_LAUNCHES.value, fused_mlp.BWD_LAUNCHES.value)
    out = fused_mlp.fused_mlp(x, w1, b1, w2, b2)
    got = torch.autograd.grad(out, (x, w1, b1, w2, b2), tensors[5])
    assert (fused_mlp.FWD_LAUNCHES.value, fused_mlp.BWD_LAUNCHES.value) == (
        before[0] + 1, before[1] + 1)
    want = fused_mlp._launch_bwd(*(t.detach() for t in (x, w1, b1, w2)), tensors[5], False)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


def test_mlp_refuses_what_it_does_not_take(dev):
    x, w1, b1, w2, b2, dy = _mlp_inputs(1, 8, 32, 64, dev, torch.float32)
    # float32 takes D = 800 (two feature slices past 768) ...
    args32 = _mlp_inputs(1, 8, 800, 64, dev, torch.float32)[:5]
    wide32 = fused_mlp.fused_mlp(*args32)
    want32 = fused_mlp.fused_mlp_plain(*args32)
    torch.testing.assert_close(wide32, want32, rtol=0, atol=_fwd_tol(want32, torch.float32))
    # bfloat16 takes D = 800 (the tensor-core tiles have no D limit) ...
    wide = fused_mlp.fused_mlp(*_mlp_inputs(1, 8, 800, 64, dev, torch.bfloat16)[:5])
    assert wide.shape == (1, 8, 800) and torch.isfinite(wide.float()).all()
    # ... but needs 16-byte rows: D and H multiples of 8, operands on 16 bytes
    for d, h in ((36, 64), (32, 100)):
        with pytest.raises(ValueError, match="multiples of 8"):
            fused_mlp.fused_mlp(*_mlp_inputs(1, 8, d, h, dev, torch.bfloat16)[:5])
    xb, w1b, b1b, w2b, b2b, dyb = _mlp_inputs(1, 8, 32, 64, dev, torch.bfloat16)
    shifted = torch.zeros(1 + xb.numel(), dtype=torch.bfloat16, device=dev)[1:].view(xb.shape)
    with pytest.raises(ValueError, match="16 bytes"):
        fused_mlp.fused_mlp(shifted, w1b, b1b, w2b, b2b)
    with pytest.raises(ValueError, match="16 bytes"):
        fused_mlp._launch_bwd(xb, w1b, b1b, w2b, shifted, False)
    with pytest.raises(ValueError, match="share the compute dtype"):
        fused_mlp.fused_mlp(x, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(ValueError, match="not supported"):
        fused_mlp.fused_mlp(*(t.half() for t in (x, w1, b1, w2, b2)))
    with pytest.raises(ValueError, match="hidden-major"):
        fused_mlp.fused_mlp(x, w1, b1, w2.T.contiguous(), b2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp.fused_mlp(x, w1, b1, torch.zeros(32, 64, device=dev).T, b2)
    with pytest.raises(ValueError, match="unsupported devices"):
        fused_mlp.fused_mlp(x, w1.cpu(), b1, w2, b2)
    with pytest.raises(ValueError, match="dy must be"):
        fused_mlp._launch_bwd(x, w1, b1, w2, dy.bfloat16(), False)


def test_tiny_train_step_through_fused_towers_matches_plain_path(dev, monkeypatch):
    """One colclip step of the tiny config in fp32 with COLXLIP_LN_IMPL=fused
    COLXLIP_MLP_IMPL=fused: every LayerNorm and MLP launches its kernels, and
    the losses and gradients equal those through the plain versions."""
    monkeypatch.setenv("COLXLIP_LN_IMPL", "fused")
    monkeypatch.setenv("COLXLIP_MLP_IMPL", "fused")
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.standard_normal((6, 64, 64, 3)).astype(np.float32)).to(dev)
    txts = np.zeros((6, 32), np.int64)
    txts[:, 0], txts[:, 1:9], txts[:, 9] = 49406, rng.integers(1, 49000, (6, 8)), 49407
    txts = torch.from_numpy(txts).to(dev)
    counters = (fused_ln.FWD_LAUNCHES, fused_ln.BWD_LAUNCHES, fused_mlp.FWD_LAUNCHES,
                fused_mlp.BWD_LAUNCHES)
    results = []
    for plain in (False, True):
        if plain:
            _plain_kernels(monkeypatch)
        model, _ = create_model("ViT-S-16-test-colxlip", dev, torch.float32, seed=0)
        step = make_train_step(model.train(), create_optimizer(model, 1e-3), None,
                               TrainStepConfig(loss_type="colclip"))
        before = [c.value for c in counters]
        metrics = step(imgs, txts)
        launched = [c.value - b for c, b in zip(counters, before)]
        # vision ln_pre + 2 x 2 + ln_post + 2 in the head, text 2 x 2 + ln_final + 2
        assert launched == ([0, 0, 0, 0] if plain else [15, 15, 4, 4])
        results.append((metrics, {k: p.grad.clone() for k, p in model.named_parameters()}))
    (m_k, g_k), (m_p, g_p) = results
    for key in m_p:
        torch.testing.assert_close(m_k[key], m_p[key], rtol=1e-5, atol=0)
    for key, w in g_p.items():
        torch.testing.assert_close(g_k[key], w, rtol=0, atol=1e-4 * w.abs().max().item())


QUANT_SHAPES = [
    # every distinct Dense shape of ViT-B-16-colxlip, as [K, N] = [in, out]
    (768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 512),
    (512, 1536), (512, 512), (512, 2048), (2048, 512),
    (197, 129),                 # ragged: N not a multiple of 4, scalar loads
    (1, 5), (65, 4),
    # slices too tall to keep in a cluster's shared memory: read again from L2
    (4096, 1024),               # ViT-L-14's c_proj
    (16384, 260),               # a K of 16,384, a strip of 4 live columns at the end
]


def _quant_weight(k, n, seed=0):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.05
    if n > 4:
        w[:, 1] = 0.0                                   # an all-zero column
        w[:, 2] = np.round(w[:, 2] / np.abs(w[:, 2]).max() * 127)    # integers, absmax 127
    return w


@pytest.mark.parametrize("seed", [0, 1, (1 << 64) - 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", QUANT_SHAPES)
def test_quantize_int8_kernel_equals_plain_bit_for_bit(dev, k, n, dtype, seed):
    w = torch.from_numpy(_quant_weight(k, n)).to(dev, dtype)
    before = quantization.LAUNCHES.value
    values, scales = quantization.quantize_int8(w, seed=seed)
    assert quantization.LAUNCHES.value == before + 1
    want_values, want_scales = quantization.quantize_int8_plain(w, seed)
    torch.cuda.synchronize()
    assert values.dtype == torch.int8 and values.shape == (k, n)
    assert scales.dtype == torch.float32 and scales.shape == (1, n)
    assert torch.equal(scales, want_scales)
    assert torch.equal(values, want_values), (values != want_values).sum().item()
    # the CPU's plain version computes the same numbers
    cpu_values, cpu_scales = quantization.quantize_int8(w.cpu(), seed=seed)
    assert torch.equal(values.cpu(), cpu_values) and torch.equal(scales.cpu(), cpu_scales)
    rtn_values, rtn_scales = quantization.quantize_int8_rtn(w)
    assert torch.equal(scales, rtn_scales)
    assert (values.int() - rtn_values.int()).abs().max() <= 1


@pytest.mark.parametrize("k,n,dtype", [(768, 3072, torch.float32), (768, 3072, torch.bfloat16),
                                       (4096, 1024, torch.float32), (197, 129, torch.float32)])
def test_quantize_int8_is_one_kernel_a_call(dev, k, n, dtype):
    """One launch: no memset and no second kernel (torch.profiler's device
    operations), on the kept path, the tall path and the scalar path."""
    from torch.profiler import ProfilerActivity, profile

    w = torch.from_numpy(_quant_weight(k, n)).to(dev, dtype)
    quantization.quantize_int8(w, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for seed in range(5):
            quantization.quantize_int8(w, seed=seed)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in device) == 5, [(e.key, e.count) for e in device]
    assert all("quantize_kernel" in e.key for e in device), [e.key for e in device]


def test_quantize_int8_kernel_seeds_and_views(dev):
    w = torch.from_numpy(_quant_weight(768, 512)).to(dev)
    a, b, c = (quantization.quantize_int8(w, seed=s)[0] for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a contiguous view at an odd offset is not 16-byte aligned: the scalar path
    flat = torch.zeros(768 * 512 + 1, device=dev)
    flat[1:] = w.reshape(-1)
    view = flat[1:].view(768, 512)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert torch.equal(quantization.quantize_int8(view, seed=3)[0], a)
    gen = torch.Generator(device=dev).manual_seed(0)
    d, e = (quantization.quantize_int8(w, generator=gen)[0] for _ in range(2))
    assert not torch.equal(d, e)


def test_quantize_int8_refuses_what_it_does_not_take(dev):
    w = torch.randn(64, 32, device=dev)
    before = quantization.LAUNCHES.value
    for bad, match in ((w.t(), "not contiguous"), (w[:, ::2], "not contiguous"),
                       (w.reshape(4, 16, 32), "contiguous, non-empty"),
                       (w.half(), "float16"), (w.double(), "float64"),
                       (w[:0], "non-empty")):
        with pytest.raises(ValueError, match=match):
            quantization.quantize_int8(bad)
    assert quantization.LAUNCHES.value == before


@pytest.mark.parametrize("r,k,n", [(3, 512, 512), (3, 768, 512), (1, 24, 40), (5, 13, 7),
                                   (77, 512, 588), (64 * 197, 768, 2304)])
def test_int8_mm_on_the_card_equals_the_cpu(dev, r, k, n):
    """torch._int_mm refuses fewer than 17 rows and ragged K or N: int8_mm
    pads, and the int32 sums equal the CPU's bit for bit."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (r, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    got = quantization.int8_mm(a.to(dev), w.to(dev))
    assert got.dtype == torch.int32 and got.shape == (r, n)
    assert torch.equal(got.cpu(), quantization.int8_mm(a, w))
    if r <= 16:
        with pytest.raises(RuntimeError):
            torch._int_mm(a.to(dev), w.to(dev).t())


@pytest.mark.parametrize("mask_mode", ["nonzero", "plain", "valid"])
def test_maxsim_int8_forward_on_the_card_equals_the_cpu(dev, mask_mode):
    rng = np.random.default_rng(1)
    m, k, lt, li, d = 19, 3, 77, 196, 512            # K * Li = 588: not a multiple of 8
    text = _l2(rng.standard_normal((m, lt, d))).astype(np.float32)
    text[:, 40:] = 0.0
    image = _l2(rng.standard_normal((k, li, d))).astype(np.float32)
    mask = (np.arange(lt)[None, :] < 40).astype(np.float32).repeat(m, 0)
    t, i, tm = (torch.from_numpy(x) for x in (text, image, mask))
    before = maxsim.LAUNCHES.value
    got = maxsim.maxsim(t.to(dev), i.to(dev), mask_mode=mask_mode, text_mask=tm.to(dev),
                        impl="streaming_int8")
    assert maxsim.LAUNCHES.value == before           # a library product, not the kernel
    want = maxsim.maxsim(t, i, mask_mode=mask_mode, text_mask=tm, impl="streaming_int8")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    default = maxsim.maxsim(t.to(dev), i.to(dev), mask_mode=mask_mode, text_mask=tm.to(dev))
    assert 0 < (got - default).abs().max() < 2e-2
    # straight-through: the backward kernel on the same inputs as the default's.
    # dT equal bit for bit; dI is summed with shared-memory float atomics whose
    # order changes from run to run, so it is held to the order's bar (1e-5 of
    # the largest |gradient|), as two runs of the default backward would be
    grads = []
    for impl in ("streaming_int8", "auto"):
        tt, ii = t.to(dev).requires_grad_(), i.to(dev).requires_grad_()
        launched = maxsim.BWD_LAUNCHES.value
        out = maxsim.maxsim(tt, ii, mask_mode=mask_mode, text_mask=tm.to(dev), impl=impl)
        grads.append(torch.autograd.grad(out.sum(), (tt, ii)))
        assert maxsim.BWD_LAUNCHES.value == launched + 1
    (dt_a, di_a), (dt_b, di_b) = grads
    assert torch.equal(dt_a, dt_b)
    torch.testing.assert_close(di_a, di_b, rtol=0, atol=1e-5 * di_b.abs().max().item())


def test_int8_encoders_on_the_card(dev):
    """Both int8 encoders of the tiny model on the card: cosine above 0.99
    against the fp32 model (the JAX tests' bar), through the attention kernel."""
    from colxlip_tpu_torch.serving import (
        quantize_text_params, quantize_vision_params, text_encode_int8, vision_encode_int8)

    model, cfg = create_model("ViT-S-16-test", dev, torch.float32, seed=0)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((3, 64, 64, 3)).astype(np.float32)).to(dev)
    texts = np.zeros((3, 32), np.int64)
    texts[:, 0], texts[:, 1:9], texts[:, 9] = 49406, rng.integers(1, 49000, (3, 8)), 49407
    texts = torch.from_numpy(texts).to(dev)
    before = attention.LAUNCHES.value
    with torch.no_grad():
        pairs = [(model.encode_image(images, normalize=True),
                  vision_encode_int8(cfg, quantize_vision_params(model), images)),
                 (model.encode_text(texts, normalize=True),
                  text_encode_int8(cfg, quantize_text_params(model), texts))]
    assert attention.LAUNCHES.value == before + 8    # 2 blocks x 2 towers x 2 models
    for ref, got in pairs:
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert (ref.float() * got).sum(dim=-1).min() > 0.99


# ---------------------------------------------------------------------------
# the attention and GELU dispatch on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["xla", "xla_bf16", "xla_remat", "flash"])
def test_attention_dispatch_paths_on_the_card(dev, impl, causal):
    """Each library path on bf16 [B, N, H, D] against the attention kernel
    on the same inputs, within 2^-6 of max|v| (the paths round the
    probabilities at different places: tests/test_torch_attention_dispatch.py),
    with no kernel launch; 'flash' refuses float32, where torch has no flash
    backend on the card."""
    b, n, h, d = 2, 197, 12, 64
    q, k, v = (torch.from_numpy(_qkv(b, n, h * d, seed=s)[..., :h * d].reshape(b, n, h, d))
               .to(dev, torch.bfloat16) for s in range(3))
    with torch.inference_mode():
        want = attention.multi_head_attention(q, k, v, causal=causal, impl="fused")
        before = attention.LAUNCHES.value
        got = attention.multi_head_attention(q, k, v, causal=causal, impl=impl)
    assert attention.LAUNCHES.value == before
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, h, d)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -6 * v.float().abs().max().item(), err
    if impl == "flash":
        with pytest.raises(RuntimeError):
            attention.multi_head_attention(q.float(), k.float(), v.float(), impl="flash")


def test_fp32_past_the_kernel_limit_takes_the_library_path(dev):
    """float32 at one token past the forward kernel's limit: 'fused' refuses
    and names COLXLIP_ATTN_IMPL=xla; the module built with 'xla' runs it and
    agrees with the plain version to 1e-5."""
    from colxlip_tpu_torch.models.layers import MultiHeadAttention

    n = attention.fp32_max_seq(64, False) + 1
    x = torch.from_numpy(_qkv(1, n, 64)[..., :128]).to(dev)
    fused = MultiHeadAttention(128, 2, dtype=torch.float32, attn_impl="fused").to(dev)
    for p in fused.parameters():
        torch.nn.init.normal_(p, std=0.1)
    with pytest.raises(ValueError, match="COLXLIP_ATTN_IMPL=xla"), torch.no_grad():
        fused(x)
    lib = MultiHeadAttention(128, 2, dtype=torch.float32, attn_impl="xla").to(dev)
    lib.load_state_dict(fused.state_dict())
    with torch.no_grad():
        got = lib(x)
        qkv = torch.nn.functional.linear(x, fused.in_proj_weight, fused.in_proj_bias)
        want = fused.out_proj(attention.fused_mha_plain(qkv, 2))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["stock", "aspoly", "fast", "fast9"])
def test_gelu_impls_on_the_card_equal_the_cpu(dev, impl, monkeypatch):
    """'stock' is the library's GELU on each device: the port's ``gelu`` is
    ``F.gelu`` on the card bit for bit. The three formulas, value and
    gradient, in fp32 on the card within 1e-6 of the same formula on the
    CPU (about one fp32 step at |x| 8: the card's exp and tanh against the
    CPU's)."""
    from colxlip_tpu_torch.models import layers

    monkeypatch.setenv("COLXLIP_GELU_IMPL", impl)
    x = torch.linspace(-8, 8, 10001)
    if impl == "stock":
        xd = x.to(dev)
        assert torch.equal(layers.gelu(xd), torch.nn.functional.gelu(xd))
        return
    out = {}
    for where in ("cpu", dev):
        xt = x.to(where).requires_grad_()
        y = layers.gelu(xt)
        (g,) = torch.autograd.grad(y.sum(), xt)
        out[str(where)] = (y.detach().cpu(), g.cpu())
    (y0, g0), (y1, g1) = out.values()
    torch.testing.assert_close(y1, y0, rtol=0, atol=1e-6)
    torch.testing.assert_close(g1, g0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("wire", ["uint8", "yuv420"])
def test_packed_feed_on_the_card(dev, wire):
    """The ship stage's pinned copy of a packed buffer and its unpacking on
    the card give back the host batch bit for bit; a YUV420 batch decodes on
    the card within the JAX bar (2e-4) of the numpy reference."""
    from colxlip_tpu_torch.ops import yuv420
    from colxlip_tpu_torch.parallel.data_feed import DeviceFeeder, unpack_batch

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 32, 48, 3), dtype=np.uint8)
    if wire == "yuv420":
        images = yuv420.rgb_to_yuv420(images)
    texts = rng.integers(0, 49408, (4, 77)).astype(np.int32)
    buf, none = DeviceFeeder(dev, packed=True)(images, texts)
    assert none is None and buf.device == dev
    got_i, got_t = unpack_batch(buf, images.shape[1:], 77)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got_i.cpu().numpy(), images)
    np.testing.assert_array_equal(got_t.cpu().numpy(), texts)
    if wire == "yuv420":
        mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
        got = yuv420.decode_yuv420(got_i, mean, std).cpu().numpy()
        ref = (yuv420.yuv420_to_rgb(images) / 255.0 - np.asarray(mean, np.float32)) / \
            np.asarray(std, np.float32)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


@pytest.fixture
def nccl_group(dev):
    """A torch.distributed NCCL group of one on cuda:0 (NCCL refuses two
    ranks on one GPU)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _tiny_step(dev, cfg, mesh, seed=0):
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.standard_normal((6, 64, 64, 3)).astype(np.float32)).to(dev)
    txts = np.zeros((6, 32), np.int64)
    txts[:, 0], txts[:, 1:9], txts[:, 9] = 49406, rng.integers(1, 49000, (6, 8)), 49407
    model, _ = create_model("ViT-S-16-test-colxlip", dev, torch.float32, seed=0)
    step = make_train_step(model.train(), create_optimizer(model, 1e-3), None, cfg, mesh=mesh)
    metrics = step(imgs, torch.from_numpy(txts).to(dev))
    return metrics, {k: p.detach().clone() for k, p in model.named_parameters()}, \
        {k: p.grad.clone() for k, p in model.named_parameters()}


def test_nccl_group_of_one_full_mode_step_is_the_one_device_step(dev, nccl_group):
    """make_train_step(mesh=<NCCL group of one>) in full mode: the gathers,
    the gradient all-reduce and the parameter broadcast run on NCCL with
    CUDA tensors, and the step gives the one-device step's metrics and
    parameters bit for bit."""
    cfg = TrainStepConfig(loss_type="colclip")
    m1, p1, g1 = _tiny_step(dev, cfg, None)
    mg, pg, gg = _tiny_step(dev, cfg, nccl_group)
    for key in m1:
        assert torch.equal(mg[key], m1[key]), key
    for key in p1:
        assert torch.equal(gg[key], g1[key]) and torch.equal(pg[key], p1[key]), key


@pytest.mark.parametrize("kw", [
    dict(loss_type="colclip", local_loss=True, gather_with_grad=True),
    dict(loss_type="colclip", local_loss=True, gather_with_grad=True, token_dist="ring",
         token_neighborhood=2),
    dict(loss_type="clip", local_loss=True, gather_with_grad=True, ce_impl="fused"),
], ids=["local", "ring_cap2", "clip_fused_local"])
def test_nccl_group_of_one_local_loss_step_is_the_one_device_step(dev, nccl_group, kw):
    """The local-loss branches under the group of one, fp32: with the
    gather's gradient they are the one-device loss term for term, so the
    metrics agree within 1e-5 and every gradient within 1e-4 of its largest
    |g| (fp32 sums in another order: two MaxSim or CE calls where one device
    makes one)."""
    cfg = TrainStepConfig(**kw)
    m1, _, g1 = _tiny_step(dev, cfg, None)
    mg, _, gg = _tiny_step(dev, cfg, nccl_group)
    for key in m1:
        torch.testing.assert_close(mg[key], m1[key], rtol=1e-5, atol=0)
    for key, w in g1.items():
        torch.testing.assert_close(gg[key], w, rtol=0, atol=1e-4 * w.abs().max().item())


def test_nccl_collectives_of_one_rank(dev, nccl_group):
    """The gathers (with and without grad, local loss), the ring shift, the
    string broadcast and the stop consensus on NCCL with CUDA tensors."""
    from colxlip_tpu_torch.parallel import collectives
    from colxlip_tpu_torch.parallel.mesh import broadcast_str, collective_device
    from colxlip_tpu_torch.training.train import _stop_consensus

    assert collective_device(nccl_group) == dev
    x = torch.randn(5, 7, device=dev, dtype=torch.bfloat16, requires_grad=True)
    for kw in (dict(gather_with_grad=True), dict(), dict(local_loss=True)):
        y = collectives.gather_features(x, axis_name="data", **kw)
        assert torch.equal(y, x)
        assert y.requires_grad == (not kw.get("local_loss"))
    (collectives.gather_features(x, axis_name="data", gather_with_grad=True) * 3).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3))
    assert torch.equal(collectives.ring_shift(x, "data", 1), x)
    assert broadcast_str("run-name", nccl_group) == "run-name"
    assert _stop_consensus(True, nccl_group, dev) and not _stop_consensus(False, nccl_group, dev)
