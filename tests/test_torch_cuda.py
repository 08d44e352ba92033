"""colxlip_tpu_torch CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one: a CUDA kernel has no CPU mode. The file imports only torch,
numpy and the port, so it runs where the JAX package is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: fp32 outputs 1e-5 (summation order only); bf16 attention 4e-3
(one bf16 rounding step of an output below 1 in magnitude); bf16 gradients
2^-7 of the largest |grad| (each gradient is summed in fp32 and rounded to
bf16 once, and the attention backward also rounds dz and p to bf16, where
the kernel and the plain version may land one step apart).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from colxlip_tpu_torch.factory import create_model
from colxlip_tpu_torch.ops import attention, maxsim
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.serving.server import InferenceEngine
from colxlip_tpu_torch.training.optim import create_optimizer

pytestmark = pytest.mark.cuda

ATTN_SHAPES = [
    # (b, n, heads, hd, causal)
    (2, 197, 12, 768, False),   # vision tower
    (2, 77, 8, 512, True),      # text tower, causal
    (3, 16, 4, 128, True),      # odd batch, head_dim 32
    (1, 256, 2, 128, False),    # the longest sequence the kernel takes
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
    with pytest.raises(ValueError, match="seq"):
        attention.fused_mha_packed(torch.zeros(1, 257, 192, device=dev), 2)
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


@pytest.mark.parametrize("mask_mode", ["nonzero", "plain", "valid"])
@pytest.mark.parametrize("m,k,lt,li,d", [
    (6, 130, 77, 196, 512),     # serving widths, K not a multiple of anything
    (3, 5, 80, 256, 40),        # largest Lt/Li, D not a multiple of 32
    (4, 7, 32, 16, 128),        # the tiny config's token shapes
])
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


def test_maxsim_kernel_refuses_what_it_does_not_take(dev):
    t = torch.zeros(2, 81, 16, device=dev)
    i = torch.zeros(3, 9, 16, device=dev)
    with pytest.raises(ValueError, match="Lt=81"):
        maxsim.maxsim(t, i)
    with pytest.raises(ValueError, match="both must be on one CUDA device"):
        maxsim.maxsim(t[:, :8], i.cpu())
    with pytest.raises(ValueError, match="text_mask must be"):
        maxsim.maxsim(t[:, :8].contiguous(), i, mask_mode="valid",
                      text_mask=torch.ones(2, 8, device=dev, dtype=torch.float64))


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
@pytest.mark.parametrize("m,k,lt,li,d", [
    (6, 130, 77, 196, 512),     # training widths, K not a multiple of anything
    (3, 5, 80, 256, 40),        # largest Lt/Li, D not a multiple of 32
    (4, 7, 32, 16, 128),        # the tiny config's token shapes
])
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


def test_maxsim_autograd_launches_both_kernels(dev):
    t, i, _, g = _maxsim_inputs(5, 9, 77, 196, 64, dev, torch.bfloat16)
    t.requires_grad_(), i.requires_grad_()
    before = (maxsim.LAUNCHES.value, maxsim.BWD_LAUNCHES.value)
    s = maxsim.maxsim(t, i)
    got = torch.autograd.grad(s, (t, i), g)
    assert (maxsim.LAUNCHES.value, maxsim.BWD_LAUNCHES.value) == (before[0] + 1, before[1] + 1)
    # a second launch: dI's float atomics may sum in another order
    want = maxsim._launch_bwd(t.detach(), i.detach(), g, "nonzero", None)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=_bf16_tol(w.float(), torch.bfloat16))


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
