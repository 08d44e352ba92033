"""colxlip_tpu_torch CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one: a CUDA kernel has no CPU mode. The file imports only torch,
numpy and the port, so it runs where the JAX package is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: fp32 outputs 1e-5 (summation order only); bf16 attention 4e-3
(one bf16 rounding step of an output below 1 in magnitude).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from colxlip_tpu_torch.factory import create_model
from colxlip_tpu_torch.ops import attention, maxsim
from colxlip_tpu_torch.serving.server import InferenceEngine

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
    with pytest.raises(RuntimeError, match="forward-only"):
        attention.fused_mha_packed(torch.zeros(2, 8, 192, device=dev,
                                               requires_grad=True), 2)


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
