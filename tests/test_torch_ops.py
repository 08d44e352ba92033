"""colxlip_tpu_torch ops: each kernel's plain PyTorch version against the JAX
package's TPU kernel (Pallas interpret mode, as the JAX tests run it on the
CPU) and its XLA reference, on the same seeded numpy inputs.

On the CPU the wrappers take the plain version (the CUDA kernels run only on
the card); tests/test_torch_cuda.py compares each kernel with its plain
version there.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.ops.fused_attention import fused_mha_packed, fused_mha_reference
from colxlip_tpu.ops.maxsim import maxsim_xla
from colxlip_tpu.ops.maxsim_pallas import maxsim_pallas
from colxlip_tpu_torch.ops import attention, build, maxsim

ATTN_SHAPES = [
    # (b, n, heads, hd, causal)
    (2, 197, 12, 768, False),   # vision tower
    (2, 77, 8, 512, True),      # text tower, causal
    (3, 16, 4, 128, True),      # odd batch, head_dim 32
]
ATTN_ATOL = 2e-5                # fp32; the same bar as tests/test_fused_attention.py
MAXSIM_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, n, hd, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, n, 3 * hd)) * 0.3
            ).astype(np.float32)


def _l2(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _tokens(seed=0, m=5, k=7, lt=12, li=196, d=64):
    """Unit-norm text/image token features; K=7 is no multiple of 128 and
    some text rows end in zero tokens (the 'nonzero' mask's case)."""
    rng = np.random.default_rng(seed)
    t = _l2(rng.standard_normal((m, lt, d))).astype(np.float32)
    t[0, 6:] = 0.0
    t[2, 3:] = 0.0
    i = _l2(rng.standard_normal((k, li, d))).astype(np.float32)
    mask = (rng.random((m, lt)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return t, i, mask


@pytest.mark.parametrize("oracle", ["pallas_interpret", "reference"])
@pytest.mark.parametrize("b,n,heads,hd,causal", ATTN_SHAPES)
def test_attention_plain_matches_jax(b, n, heads, hd, causal, oracle):
    qkv = _qkv(b, n, hd)
    if oracle == "pallas_interpret":
        want = fused_mha_packed(jnp.asarray(qkv), heads, causal, 0, True)
    else:
        want = fused_mha_reference(jnp.asarray(qkv), heads, causal)
    got = attention.fused_mha_plain(torch.from_numpy(qkv), heads, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL)


def test_attention_wrapper_takes_plain_on_cpu():
    qkv = torch.from_numpy(_qkv(2, 16, 128, seed=1))
    before = attention.LAUNCHES.value
    out = attention.fused_mha_packed(qkv, 4, causal=True)
    torch.testing.assert_close(out, attention.fused_mha_plain(qkv, 4, True),
                               rtol=0, atol=0)
    assert out.shape == (2, 16, 128)
    assert attention.LAUNCHES.value == before  # no kernel ran


def test_attention_plain_keeps_bf16_io():
    qkv = torch.from_numpy(_qkv(2, 9, 64, seed=2)).to(torch.bfloat16)
    out = attention.fused_mha_plain(qkv, 2, causal=False)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 9, 64)


def test_attention_causal_row_ignores_future():
    qkv = _qkv(1, 12, 64, seed=3)
    base = attention.fused_mha_plain(torch.from_numpy(qkv), 2, True)
    qkv[:, 7:] += 1.0
    moved = attention.fused_mha_plain(torch.from_numpy(qkv), 2, True)
    torch.testing.assert_close(base[:, :7], moved[:, :7], rtol=0, atol=0)


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("mask_mode", ["nonzero", "plain", "valid"])
def test_maxsim_plain_matches_jax(mask_mode, oracle):
    t, i, mask = _tokens()
    jmask = jnp.asarray(mask) if mask_mode == "valid" else None
    if oracle == "pallas_interpret":
        want = maxsim_pallas(jnp.asarray(t), jnp.asarray(i), mask_mode=mask_mode,
                             text_mask=jmask, interpret=True)
    else:
        want = maxsim_xla(jnp.asarray(t), jnp.asarray(i), mask_mode=mask_mode,
                          text_mask=jmask)
    tmask = torch.from_numpy(mask) if mask_mode == "valid" else None
    got = maxsim.maxsim_plain(torch.from_numpy(t), torch.from_numpy(i),
                              mask_mode=mask_mode, text_mask=tmask, m_chunk=2)
    assert got.shape == (5, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MAXSIM_TOL)


def test_maxsim_wrapper_takes_plain_on_cpu():
    t, i, _ = _tokens(seed=1, li=9)
    before = maxsim.LAUNCHES.value
    got = maxsim.maxsim(torch.from_numpy(t), torch.from_numpy(i))
    want = maxsim.maxsim_plain(torch.from_numpy(t), torch.from_numpy(i))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert maxsim.LAUNCHES.value == before


def test_maxsim_rejects_bad_arguments():
    t, i, _ = _tokens(seed=2, li=9)
    t, i = torch.from_numpy(t), torch.from_numpy(i)
    with pytest.raises(ValueError, match="mask_mode"):
        maxsim.maxsim(t, i, mask_mode="mean")
    with pytest.raises(ValueError, match="text_mask"):
        maxsim.maxsim(t, i, mask_mode="valid")
    with pytest.raises(ValueError, match="Lt, D"):
        maxsim.maxsim(t, i[..., :8])


def test_no_silent_fallback_off_the_cpu():
    """A tensor on any other device than the CPU never takes the plain
    version: a non-CUDA device is refused outright."""
    with pytest.raises(ValueError, match="device"):
        attention.fused_mha_packed(torch.empty(2, 4, 96, device="meta"), 2)
    with pytest.raises(ValueError, match="CUDA"):
        maxsim.maxsim(torch.empty(2, 3, 8, device="meta"),
                      torch.empty(2, 5, 8, device="meta"))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load_kernels()
    finally:
        build._load.cache_clear()


def test_library_path_keys_on_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libcolxlip_kernels-") and path.suffix == ".so"
    assert {p.name for p in build._sources()} == {"fused_attention.cu", "maxsim.cu"}
