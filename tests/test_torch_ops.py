"""colxlip_tpu_torch ops: each kernel's plain PyTorch version, forward and
backward, against the JAX package's TPU kernel (Pallas interpret mode, as the
JAX tests run it on the CPU) and its XLA reference or streaming path, on the
same seeded numpy inputs.

On the CPU the wrappers take the plain version (the CUDA kernels run only on
the card); tests/test_torch_cuda.py compares each kernel with its plain
version there.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.ops.fused_attention import fused_mha_packed, fused_mha_reference
from colxlip_tpu.ops.maxsim import maxsim as jax_maxsim
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
    assert {p.name for p in build._sources()} == {
        "fused_attention.cu", "fused_attention_bwd.cu", "maxsim.cu", "maxsim_bwd.cu"}


# ---- backward ---------------------------------------------------------------

def _jax_vjp(fn, args, cot):
    """Cotangents of fn(*args) for the output cotangent ``cot``."""
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("oracle", ["pallas_interpret", "reference"])
@pytest.mark.parametrize("b,n,heads,hd,causal", ATTN_SHAPES)
def test_attention_bwd_plain_matches_jax(b, n, heads, hd, causal, oracle):
    qkv = _qkv(b, n, hd, seed=4)
    dout = np.random.default_rng(5).standard_normal((b, n, hd)).astype(np.float32)
    if oracle == "pallas_interpret":
        fn = lambda x: fused_mha_packed(x, heads, causal, 0, True)  # noqa: E731
    else:
        fn = lambda x: fused_mha_reference(x, heads, causal)  # noqa: E731
    (want,) = _jax_vjp(fn, [qkv], dout)
    got = attention.fused_mha_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(dout),
                                        heads, causal)
    assert got.shape == qkv.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL)


def test_attention_autograd_takes_plain_backward_on_cpu():
    qkv = torch.from_numpy(_qkv(3, 16, 128, seed=6)).requires_grad_()
    dout = torch.from_numpy(np.random.default_rng(7).standard_normal((3, 16, 128))
                            .astype(np.float32))
    before = (attention.LAUNCHES.value, attention.BWD_LAUNCHES.value)
    out = attention.fused_mha_packed(qkv, 4, causal=True)
    torch.testing.assert_close(out, attention.fused_mha_plain(qkv.detach(), 4, True),
                               rtol=0, atol=0)
    (got,) = torch.autograd.grad(out, qkv, dout)
    want = attention.fused_mha_bwd_plain(qkv.detach(), dout, 4, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (attention.LAUNCHES.value, attention.BWD_LAUNCHES.value) == before


def _tie_free_tokens(mask_mode, seed=0):
    """_tokens() without all-zero text rows except in 'nonzero' mode, where
    they carry weight 0: an all-zero row ties every image token, and the
    Pallas kernel routes ties to the first argmax only."""
    t, i, mask = _tokens(seed=seed, li=20)
    if mask_mode != "nonzero":
        t = _l2(np.random.default_rng(seed + 1).standard_normal(t.shape)).astype(np.float32)
    return t, i, mask


@pytest.mark.parametrize("oracle", ["streaming", "pallas_interpret"])
@pytest.mark.parametrize("mask_mode", ["nonzero", "plain", "valid"])
def test_maxsim_bwd_plain_matches_jax(mask_mode, oracle):
    t, i, mask = _tie_free_tokens(mask_mode)
    g = np.random.default_rng(9).standard_normal((t.shape[0], i.shape[0])).astype(np.float32)
    jmask = jnp.asarray(mask) if mask_mode == "valid" else None
    if oracle == "streaming":
        fn = lambda a, b: jax_maxsim(a, b, mask_mode=mask_mode, text_mask=jmask,  # noqa: E731
                                     impl="streaming", m_chunk=2)
    else:
        fn = lambda a, b: maxsim_pallas(a, b, mask_mode=mask_mode,  # noqa: E731
                                        text_mask=jmask, interpret=True)
    want_t, want_i = _jax_vjp(fn, [t, i], g)
    tmask = torch.from_numpy(mask) if mask_mode == "valid" else None
    got_t, got_i = maxsim.maxsim_bwd_plain(torch.from_numpy(t), torch.from_numpy(i),
                                           torch.from_numpy(g), mask_mode=mask_mode,
                                           text_mask=tmask, m_chunk=2)
    np.testing.assert_allclose(got_t.numpy(), want_t, **MAXSIM_TOL)
    np.testing.assert_allclose(got_i.numpy(), want_i, **MAXSIM_TOL)
    # the autograd path on the CPU is the plain backward (default chunking)
    tt, ii = torch.from_numpy(t).requires_grad_(), torch.from_numpy(i).requires_grad_()
    s = maxsim.maxsim(tt, ii, mask_mode=mask_mode, text_mask=tmask)
    grads = torch.autograd.grad(s, (tt, ii), torch.from_numpy(g))
    plain = maxsim.maxsim_bwd_plain(tt.detach(), ii.detach(), torch.from_numpy(g),
                                    mask_mode=mask_mode, text_mask=tmask)
    for a, b in zip(grads, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_maxsim_bwd_routes_every_tie_as_streaming():
    """Two identical image tokens (3 and 7 of every image), and text tokens
    equal to token 3 of image 1, so their max is an exact tie: the streaming
    path and the port give each tied token the full cotangent; the Pallas
    kernel gives all of it to the first."""
    t, i, _ = _tokens(seed=3, li=12)
    i[:, 7] = i[:, 3]
    t[1, :4] = i[1, 3]
    t[4, 2] = i[1, 3]
    g = np.random.default_rng(2).standard_normal((t.shape[0], i.shape[0])).astype(np.float32)
    fn = lambda a, b: jax_maxsim(a, b, impl="streaming", m_chunk=5)  # noqa: E731
    want_t, want_i = _jax_vjp(fn, [t, i], g)
    got_t, got_i = maxsim.maxsim_bwd_plain(torch.from_numpy(t), torch.from_numpy(i),
                                           torch.from_numpy(g))
    np.testing.assert_allclose(got_t.numpy(), want_t, **MAXSIM_TOL)
    np.testing.assert_allclose(got_i.numpy(), want_i, **MAXSIM_TOL)
    np.testing.assert_array_equal(got_i[1, 3].numpy(), got_i[1, 7].numpy())
    assert np.abs(want_i[1, 7]).max() > 1e-3
    first_only = _jax_vjp(lambda a, b: maxsim_pallas(a, b, interpret=True), [t, i], g)[1]
    assert np.abs(first_only[1, 7] - want_i[1, 7]).max() > 1e-3


def test_no_silent_fallback_off_the_cpu_backward():
    """The backward dispatch refuses a tensor on any device but the CPU or
    CUDA, and so does an autograd forward on one."""
    meta = torch.empty(2, 4, 96, device="meta")
    with pytest.raises(ValueError, match="device"):
        attention._backward(meta, torch.empty(2, 4, 32, device="meta"), 2, False)
    with pytest.raises(ValueError, match="device"):
        attention.fused_mha_packed(meta.requires_grad_(), 2)
    t, i = torch.empty(2, 3, 8, device="meta"), torch.empty(2, 5, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        maxsim._backward(t, i, torch.empty(2, 2, device="meta"), "nonzero", None)
    with pytest.raises(ValueError, match="CUDA"):
        maxsim.maxsim(t.requires_grad_(), i)
