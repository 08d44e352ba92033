"""The port's attention dispatch and GELU variants against the JAX package, on
the CPU: ``ops/attention.py`` (``resolve_impl``, ``multi_head_attention``
and its five paths), ``models/layers.py`` ``MultiHeadAttention`` (self- and
cross-attention, ``attn_impl`` / ``COLXLIP_ATTN_IMPL``) and ``gelu`` /
``gelu_tanh`` under every ``COLXLIP_GELU_IMPL`` name.

Inputs come from numpy seeds; module weights from a JAX init. The JAX side
runs each impl under its own name, except 'fused' (its Pallas kernel needs a
TPU; the port's 'fused' is the kernels' plain version here) and 'flash' (a
TPU library kernel), which meet JAX's 'xla'. Tolerances, stated where used:

  - fp32 outputs 1e-5 absolute (O(1) values; measured 5e-7), gradients 1e-5
    of the largest |gradient|. 'xla' and 'xla_remat' scale the scores as
    SDPA does, by multiplying with 1/sqrt(D), as JAX's
    ``dot_product_attention`` does; 'fused' divides (its plain version keeps
    the kernel's numerics); the bar covers both.
  - bf16 outputs, each impl against JAX's 'xla' on the same bf16 inputs
    (JAX rounds the normalised probabilities to bf16): 'xla_bf16' rounds
    them the same way (2^-8 of max|v|, one probability a step off); 'fused'
    rounds the unnormalised exponentials instead, and SDPA ('xla',
    'xla_remat', 'flash') keeps them in fp32: 2^-6 of max|v| (a few bf16
    steps of the output).
  - GELU values 1e-6 of max(1, |y|) against JAX; gradients 1e-6 against the
    float64 evaluation of the same formula (2e-6 for 'stock', the library's
    backward) and 5e-6 against JAX, whose CPU tanh is 2.6e-7 off
    (x (1 - t^2) p' carries it up to 4.4e-6 near |x| 5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.models import layers as jax_layers
from colxlip_tpu.ops import attention as jax_attention
from colxlip_tpu_torch import factory
from colxlip_tpu_torch.models import ColXLIP
from colxlip_tpu_torch.models import layers
from colxlip_tpu_torch.ops import attention

IMPLS = ("fused", "xla", "xla_bf16", "xla_remat", "flash")
JAX_NAME = {"fused": "xla", "flash": "xla"}
FP32_ATOL = 1e-5
BF16_REL = {"xla_bf16": 2.0 ** -8, "fused": 2.0 ** -6, "xla": 2.0 ** -6,
            "xla_remat": 2.0 ** -6, "flash": 2.0 ** -6}


def _qkv(seed, b=2, n=9, m=None, h=3, d=16):
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    return (rng.standard_normal((b, n, h, d)).astype(np.float32),
            rng.standard_normal((b, m, h, d)).astype(np.float32),
            rng.standard_normal((b, m, h, d)).astype(np.float32))


def _jax_attention(q, k, v, impl, causal, mask=None, dout=None):
    """JAX forward and (with ``dout``) the three input gradients."""
    args = [jnp.asarray(t) for t in (q, k, v)]
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return jax_attention.multi_head_attention(q_, k_, v_, mask=jmask, causal=causal,
                                                  impl=JAX_NAME.get(impl, impl))

    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(dout, out.dtype)) if dout is not None else None
    return out, grads


def _port_attention(q, k, v, impl, causal, mask=None, dout=None, dtype=torch.float32):
    ts = [torch.tensor(t, dtype=dtype, requires_grad=True) for t in (q, k, v)]
    out = attention.multi_head_attention(
        *ts, mask=None if mask is None else torch.tensor(mask), causal=causal, impl=impl)
    grads = None
    if dout is not None:
        grads = torch.autograd.grad(out, ts, torch.tensor(dout, dtype=out.dtype))
    return out, grads


def _assert_grads(got, want, tol=FP32_ATOL):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=tol * np.abs(w).max())


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("impl", IMPLS)
def test_multi_head_attention_matches_jax_fp32(impl, causal):
    q, k, v = _qkv(1)
    dout = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    want, wgrads = _jax_attention(q, k, v, impl, causal, dout=dout)
    got, grads = _port_attention(q, k, v, impl, causal, dout=dout)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FP32_ATOL)
    _assert_grads(grads, wgrads)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("impl", IMPLS)
def test_multi_head_attention_bf16_against_jax(impl, causal):
    """bf16 inputs: each impl within its own bar of JAX's 'xla' (module
    docstring), the output bf16."""
    q, k, v = (np.asarray(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))
               for t in _qkv(3, n=33, h=2, d=32))
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    want = np.asarray(jax_attention.multi_head_attention(
        jq, jk, jv, causal=causal, impl="xla_bf16" if impl == "xla_bf16" else "xla"
    ).astype(jnp.float32))
    got, _ = _port_attention(q, k, v, impl, causal, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().detach().numpy() - want).max()
    assert err <= BF16_REL[impl] * np.abs(v).max(), (impl, err)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("impl", IMPLS)
def test_explicit_mask_takes_xla_and_composes_with_causal(impl, causal):
    """An additive mask sends every impl to 'xla', as in JAX, and the causal
    mask still applies under it: the result equals JAX's and a float64
    softmax with both masks."""
    q, k, v = _qkv(4)
    rng = np.random.default_rng(5)
    mask = np.where(rng.random((2, 1, 9, 9)) < 0.3, -1e9, 0.0).astype(np.float32)
    mask[..., 0] = 0.0                                # every row keeps a key
    dout = rng.standard_normal(q.shape).astype(np.float32)
    want, wgrads = _jax_attention(q, k, v, "xla", causal, mask=mask, dout=dout)
    got, grads = _port_attention(q, k, v, impl, causal, mask=mask, dout=dout)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FP32_ATOL)
    _assert_grads(grads, wgrads)
    s = np.einsum("bnhd,bmhd->bhnm", q, k).astype(np.float64) / 4.0 + mask
    if causal:
        s = np.where(np.tril(np.ones((9, 9), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhnm,bmhd->bnhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("impl", IMPLS)
def test_packed_attention_is_the_dispatch_on_the_split_projection(impl, masked):
    """``packed_attention`` on [B, N, 3 H D] (the towers' and the int8
    encoders' one entry) gives the bits of ``multi_head_attention`` on its
    three [B, N, H, D] parts, causal, with and without a mask."""
    q, k, v = _qkv(8)
    b, n, h, d = q.shape
    mask = None
    if masked:
        mask = torch.from_numpy(np.where(np.random.default_rng(9).random((b, 1, n, n)) < 0.3,
                                         -1e9, 0.0).astype(np.float32))
    qkv = torch.from_numpy(np.concatenate([t.reshape(b, n, h * d) for t in (q, k, v)], -1))
    got = attention.packed_attention(qkv, h, True, impl, mask=mask)
    want = attention.multi_head_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                          mask=mask, causal=True, impl=impl)
    assert got.shape == (b, n, h * d)
    assert torch.equal(got, want.reshape(b, n, h * d))


@pytest.mark.parametrize("impl", IMPLS)
def test_cross_attention_lengths_take_a_library_path(impl):
    """N != M: 'fused' cannot pack it and takes 'xla', as in JAX."""
    q, k, v = _qkv(6, n=5, m=7)
    dout = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    want, wgrads = _jax_attention(q, k, v, impl, False, dout=dout)
    got, grads = _port_attention(q, k, v, impl, False, dout=dout)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FP32_ATOL)
    _assert_grads(grads, wgrads)


def test_resolve_impl_and_unknown_names(monkeypatch):
    monkeypatch.delenv("COLXLIP_ATTN_IMPL", raising=False)
    assert attention.resolve_impl() == "fused" and attention.resolve_impl("xla") == "xla"
    monkeypatch.setenv("COLXLIP_ATTN_IMPL", "xla_bf16")
    assert attention.resolve_impl("auto") == "xla_bf16"
    assert attention.resolve_impl("flash") == "flash"          # an explicit name wins
    q, k, v = (torch.zeros(1, 2, 1, 8) for _ in range(3))
    monkeypatch.setenv("COLXLIP_ATTN_IMPL", "fast")
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.multi_head_attention(q, k, v)
    with pytest.raises(ValueError, match="unknown attention impl"):
        layers.MultiHeadAttention(8, 1, dtype=torch.float32)
    with pytest.raises(ValueError, match="unknown attention impl"):
        jax_attention.multi_head_attention(*(jnp.zeros((1, 2, 1, 8)) for _ in range(3)))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.multi_head_attention(q, k, v, impl="pallas")


@pytest.mark.parametrize("n", [577, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_take_any_sequence_length(n, dtype):
    """The wrapper's checks (made before any launch) admit both dtypes at
    any N: both stream key tiles of 64, so no length is too long for the
    shared memory of a block."""
    assert attention._check_cuda(torch.empty(2, n, 3 * 128, dtype=dtype), 2,
                                 "fused_mha_packed") == (2, n, 128, 64)


@pytest.mark.parametrize("case", ["head_dim", "float16", "contiguous", "aligned"])
def test_fused_kernels_refuse_what_they_do_not_take(case):
    """What the kernels do not take still raises before any launch, in
    float32 as in bfloat16: head_dim 48, float16, a non-contiguous qkv and
    one that does not start on 16 bytes."""
    qkv, heads = torch.empty(2, 577, 3 * 128), 2
    if case == "head_dim":
        qkv, match = torch.empty(2, 577, 3 * 96), "head_dim 48"
    elif case == "float16":
        qkv, match = qkv.half(), "dtype"
    elif case == "contiguous":
        qkv, match = torch.empty(577, 2, 3 * 128).transpose(0, 1), "contiguous"
    else:
        flat = torch.empty(2 * 577 * 3 * 128 + 4)
        qkv = flat[1:1 + qkv.numel()].view(qkv.shape)
        assert qkv.is_contiguous() and qkv.data_ptr() % 16
        match = "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        attention._check_cuda(qkv, heads, "fused_mha_packed")


# ---------------------------------------------------------------------------
# models/layers.py MultiHeadAttention
# ---------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _load_dense(linear, p):
    linear.weight.data = _t(np.asarray(p["kernel"]).T)
    linear.bias.data = _t(p["bias"])


@pytest.mark.parametrize("impl", IMPLS)
def test_multi_head_attention_module_self_matches_jax(impl, monkeypatch):
    """The self-attention module through each impl (``attn_impl``, and the
    same name through ``COLXLIP_ATTN_IMPL``) against the JAX module; its
    state-dict keys stay the four OpenCLIP keys."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    jmod = jax_layers.MultiHeadAttention(32, 4, dtype=jnp.float32,
                                         attn_impl=JAX_NAME.get(impl, impl))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), is_causal=True)["params"]
    want, vjp = jax.vjp(lambda a: jmod.apply({"params": params}, a, is_causal=True),
                        jnp.asarray(x))
    dout = rng.standard_normal(x.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(dout))
    for how in ("arg", "env"):
        if how == "env":
            monkeypatch.setenv("COLXLIP_ATTN_IMPL", impl)
            mod = layers.MultiHeadAttention(32, 4, dtype=torch.float32)
        else:
            mod = layers.MultiHeadAttention(32, 4, dtype=torch.float32, attn_impl=impl)
        assert mod.attn_impl == impl
        assert set(mod.state_dict()) == {"in_proj_weight", "in_proj_bias", "out_proj.weight",
                                         "out_proj.bias"}
        mod.in_proj_weight.data = _t(np.asarray(params["in_proj"]["kernel"]).T)
        mod.in_proj_bias.data = _t(params["in_proj"]["bias"])
        _load_dense(mod.out_proj, params["out_proj"])
        xt = torch.tensor(x, requires_grad=True)
        got = mod(xt, True)
        (dx,) = torch.autograd.grad(got, xt, torch.tensor(dout))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=FP32_ATOL)
        _assert_grads([dx], [want_dx])


@pytest.mark.parametrize("impl", IMPLS)
def test_multi_head_attention_module_cross_matches_jax(impl):
    """kv= with q_proj / k_proj / v_proj (kv of another width and length)
    against the JAX module's cross-attention branch, forward and gradients."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 11, 24)).astype(np.float32)
    jmod = jax_layers.MultiHeadAttention(32, 4, dtype=jnp.float32,
                                         attn_impl=JAX_NAME.get(impl, impl))
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), kv=jnp.asarray(kv))["params"]
    want, vjp = jax.vjp(lambda a, b: jmod.apply({"params": params}, a, kv=b),
                        jnp.asarray(x), jnp.asarray(kv))
    dout = rng.standard_normal(x.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(dout))
    mod = layers.MultiHeadAttention(32, 4, dtype=torch.float32, attn_impl=impl, kv_dim=24)
    assert set(mod.state_dict()) == {f"{p}.{w}" for p in ("q_proj", "k_proj", "v_proj",
                                                          "out_proj")
                                     for w in ("weight", "bias")}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _load_dense(getattr(mod, name), params[name])
    xt, kvt = torch.tensor(x, requires_grad=True), torch.tensor(kv, requires_grad=True)
    got = mod(xt, kv=kvt)
    grads = torch.autograd.grad(got, (xt, kvt), torch.tensor(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FP32_ATOL)
    _assert_grads(grads, want_grads)
    with pytest.raises(ValueError, match="kv="):
        mod(xt)
    with pytest.raises(ValueError, match="kv="):
        layers.MultiHeadAttention(32, 4, dtype=torch.float32)(xt, kv=kvt)


@pytest.mark.parametrize("impl", ["xla", "xla_remat", "flash"])
def test_towers_under_an_impl_match_the_default(impl, monkeypatch):
    """COLXLIP_ATTN_IMPL reaches every block of both towers (read when the
    model is built): the tiny ColXLIP encodes as under the default within
    the fp32 bar, with the same state-dict keys."""
    rng = np.random.default_rng(10)
    imgs = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    txts = torch.zeros(2, 32, dtype=torch.int64)
    txts[:, 0], txts[:, 1:6], txts[0, 6], txts[1, 9] = 49406, 1000, 49407, 49407
    cfg = factory.model_config("ViT-S-16-test-colxlip")
    monkeypatch.delenv("COLXLIP_ATTN_IMPL", raising=False)
    base = ColXLIP(cfg, dtype=torch.float32)
    factory.init_weights(base, torch.Generator().manual_seed(0))
    monkeypatch.setenv("COLXLIP_ATTN_IMPL", impl)
    other = ColXLIP(cfg, dtype=torch.float32)
    other.load_state_dict(base.state_dict(), strict=True)
    blocks = [*other.visual.transformer.resblocks, *other.transformer.resblocks]
    assert {b.attn.attn_impl for b in blocks} == {impl}
    with torch.no_grad():
        for enc in ("encode_image", "encode_text"):
            x = imgs if enc == "encode_image" else txts
            for a, b in zip(getattr(base.eval(), enc)(x, normalize=True),
                            getattr(other.eval(), enc)(x, normalize=True)):
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=FP32_ATOL)


# ---------------------------------------------------------------------------
# GELU
# ---------------------------------------------------------------------------

def _float64_gelu(x, impl):
    """(value, derivative) of each name's formula in float64."""
    from math import erf

    x = x.astype(np.float64)
    if impl == "tanh":
        u = np.sqrt(2 / np.pi) * (x + 0.044715 * x ** 3)
        t = np.tanh(u)
        du = np.sqrt(2 / np.pi) * (1 + 3 * 0.044715 * x * x)
        return 0.5 * x * (1 + t), 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * du
    pdf = np.exp(-0.5 * x * x) / np.sqrt(2 * np.pi)
    if impl == "stock":
        cdf = 0.5 * (1 + np.vectorize(erf)(x / np.sqrt(2)))
        return x * cdf, cdf + x * pdf
    if impl == "aspoly":
        a = np.abs(x / np.sqrt(2))
        t = 1 / (1 + 0.3275911 * a)
        poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (
            -1.453152027 + t * 1.061405429))))
        cdf = 0.5 * (1 + np.sign(x) * (1 - poly * np.exp(-a * a)))
        return x * cdf, cdf + x * pdf
    coeffs = layers.TANH_ERF_C if impl == "fast" else layers.TANH_ERF_C9
    u = x * x
    p = sum(c * u ** i for i, c in enumerate(coeffs))
    dp = sum((2 * i + 1) * c * u ** i for i, c in enumerate(coeffs))
    t = np.tanh(x * p)
    return 0.5 * x * (1 + t), 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * dp


@pytest.mark.parametrize("which", ["gelu", "gelu_tanh"])
@pytest.mark.parametrize("impl", layers.GELU_IMPLS)
def test_gelu_impls_match_jax(impl, which, monkeypatch):
    x = np.concatenate([np.linspace(-8, 8, 4001),
                        np.random.default_rng(11).standard_normal(2000) * 3]).astype(np.float32)
    monkeypatch.setenv("COLXLIP_GELU_IMPL", impl)
    jf, pf = getattr(jax_layers, which), getattr(layers, which)
    want = np.asarray(jf(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda a: jf(a).sum())(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = pf(xt)
    (grad,) = torch.autograd.grad(got.sum(), xt)
    got, grad = got.detach().numpy(), grad.numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= 1e-6
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=5e-6)
    ref, ref_grad = _float64_gelu(x, "tanh" if which == "gelu_tanh" else impl)
    assert (np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max() <= 1e-6
    # 'stock' is the library's own backward, 1.03e-6 from float64 at worst
    np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=2e-6 if impl == "stock" else 1e-6)


def test_gelu_default_and_unknown_names(monkeypatch):
    """Unset: exact erf, ``F.gelu`` bit for bit (the JAX default 'fast9' is
    a TPU speed knob). An unknown name raises on both sides; bf16 inputs keep
    their dtype with a formula's gradient."""
    x = torch.linspace(-5, 5, 101)
    monkeypatch.delenv("COLXLIP_GELU_IMPL", raising=False)
    assert torch.equal(layers.gelu(x), torch.nn.functional.gelu(x))
    assert torch.equal(layers.gelu_tanh(x), torch.nn.functional.gelu(x, approximate="tanh"))
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "fast13")
    for fn in (layers.gelu, layers.gelu_tanh):
        with pytest.raises(ValueError, match="COLXLIP_GELU_IMPL"):
            fn(x)
    with pytest.raises(ValueError, match="COLXLIP_GELU_IMPL"):
        jax_layers.gelu(jnp.asarray(x.numpy()))
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "fast9")
    xb = x.bfloat16().requires_grad_()
    y = layers.gelu(xb)
    (g,) = torch.autograd.grad(y.sum(), xb)
    assert y.dtype == g.dtype == torch.bfloat16
    want = np.asarray(jax.grad(lambda a: jax_layers.gelu(a).sum())(
        jnp.asarray(x.numpy()).astype(jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_allclose(g.float().numpy(), want, rtol=0, atol=2.0 ** -7)
