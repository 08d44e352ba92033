"""The port's fused LayerNorm and fused MLP (``colxlip_tpu_torch/ops/fused_ln.py``,
``ops/fused_mlp.py``) against the JAX package on the CPU, on the same seeded
numpy inputs: the Pallas kernels in interpret mode (as tests/test_fused_ln.py
and tests/test_fused_mlp.py run them) and their XLA references. On the CPU
the port's wrappers take the kernels' plain versions, which carry the
kernels' arithmetic; the CUDA kernels are held against those plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: values 1e-5 and gradients 2e-4 in fp32 (the bars of the JAX
package's own tests: sums in another order; against the XLA reference's erf
the kernels' erf polynomial adds 1.5e-7); 2e-2 in bf16, where one rounding
step of an output near 4 is 1.6e-2 (gradients: 2e-2 of the largest |grad|;
against the XLA reference of the MLP in bf16 only dx, see the test).

Also here: the dispatch rules of ``models.layers.LayerNorm`` and ``MLP``, the
port's copies of the model configs and its positional-embedding module
against the JAX package's, and ``patch_dropout_select`` against
``jax.lax.top_k``.
"""
from __future__ import annotations

import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.models import pos_embed as jax_pos_embed
from colxlip_tpu.ops import fused_ln as jax_ln
from colxlip_tpu.ops import fused_mlp as jax_mlp
from colxlip_tpu_torch.models import layers, pos_embed
from colxlip_tpu_torch.ops import fused_ln, fused_mlp

REPO = pathlib.Path(__file__).resolve().parents[1]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VALUE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _t(a: np.ndarray, dtype: str, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DTYPES[dtype]).requires_grad_(grad)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _assert_grads(got, want, dtype, names):
    for g, w, name in zip(got, want, names):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, name
        tol = GRAD_TOL[dtype] * (max(np.abs(w).max(), 1e-12) if dtype == "bfloat16" else 1.0)
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL[dtype] if dtype == "float32" else 0,
                                   atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# LayerNorm (TPU kernels fused_ln.py _fwd_call / _bwd_call)
# ---------------------------------------------------------------------------

def _ln_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    return ((rng.standard_normal(shape) * 2 + 0.5).astype(np.float32),
            (1.0 + rng.standard_normal(d) * 0.1).astype(np.float32),
            (rng.standard_normal(d) * 0.05).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 24, 128), (3, 7, 128), (36, 128)],
                         ids=["rows96", "rows21-no-block-divides", "rows36"])
@pytest.mark.parametrize("oracle", ["pallas-interpret", "xla-reference"])
def test_layernorm_matches_jax(shape, dtype, oracle):
    x, scale, bias, dy = _ln_inputs(shape)
    jdt = jnp.dtype(dtype)

    def jax_fn(x, s, b):
        if oracle == "pallas-interpret":
            return jax_ln.fused_layernorm(x, s, b, 1e-5, 0, True)
        return jax_ln.layernorm_reference(x, s, b, 1e-5)

    jx, js, jb = jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias)
    want, vjp = jax.vjp(jax_fn, jx, js, jb)
    want_g = vjp(jnp.asarray(dy, jdt))

    tx, ts, tb = _t(x, dtype, True), _t(scale, "float32", True), _t(bias, "float32", True)
    got = fused_ln.fused_layernorm(tx, ts, tb, 1e-5)
    got_g = torch.autograd.grad(got, (tx, ts, tb), _t(dy, dtype))
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=VALUE_TOL[dtype])
    assert got_g[0].dtype == TORCH_DTYPES[dtype] and got_g[1].dtype == torch.float32
    _assert_grads(got_g, want_g, dtype, ["dx", "dscale", "dbias"])


def test_layernorm_saves_only_x_and_scale():
    x, scale, bias, _ = _ln_inputs((2, 5, 64))
    tx, ts, tb = _t(x, "bfloat16", True), _t(scale, "float32", True), _t(bias, "float32", True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        fused_ln.fused_layernorm(tx, ts, tb)
    assert sorted(tuple(t.shape) for t in saved) == [(2, 5, 64), (64,)]
    assert {t.dtype for t in saved} == {torch.bfloat16, torch.float32}


def test_layernorm_plain_is_two_pass():
    """A large common offset: E[x^2] - E[x]^2 would lose the variance in
    fp32; the mean of squared deviations keeps it."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 256)) + 4000.0).astype(np.float32)
    got = fused_ln.layernorm_plain(torch.from_numpy(x), torch.ones(256), torch.zeros(256), 1e-5)
    x64 = x.astype(np.float64)
    want = (x64 - x64.mean(-1, keepdims=True)) / np.sqrt(x64.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)


def test_fused_ln_supported_is_a_function_of_shape_and_dtype():
    assert fused_ln.fused_ln_supported((256, 197, 768), torch.bfloat16)
    assert fused_ln.fused_ln_supported((7, 40), torch.float32)
    assert not fused_ln.fused_ln_supported((4, 1025), torch.float32)
    assert not fused_ln.fused_ln_supported((4, 64), torch.float16)
    assert not fused_ln.fused_ln_supported((0, 64), torch.float32)


# ---------------------------------------------------------------------------
# MLP (TPU kernels fused_mlp.py _fwd_call / _bwd_call)
# ---------------------------------------------------------------------------

def _mlp_inputs(b=4, n=24, d=128, h=512, seed=0):
    """x, W1 [D, H], b1, W2 [H, D], b2, dy in the JAX kernel's layout."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * std).astype(np.float32) for s, std in (
        ((b, n, d), 0.5), ((d, h), 0.05), ((h,), 0.02), ((h, d), 0.05), ((d,), 0.02),
        ((b, n, d), 1.0))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("oracle", ["pallas-interpret", "xla-reference"])
def test_mlp_matches_jax(approximate, dtype, oracle):
    x, w1, b1, w2, b2, dy = _mlp_inputs(b=3)      # a batch no TPU block size but 1 divides
    jdt = jnp.dtype(dtype)

    def jax_fn(*a):
        if oracle == "pallas-interpret":
            return jax_mlp.fused_mlp(*a, approximate, 0, True)
        return jax_mlp.fused_mlp_reference(*a, approximate)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a, jdt) for a in (x, w1, b1, w2, b2)))
    want_g = list(vjp(jnp.asarray(dy, jdt)))
    want_g[1] = want_g[1].T                       # dW1 [D, H] -> the port's [H, D]

    # the port's weights are hidden-major: W1 transposed, W2 as it is
    leaves = [_t(a, dtype, True) for a in (x, w1.T.copy(), b1, w2, b2)]
    got = fused_mlp.fused_mlp(*leaves, approximate)
    got_g = torch.autograd.grad(got, leaves, _t(dy, dtype))
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == leaves[0].shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=VALUE_TOL[dtype])
    assert all(g.dtype == TORCH_DTYPES[dtype] for g in got_g)
    # in bf16 XLA's autodiff of the reference sums the weight gradients in
    # bf16, 72 rows deep, and is the less exact side: there only dx is held
    # to it; the Pallas kernel sums them in fp32, as the port does
    n = 1 if (dtype, oracle) == ("bfloat16", "xla-reference") else 5
    _assert_grads(got_g[:n], want_g[:n], dtype, ["dx", "dw1", "db1", "dw2", "db2"][:n])


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_kernel_gelu_matches_jax_formulas(approximate):
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want_v, want_g = jax_mlp._kernel_gelu_and_grad(jnp.asarray(x), approximate)
    got_v, got_g = fused_mlp.kernel_gelu_and_grad(torch.from_numpy(x), approximate)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)
    # torch's tanh and XLA's differ in the last bits, and x * (1 - t^2) * du grows them
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               atol=1e-5 if approximate else 1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x).double(),
                                     approximate="tanh" if approximate else "none")
    assert (got_v.double() - exact).abs().max() < 2e-6    # the polynomial is 1.5e-7 from erf


def test_mlp_plain_chunks_agree_and_round_before_the_bias():
    x, w1, b1, w2, b2, dy = (_t(a, "bfloat16") for a in _mlp_inputs(b=2, n=9, d=32, h=64))
    w1 = w1.T.contiguous()
    whole = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2)
    assert torch.equal(whole, fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, chunk=5))
    for a, b in zip(fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, chunk=5),
                    fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # the pre-activation: the product is rounded to bf16, then the bias is added in bf16
    h = fused_mlp._hidden(x.reshape(-1, 32), w1.float(), b1)
    want = (x.reshape(-1, 32).float() @ w1.float().T).bfloat16() + b1
    assert h.dtype == torch.bfloat16 and torch.equal(h, want)


def test_mlp_saves_x_w1_b1_w2_and_no_hidden_tensor():
    leaves = [_t(a, "float32", True) for a in _mlp_inputs(b=2, n=9, d=32, h=64)[:5]]
    leaves[1] = leaves[1].detach().T.contiguous().requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        fused_mlp.fused_mlp(*leaves)
    assert sorted(tuple(t.shape) for t in saved) == [(2, 9, 32), (64,), (64, 32), (64, 32)]


def test_fp32_dx_splits_fill_the_card_and_leave_no_slice_empty():
    """The float32 backward's K slices of dh W1: four at the towers' shapes on
    132 multiprocessors, one where a chunk's dx tiles already fill two blocks
    an SM or H is one k-step; with the kernel's cut (ceil(steps / splits)
    k-steps a slice) every slice holds K and together they cover H."""
    assert fused_mlp.fp32_dx_splits(4112, 1024, 4096, 132) == 4        # ViT-L-14
    assert fused_mlp.fp32_dx_splits(256 * 197, 768, 3072, 132) == 4    # the vision tower
    assert fused_mlp.fp32_dx_splits(256 * 77, 512, 2048, 132) == 4     # the text tower
    assert fused_mlp.fp32_dx_splits(8192, 4096, 4096, 132) == 1        # 256 dx tiles a chunk
    assert fused_mlp.fp32_dx_splits(70, 40, 16, 132) == 1              # one k-step
    for rows, d, h in ((70, 1000, 4000), (70, 40, 100), (300, 64, 96), (5, 8, 80), (9, 3, 33)):
        splits = fused_mlp.fp32_dx_splits(rows, d, h, 132)
        steps = -(-h // fused_mlp.SGEMM_K_STEP)
        per = -(-steps // splits) * fused_mlp.SGEMM_K_STEP
        assert 1 <= splits <= fused_mlp.FP32_MAX_DX_SPLITS
        assert (splits - 1) * per < h <= splits * per, (rows, d, h, splits)


def test_mlp_refuses_a_wrong_layout_or_dtype():
    x, w1, b1, w2, b2, _ = (_t(a, "float32") for a in _mlp_inputs(b=1, n=4, d=32, h=64))
    with pytest.raises(ValueError, match="w1 \\[H, D\\]"):
        fused_mlp.fused_mlp(x, w1, b1, w2, b2)            # W1 in the JAX layout [D, H]
    with pytest.raises(ValueError, match="hidden-major"):
        fused_mlp.fused_mlp(x, w1.T.contiguous(), b1, w2.T.contiguous(), b2)
    with pytest.raises(ValueError, match="share the compute dtype"):
        fused_mlp.fused_mlp(x.bfloat16(), w1.T.contiguous(), b1, w2, b2)


# ---------------------------------------------------------------------------
# dispatch in models/layers.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resolve,env", [(fused_ln.resolve_ln_impl, "COLXLIP_LN_IMPL"),
                                         (fused_mlp.resolve_mlp_impl, "COLXLIP_MLP_IMPL")])
def test_resolve_impl_rules(monkeypatch, resolve, env):
    monkeypatch.delenv(env, raising=False)
    assert resolve() == "xla" and resolve("auto") == "xla"
    monkeypatch.setenv(env, "fused")
    assert resolve() == "fused"
    assert resolve("xla") == "xla"                 # an explicit argument beats the environment
    monkeypatch.setenv(env, "xla")
    assert resolve() == "xla" and resolve("fused") == "fused"
    monkeypatch.setenv(env, "fussed")
    with pytest.raises(ValueError, match=env):
        resolve()
    with pytest.raises(ValueError, match="pallas"):
        resolve("pallas")


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_layernorm_module_dispatch(monkeypatch):
    calls = _count_calls(monkeypatch, layers, "fused_layernorm")
    x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(0))
    monkeypatch.delenv("COLXLIP_LN_IMPL", raising=False)
    default = layers.LayerNorm(64)
    monkeypatch.setenv("COLXLIP_LN_IMPL", "fused")
    want = default(x)                              # built before the variable was set
    assert default.impl == "xla" and not calls
    fused = layers.LayerNorm(64)
    assert fused.impl == "fused" and layers.LayerNorm(64, impl="xla").impl == "xla"
    monkeypatch.delenv("COLXLIP_LN_IMPL")
    got = fused(x)                                 # read when built, not on the call
    assert calls == ["fused_layernorm"]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # outside the kernels' range the module still goes to ops/fused_ln.py and
    # never to the library: the plain version here, a raise on the card
    wide = layers.LayerNorm(1025, impl="fused")(torch.randn(2, 1025))
    assert calls == ["fused_layernorm"] * 2 and wide.shape == (2, 1025)
    assert fused(x.half()).dtype == torch.float16 and len(calls) == 3
    monkeypatch.setenv("COLXLIP_LN_IMPL", "triton")
    with pytest.raises(ValueError, match="COLXLIP_LN_IMPL"):
        layers.LayerNorm(64)


def test_mlp_module_dispatch(monkeypatch):
    calls = _count_calls(monkeypatch, layers, "fused_mlp")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 32, generator=gen)
    monkeypatch.setenv("COLXLIP_MLP_IMPL", "fused")
    built = {act.__name__: layers.MLP(32, 4.0, act, dtype=torch.float32)
             for act in (layers.gelu, layers.gelu_tanh, layers.quick_gelu)}
    explicit = layers.MLP(32, 4.0, layers.gelu, dtype=torch.float32, impl="xla")
    monkeypatch.delenv("COLXLIP_MLP_IMPL")
    default = layers.MLP(32, 4.0, layers.gelu, dtype=torch.float32)
    assert [m.fused for m in built.values()] == [True, True, False]
    assert not explicit.fused and not default.fused
    for mlp in (*built.values(), explicit, default):
        for p in mlp.parameters():
            torch.nn.init.normal_(p, std=0.1, generator=gen)
    for name, mlp in built.items():
        calls.clear()
        got = mlp(x)
        assert calls == ([] if name == "quick_gelu" else ["fused_mlp"]), name
        twin = layers.MLP(32, 4.0, mlp.act, dtype=torch.float32, impl="xla")
        twin.load_state_dict(mlp.state_dict(), strict=True)
        torch.testing.assert_close(got, twin(x), rtol=0, atol=1e-5)
    calls.clear()
    built["gelu"](x[0])                            # a 2-D input keeps the two Linears
    explicit(x), default(x)
    assert not calls
    monkeypatch.setenv("COLXLIP_MLP_IMPL", "cublas")
    with pytest.raises(ValueError, match="COLXLIP_MLP_IMPL"):
        layers.MLP(32, 4.0, layers.quick_gelu, dtype=torch.float32)


def test_mlp_quick_gelu_under_fused_logs_its_activation(monkeypatch, caplog):
    """Under COLXLIP_MLP_IMPL=fused a quick_gelu MLP keeps the two Linears, as
    the JAX module does, and says so once when it is built, naming the
    activation; a gelu MLP logs nothing and takes the kernel."""
    calls = _count_calls(monkeypatch, layers, "fused_mlp")
    monkeypatch.setenv("COLXLIP_MLP_IMPL", "fused")
    x = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(2))
    with caplog.at_level("WARNING", logger=layers.__name__):
        quick = layers.MLP(32, 4.0, layers.quick_gelu, dtype=torch.float32)
    lines = [r.getMessage() for r in caplog.records if r.name == layers.__name__]
    assert len(lines) == 1 and "quick_gelu" in lines[0] and "two Linears" in lines[0]
    caplog.clear()
    with caplog.at_level("WARNING", logger=layers.__name__):
        exact = layers.MLP(32, 4.0, layers.gelu, dtype=torch.float32)
        tanh = layers.MLP(32, 4.0, layers.gelu_tanh, dtype=torch.float32)
        quick(x)
    assert not [r for r in caplog.records if r.name == layers.__name__]
    assert not quick.fused and not calls
    exact(x), tanh(x)
    assert exact.fused and tanh.fused and calls == ["fused_mlp", "fused_mlp"]


def test_mlp_module_gradients_reach_the_fp32_parameters(monkeypatch):
    """bf16 compute: the casts and the transpose sit outside the kernel's
    Function, so fp32 parameters get fp32 gradients in their own layout,
    close to the two-Linear path's."""
    gen = torch.Generator().manual_seed(1)
    pair = [layers.MLP(32, 4.0, layers.gelu, dtype=torch.bfloat16, impl=impl)
            for impl in ("fused", "xla")]
    for p in pair[0].parameters():
        torch.nn.init.normal_(p, std=0.1, generator=gen)
    pair[1].load_state_dict(pair[0].state_dict(), strict=True)
    x = torch.randn(3, 7, 32, generator=gen)
    grads = []
    for mlp in pair:
        mlp(x).float().square().sum().backward()
        grads.append({k: p.grad for k, p in mlp.named_parameters()})
    for k, w in grads[1].items():
        g = grads[0][k]
        assert g.dtype == torch.float32 and g.shape == w.shape, k
        torch.testing.assert_close(g, w, rtol=0, atol=3e-2 * w.abs().max().item())


@pytest.mark.parametrize("model_name", ["ViT-S-16-test-colxlip", "ViT-S-16-test"])
def test_state_dict_loads_under_either_setting(monkeypatch, model_name):
    from colxlip_tpu_torch import factory

    monkeypatch.delenv("COLXLIP_LN_IMPL", raising=False)
    monkeypatch.delenv("COLXLIP_MLP_IMPL", raising=False)
    default, _ = factory.create_model(model_name, "cpu", torch.float32, seed=0)
    monkeypatch.setenv("COLXLIP_LN_IMPL", "fused")
    monkeypatch.setenv("COLXLIP_MLP_IMPL", "fused")
    fused, _ = factory.create_model(model_name, "cpu", torch.float32, seed=1)
    assert list(fused.state_dict()) == list(default.state_dict())
    fused.load_state_dict(default.state_dict(), strict=True)
    default.load_state_dict(fused.state_dict(), strict=True)
    assert all(m.impl == "fused" for m in fused.modules() if isinstance(m, layers.LayerNorm))
    assert all(m.fused for m in fused.modules() if isinstance(m, layers.MLP))
    assert not any(m.fused for m in default.modules() if isinstance(m, layers.MLP))


# ---------------------------------------------------------------------------
# the port's own data files, positions, PatchDropout's selection
# ---------------------------------------------------------------------------

def test_model_configs_are_byte_for_byte_copies():
    ours = sorted((REPO / "colxlip_tpu_torch" / "model_configs").glob("*.json"))
    theirs = sorted((REPO / "colxlip_tpu" / "model_configs").glob("*.json"))
    assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) >= 11
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a.name


_OPEN_PROBE = r"""
import importlib, importlib.util, os, pathlib, pkgutil, sys, tempfile
jax_pkg = pathlib.Path(sys.argv[1]).resolve()
seen = []

def under(p):
    try:
        return jax_pkg == pathlib.Path(os.fsdecode(p)).resolve() or \
            jax_pkg in pathlib.Path(os.fsdecode(p)).resolve().parents
    except (TypeError, ValueError):
        return False

def hook(event, args):
    if event == "open" and args and isinstance(args[0], (str, bytes, os.PathLike)) \
            and under(args[0]):
        seen.append(("open", os.fsdecode(args[0])))
    elif event == "subprocess.Popen":
        seen.extend(("run", str(a)) for a in (args[1] or ()) if "colxlip_tpu/" in str(a)
                    or under(a))

sys.addaudithook(hook)
import colxlip_tpu_torch
for mod in pkgutil.walk_packages(colxlip_tpu_torch.__path__, "colxlip_tpu_torch."):
    importlib.import_module(mod.name)
from colxlip_tpu_torch import native, factory
from colxlip_tpu_torch.data.tokenizer import SimpleTokenizer
native.BUILD_DIR = pathlib.Path(tempfile.mkdtemp())
native.load("bpe_tokenizer")
if native.libjpeg_present():
    native.load("dataloader")
SimpleTokenizer(context_length=16)(["a photo of a dog"])
factory.create_model("ViT-S-16-test-colxlip", "cpu")
repo = jax_pkg.parent
for script in [*sorted((repo / "scripts").glob("torch_*.py")),
               *sorted((repo / "examples").glob("torch_*.py"))]:
    spec = importlib.util.spec_from_file_location(script.stem, script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("loaded:", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "colxlip_tpu")))
print("seen:", seen)
"""


def test_port_reads_nothing_of_the_jax_package():
    """No import of jax or colxlip_tpu, and no path into colxlip_tpu/, in the
    port's sources (the C++ and CUDA sources included), in chip_smoke.py or
    in the port's scripts and example (``scripts/torch_*.py``,
    ``examples/torch_*.py``; the launchers ``scripts/torch_*.sh`` run the
    port's main only; mentions in comments and docstrings name the
    counterpart a file was ported from); and a process that imports every
    port module and every such script, builds the native core from scratch,
    tokenizes and builds a model opens no file under colxlip_tpu/, passes
    none to a compiler and loads no module of jax or colxlip_tpu."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", _OPEN_PROBE, str(REPO / "colxlip_tpu")],
                          cwd=REPO, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "COLXLIP_NATIVE_TOKENIZER": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "loaded: []" in proc.stdout and "seen: []" in proc.stdout, proc.stdout
    native_sources = [*(REPO / "colxlip_tpu_torch").rglob("*.cc"),
                      *(REPO / "colxlip_tpu_torch").rglob("*.cu"),
                      *(REPO / "colxlip_tpu_torch").rglob("*.cuh")]
    assert len(native_sources) >= 2
    for src in native_sources:
        assert not re.search(r"#\s*include\s*[<\"][^>\"]*colxlip_tpu/", src.read_text()), src
    importing = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|colxlip_tpu)(\.|\s|$)",
                           re.M)
    path_into = re.compile(r"""/\s*["']colxlip_tpu["']|["'/]colxlip_tpu/""")
    twins = [*(REPO / "scripts").glob("torch_*.py"), *(REPO / "examples").glob("torch_*.py")]
    assert len(twins) >= 18
    sources = [*(REPO / "colxlip_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py", *twins]
    assert len(sources) > 30
    launchers = sorted((REPO / "scripts").glob("torch_*.sh"))
    assert len(launchers) == 3
    for sh in launchers:
        text = sh.read_text()
        assert "-m colxlip_tpu_torch.main" in text and "colxlip_tpu." not in text.replace(
            "colxlip_tpu_torch.", ""), sh
    for src in sources:
        text = src.read_text()
        assert not importing.search(text), src
        code = "\n".join(line.split("#")[0] for line in text.split("\n"))
        code = re.sub(r'""".*?"""', "", code, flags=re.S)
        if src.name != "chip_smoke.py":          # its kernels line cites the files replaced
            assert not path_into.search(code), src
    from colxlip_tpu_torch.data import tokenizer
    from colxlip_tpu_torch.models import configs

    for path in (configs.MODEL_CONFIG_DIR, tokenizer._DATA_DIR):
        assert (REPO / "colxlip_tpu_torch") in path.parents, path


@pytest.mark.parametrize("dim,grid,cls", [(128, 4, True), (64, 7, False), (768, 14, True)])
def test_sincos_pos_embed_matches_jax(dim, grid, cls):
    want = jax_pos_embed.get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
    got = pos_embed.get_2d_sincos_pos_embed(dim, grid, cls_token=cls)
    assert got.dtype == np.float32 and got.shape == (grid * grid + int(cls), dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("old,new", [((4, 4), (7, 7)), ((14, 14), (4, 4)), ((4, 4), (4, 4)),
                                     ((3, 5), (6, 4))])
def test_interpolate_pos_embed_matches_jax(old, new):
    table = np.random.default_rng(0).standard_normal((1 + old[0] * old[1], 32)).astype(np.float32)
    want = jax_pos_embed.interpolate_pos_embed(jnp.asarray(table), new, old)
    got = pos_embed.interpolate_pos_embed(table, new, old)
    assert got.dtype == np.float32 and got.shape == (1 + new[0] * new[1], 32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0], table[0])            # the class row passes through


@pytest.mark.parametrize("prob,exclude_first", [(0.5, True), (0.75, True), (0.99, True),
                                                (0.5, False)])
def test_patch_dropout_select_matches_jax_top_k(prob, exclude_first):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17, 8)).astype(np.float32)
    n = 16 if exclude_first else 17
    scores = rng.standard_normal((3, n)).astype(np.float32)
    num_keep = max(1, int(n * (1.0 - prob)))
    _, idx = jax.lax.top_k(jnp.asarray(scores), num_keep)
    tokens = x[:, 1:] if exclude_first else x
    kept = np.take_along_axis(tokens, np.asarray(idx)[:, :, None], axis=1)
    want = np.concatenate([x[:, :1], kept], axis=1) if exclude_first else kept
    got = layers.patch_dropout_select(torch.from_numpy(x), torch.from_numpy(scores), prob,
                                      exclude_first)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
