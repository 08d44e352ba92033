"""The port's streaming contrastive CE against the JAX package on the CPU.

The same seeded numpy inputs go through ``colxlip_tpu.ops.fused_ce`` (its
Pallas kernels in interpret mode, as ``tests/test_fused_ce.py`` runs them)
and through ``colxlip_tpu_torch.ops.fused_ce`` (on CPU tensors: the plain
versions of the three CUDA kernels), then through ``clip_loss`` with
``ce_impl='fused'`` and through a whole ``clip`` train step of
``ViT-S-16-test``.

Tolerances: loss values 1e-5 relative; dA and dB 1e-4 relative + 1e-6
absolute; dscale 1e-4 relative (fp32 sums in another order); the train
step's losses 1e-5 relative and each gradient within 1e-4 of its largest
|g|, as in ``tests/test_torch_train.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.losses import clip_loss as jax_clip_loss
from colxlip_tpu.ops.fused_ce import fused_contrastive_ce as jax_fused_ce
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.losses import clip_loss
from colxlip_tpu_torch.models import CLIP
from colxlip_tpu_torch.ops import fused_ce
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.training import optim, schedules

from test_torch_train import _assert_step_matches, _batch, _grads_recorder

TINY_CLIP = "ViT-S-16-test"


def _feats(m, n, d=32, seed=0):
    rng = np.random.default_rng(seed)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    return (unit(rng.standard_normal((m, d))), unit(rng.standard_normal((n, d))),
            rng.integers(0, n, m).astype(np.int32))


def _jax_value_and_grads(a, b, labels, scale):
    def loss(a_, b_, s_):
        return jax_fused_ce(a_, b_, jnp.asarray(labels), s_, block_m=8, block_n=128,
                            interpret=True)
    value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.float32(scale))
    return float(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("m,n", [(24, 40), (8, 8), (33, 129)])
def test_fused_ce_matches_jax_kernel(m, n):
    a, b, labels = _feats(m, n)
    want, want_g = _jax_value_and_grads(a, b, labels, 30.0)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    scale = torch.tensor(30.0, requires_grad=True)
    got = fused_ce.fused_contrastive_ce(ta, tb, torch.from_numpy(labels), scale)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    da, db, ds = torch.autograd.grad(got, (ta, tb, scale))
    np.testing.assert_allclose(da.numpy(), want_g[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), want_g[1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ds.item(), float(want_g[2]), rtol=1e-4)
    assert ds.shape == scale.shape


def test_fused_ce_at_scale_100_stays_finite():
    """logit_scale at its clamp: the online sum must not overflow."""
    a, b, labels = _feats(16, 16)
    want, _ = _jax_value_and_grads(a, b, labels, 100.0)
    got = fused_ce.fused_contrastive_ce(torch.from_numpy(a), torch.from_numpy(b),
                                        torch.from_numpy(labels), 100.0)
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), want, rtol=1e-4)


@pytest.mark.parametrize("chunk", [16, 129, 1024])
def test_plain_versions_walk_column_chunks(chunk):
    """The three plain versions at a chunk that cuts N = 129 unevenly, at N
    exactly, and above it, against autograd through the dense logits with a
    non-uniform cotangent, with the scale at its clamp."""
    a, b, labels = _feats(33, 129, seed=1)
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.random(33).astype(np.float32))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    scale = torch.tensor(100.0, requires_grad=True)
    tl = torch.from_numpy(labels)
    rows = torch.nn.functional.cross_entropy(scale * ta @ tb.T, tl.long(), reduction="none")
    want = torch.autograd.grad(rows, (ta, tb, scale), g)
    with torch.no_grad():
        loss, lse = fused_ce.fused_ce_fwd_plain(ta, tb, tl, scale, chunk=chunk)
        da, ds = fused_ce.fused_ce_bwd_da_plain(ta, tb, tl, scale, lse, g, chunk=chunk)
        db = fused_ce.fused_ce_bwd_db_plain(ta, tb, tl, scale, lse, g, chunk=chunk)
    torch.testing.assert_close(loss, rows.detach(), rtol=1e-5, atol=1e-5)
    # at scale 100 the terms of each gradient are up to 100 and cancel, so the
    # bound is 1e-5 of the largest |grad|, not of each element
    for got, w in ((da, want[0]), (db, want[1]), (ds.sum(), want[2])):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5 * w.abs().max().item())


def test_fused_ce_bf16_inputs_and_gradient_dtypes():
    """bf16 features: the dot accumulates in fp32 from the bf16 values, the
    gradients come back in bf16, and labels get none."""
    a, b, labels = _feats(12, 20)
    ta, tb = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (a, b))
    scale = torch.tensor(20.0, requires_grad=True)
    got = fused_ce.fused_contrastive_ce(ta, tb, torch.from_numpy(labels), scale)
    want = torch.nn.functional.cross_entropy(
        scale.detach() * ta.detach().float() @ tb.detach().float().T,
        torch.from_numpy(labels).long())
    torch.testing.assert_close(got.detach(), want, rtol=1e-5, atol=0)
    da, db = torch.autograd.grad(got, (ta, tb))
    assert da.dtype == db.dtype == torch.bfloat16


def test_fused_ce_refuses_bad_shapes():
    a, b, labels = (torch.from_numpy(x) for x in _feats(4, 6))
    with pytest.raises(ValueError, match=r"a \[M, D\] and b \[N, D\]"):
        fused_ce.fused_contrastive_ce(a, b[:, :8], labels, 1.0)
    with pytest.raises(ValueError, match="labels must be"):
        fused_ce.fused_contrastive_ce(a, b, labels[:2], 1.0)
    with pytest.raises(ValueError, match="labels must be"):
        fused_ce.fused_contrastive_ce(a, b, labels.float(), 1.0)


def test_clip_loss_fused_matches_jax():
    m = 16
    img, txt, _ = _feats(m, m, seed=3)

    def jax_fn(i, t, s):
        return jax_clip_loss(i, t, s, ce_impl="fused")

    want, want_g = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(txt), jnp.float32(40.0))
    targs = [torch.from_numpy(img).requires_grad_(), torch.from_numpy(txt).requires_grad_(),
             torch.tensor(40.0, requires_grad=True)]
    got = clip_loss(*targs, ce_impl="fused")
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # and the dense path of the port gives the same loss
    np.testing.assert_allclose(got.item(), clip_loss(*targs).item(), rtol=1e-5)
    for g, w in zip(torch.autograd.grad(got, targs), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    assert clip_loss(*targs, ce_impl="fused", output_dict=True).keys() == {"total_loss"}


def test_clip_loss_fused_refuses_logit_bias_as_jax():
    img, txt, _ = _feats(4, 4)
    with pytest.raises(ValueError) as jax_err:
        jax_clip_loss(jnp.asarray(img), jnp.asarray(txt), jnp.float32(10.0),
                      logit_bias=jnp.float32(-1.0), ce_impl="fused")
    with pytest.raises(ValueError) as err:
        clip_loss(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(10.0),
                  logit_bias=torch.tensor(-1.0), ce_impl="fused")
    assert str(err.value) == str(jax_err.value)
    # the data axis needs a process group (parallel/mesh.py)
    with pytest.raises(RuntimeError, match="no process group"):
        clip_loss(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(10.0),
                  axis_name="data", ce_impl="fused")


@pytest.fixture(scope="module")
def jax_clip_model():
    model, _ = jax_create_model(TINY_CLIP, precision="fp32")
    imgs = jnp.zeros((1, 64, 64, 3), jnp.float32)
    txts = jnp.zeros((1, 32), jnp.int32).at[:, 0].set(49406).at[:, 1].set(49407)
    params = jax.jit(model.init)(jax.random.PRNGKey(5), imgs, txts)
    return model, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("accum_freq", [1, 2])
def test_clip_train_step_with_fused_ce_matches_jax(jax_clip_model, monkeypatch, accum_freq):
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")
    model, params = jax_clip_model
    imgs, txts = _batch(seed=6)
    tx = _grads_recorder()
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    jcfg = jax_ts.TrainStepConfig(loss_type="clip", ce_impl="fused", accum_freq=accum_freq)
    new_state, metrics = jax_ts.make_train_step(model, tx, jcfg, donate=False)(
        state, jnp.asarray(imgs), jnp.asarray(txts))
    want_g = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, new_state.opt_state))
    want_m = {k: float(v) for k, v in metrics.items()}

    port = CLIP(factory.model_config(TINY_CLIP), dtype=torch.float32)
    sd = convert.state_dict_from_jax_params(params)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    sched = schedules.cosine_lr(1e-3, 2, 10)
    step = make_train_step(
        port.train(), optim.create_optimizer(port, sched, weight_decay=0.1), sched,
        TrainStepConfig(loss_type="clip", ce_impl="fused", accum_freq=accum_freq))
    got_m = {k: float(v) for k, v in step(torch.from_numpy(imgs),
                                          torch.from_numpy(txts)).items()}
    got_g = {k: p.grad.numpy() for k, p in port.named_parameters()}
    _assert_step_matches(want_m, want_g, got_m, got_g)
