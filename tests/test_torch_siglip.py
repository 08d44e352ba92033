"""The port's SigLIP and distillation losses against the JAX package.

- ``siglip_loss`` at one device, with and without ``logit_bias``: the value
  and the gradients of the features, the scale and the bias;
- at 4 ranks, every ``dist_impl`` ('bidir', 'shift', 'reduce', 'gather';
  'bidir' and 'reduce' also with a bias) and ``distill_clip_loss`` (full and
  local loss, with and without ``gather_with_grad``): the port runs as 4
  gloo ranks (``tests/torch_dist_worker.py`` suite ``siglip``, spawned once
  for the file), the JAX side through ``shard_map`` over 4 virtual CPU
  devices (``check_vma=False``, as its train step), rank by rank against the
  JAX device of the same index; an unknown ``dist_impl`` raises the JAX
  ``ValueError``;
- ``distill_clip_loss`` at one device, and one train step each of
  'distill' (a ``ViT-S-16-test`` teacher on other weights) and 'siglip'
  against the JAX step's losses and gradients; the teacher's weights do not
  move and get no gradient.

Everything in fp32 on the same seeded numpy inputs and the same weights
(JAX init -> ``convert.state_dict_from_jax_params`` -> strict load).
Tolerances: losses 1e-5 relative; each gradient within 1e-5 of its largest
magnitude for the losses, 1e-4 for the steps (two towers of fp32 sums in
another order), as ``tests/test_torch_train.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.losses import distill_clip_loss as jax_distill_loss
from colxlip_tpu.losses import siglip_loss as jax_siglip_loss
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.losses import distill_clip_loss, siglip_loss
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.training import optim

import torch_dist_worker as worker

W, B, D = 4, 3, 16
N = W * B
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
STEP_GRAD_REL = 1e-4
TINY = "ViT-S-16-test"


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(16)
    return {k: _unit(rng.standard_normal((N, D)))
            for k in ("image", "text", "dist_image", "dist_text")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the 4 ranks' results): the ranks are spawned once here."""
    work = tmp_path_factory.mktemp("dist_siglip")
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    return inputs, worker.spawn_ranks("siglip", W, str(work / "inputs.npz"), str(work))


def _sharded(fn, n_in, n_out):
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("data"),) * n_in,
                             out_specs=(P("data"),) * n_out, check_vma=False))


def _jax_case(kind, kw, inputs):
    """(values [W], grads: list of [W, ...]) device by device."""
    kw = dict(kw)
    scale = jnp.float32(worker.LOSS_SCALE)
    bias = kw.pop("bias", False)

    def loss(img, txt, b, dimg, dtxt):
        if kind == "siglip":
            return jax_siglip_loss(img, txt, scale, b[0] if bias else None, axis_name="data",
                                   axis_size=W, **kw)
        c, d = jax_distill_loss(img, txt, scale, dimg, dtxt,
                                jnp.float32(worker.LOSS_SCALE / 2), axis_name="data", **kw)
        return c + d

    def per(img, txt, b, dimg, dtxt):
        value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(img, txt, b, dimg, dtxt)
        return (value[None], *grads)
    bias_arr = np.full((W,), worker.LOSS_BIAS, np.float32)
    out = _sharded(per, 5, 4)(inputs["image"], inputs["text"], bias_arr,
                              inputs["dist_image"], inputs["dist_text"])
    grads = [np.asarray(g).reshape(W, B, D) for g in out[1:3]]
    if bias:
        grads.append(np.asarray(out[3]).reshape(W))
    return np.asarray(out[0]), grads


@pytest.mark.parametrize("case", worker.loss_cases("siglip"))
def test_port_rank_matches_jax_device(runs, case):
    inputs, ranks = runs
    kind, kw = worker.LOSS_CASES[case]
    want_value, want_grads = _jax_case(kind, kw, inputs)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{case}/value"], want_value[r], rtol=LOSS_RTOL,
                                   err_msg=f"{case} rank {r}")
        for i, want in enumerate(want_grads):
            tol = GRAD_REL * max(np.abs(want).max(), 1e-12)
            np.testing.assert_allclose(got[f"{case}/grad{i}"], want[r], rtol=0, atol=tol,
                                       err_msg=f"{case} rank {r} grad {i}")


def test_siglip_exchanges_agree_and_unknown_impl_raises_as_jax(runs):
    """The four exchanges add the same negatives (each rank's loss equal
    across them within 1e-5), and an unknown dist_impl raises the JAX
    ValueError on every rank."""
    inputs, ranks = runs
    for r in ranks:
        values = [float(r[f"siglip_{impl}/value"]) for impl in ("bidir", "shift", "reduce",
                                                                "gather")]
        np.testing.assert_allclose(values, values[0], rtol=LOSS_RTOL)

    def bad(img, txt):
        return jax_siglip_loss(img, txt, jnp.float32(10.0), axis_name="data",
                               dist_impl="ring")[None]
    with pytest.raises(ValueError) as jax_err:
        _sharded(bad, 2, 1)(inputs["image"], inputs["text"])
    for r in ranks:
        assert str(r["siglip_unknown_dist_impl"]) == str(jax_err.value)


@pytest.mark.parametrize("bias", [None, -1.5])
def test_siglip_one_device_matches_jax(bias):
    inputs = _inputs()
    scale = np.float32(9.0)

    def jax_fn(img, txt, s, b):
        return jax_siglip_loss(img, txt, s, None if bias is None else b)
    want, want_g = jax.value_and_grad(jax_fn, argnums=(0, 1, 2, 3))(
        jnp.asarray(inputs["image"]), jnp.asarray(inputs["text"]), jnp.float32(scale),
        jnp.float32(0.0 if bias is None else bias))
    args = [torch.from_numpy(inputs["image"]).requires_grad_(),
            torch.from_numpy(inputs["text"]).requires_grad_(),
            torch.tensor(scale, requires_grad=True)]
    b = None if bias is None else torch.tensor(bias, requires_grad=True)
    got = siglip_loss(*args, b)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for t, w in zip(args + ([b] if b is not None else []), want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_REL * max(np.abs(w).max(), 1e-12))


def test_distill_one_device_matches_jax():
    inputs = _inputs()
    names = ("image", "text", "dist_image", "dist_text")

    def jax_fn(img, txt, s, dimg, dtxt):
        return jax_distill_loss(img, txt, s, dimg, dtxt, jnp.float32(7.0), output_dict=True)
    want = jax_fn(*(jnp.asarray(inputs[k]) for k in names[:2]), jnp.float32(12.0),
                  *(jnp.asarray(inputs[k]) for k in names[2:]))
    want_g = jax.grad(lambda *a: sum(jax_fn(*a).values()), argnums=(0, 1, 2))(
        *(jnp.asarray(inputs[k]) for k in names[:2]), jnp.float32(12.0),
        *(jnp.asarray(inputs[k]) for k in names[2:]))
    args = [torch.from_numpy(inputs["image"]).requires_grad_(),
            torch.from_numpy(inputs["text"]).requires_grad_(),
            torch.tensor(12.0, requires_grad=True)]
    teacher = [torch.from_numpy(inputs[k]).requires_grad_() for k in names[2:]]
    got = distill_clip_loss(*args, *teacher, torch.tensor(7.0), output_dict=True)
    for k in ("contrastive_loss", "distill_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    sum(got.values()).backward()
    for t, w in zip(args, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_REL * max(np.abs(w).max(), 1e-12))
    assert all(t.grad is None for t in teacher)        # the teacher's features are detached


def _grads_recorder():
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _batch(seed, b=4, ctx=32):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, 64, 64, 3)).astype(np.float32)
    txts = np.zeros((b, ctx), np.int32)
    txts[:, 0] = 49406
    txts[:, 1:10] = rng.integers(1, 49000, (b, 9))
    for i in range(b):
        txts[i, 5 + i] = 49407
        txts[i, 6 + i:] = 0
    return imgs, txts


def _jax_init(model, seed, imgs, txts):
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.asarray(imgs[:1]), jnp.asarray(txts[:1])))


def _port(params):
    model, _ = factory.create_model(TINY, "cpu", torch.float32)
    sd = convert.state_dict_from_jax_params(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


@pytest.mark.parametrize("loss_type", ["distill", "siglip"])
def test_step_matches_jax(loss_type, monkeypatch):
    """One step: the losses, grad_norm and every student gradient against the
    JAX step's (read through an optax transformation that keeps them); the
    port's teacher is not in the optimizer and keeps its weights."""
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")
    jmodel, _ = jax_create_model(TINY, precision="fp32")
    imgs, txts = _batch(seed=3)
    params = _jax_init(jmodel, 1, imgs, txts)
    teacher = None
    if loss_type == "distill":
        t_params = _jax_init(jmodel, 2, imgs, txts)
        teacher = (jmodel, t_params)
    tx = _grads_recorder()
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    cfg = jax_ts.TrainStepConfig(loss_type=loss_type)
    step = jax_ts.make_train_step(jmodel, tx, cfg, donate=False, teacher=teacher)
    new_state, metrics = step(state, jnp.asarray(imgs), jnp.asarray(txts))
    want_g = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, new_state.opt_state))

    model = _port(params).train()
    port_teacher = _port(t_params) if teacher else None
    before = {k: v.clone() for k, v in port_teacher.state_dict().items()} if teacher else {}
    opt = optim.create_optimizer(model, 1e-3)
    got = make_train_step(model, opt, None, TrainStepConfig(loss_type=loss_type),
                          teacher=port_teacher)(torch.from_numpy(imgs), torch.from_numpy(txts))
    assert set(got) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    for k, w in want_g.items():
        p = dict(model.named_parameters())[k]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=STEP_GRAD_REL * max(np.abs(w).max(), 1e-12),
                                   err_msg=k)
    if teacher:
        assert not port_teacher.training
        for k, v in port_teacher.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert all(p.grad is None for p in port_teacher.parameters())
        teacher_ids = {id(p) for p in port_teacher.parameters()}
        assert not any(id(p) in teacher_ids for g in opt.param_groups for p in g["params"])
