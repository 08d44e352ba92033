"""``--precision pure_bf16`` in the port against the JAX package on the CPU.

The JAX ``PrecisionPolicy`` 'pure_bf16' creates every Dense kernel and bias,
the attention projections, the token embedding, the patchify kernel and
CoCa's vocab head in bf16, and keeps LayerNorm, the class and positional
embeddings, the tower projections, the pooler's queries and the logit scale
in fp32; optax's AdamW keeps its moments in the parameter's dtype, as
``torch.optim.AdamW`` does. Held here:

- the port's parameter dtypes equal the JAX tree's, key by key, for
  ``ViT-S-16-test-colxlip``, ``ViT-S-16-test`` and ``coca-S-test``;
- ``convert.state_dict_from_jax_params`` takes the bf16 leaves and widens
  them exactly to fp32;
- one colclip step on ``ViT-S-16-test-colxlip`` from the same bf16 weights
  (both ``COLXLIP_GELU_IMPL=stock``), at bf16 tolerances: the losses and
  ``grad_norm`` within 2e-2 relative (bf16 compute in both towers); the
  first moment (0.1 x the gradient, in each parameter's dtype) per tensor
  at cosine >= 0.98 with norms within 5e-2 (``chip_smoke.py``'s bf16 step
  bar), except that a tensor whose moment's norm is under 1e-2 of the
  largest (the logit scale's: a sum over the logits that cancels, 2.8e-3 of
  the largest here) is held by its difference, under 1e-3 of the largest;
  every updated parameter within 2 lr (1 + wd) + 2 ulps of its dtype (at
  the larger of the old and the new value) of JAX's: a first AdamW step
  moves an element by lr (g / (|g| + eps) + wd p), so an element whose
  gradient is at the bf16 noise level (the key bias of every attention has
  a zero gradient by construction) may move either way;
- ``main --precision pure_bf16`` trains, saves bf16 weights and moments
  (LayerNorm fp32) and resumes from them.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu.training import optim as jax_optim
from colxlip_tpu.training import schedules as jax_schedules
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch import main as main_mod
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.training import checkpoint, optim, schedules

TINY = "ViT-S-16-test-colxlip"
LOSS_RTOL = 2e-2
COS_MIN, NORM_TOL = 0.98, 5e-2
SMALL_MOMENT, SMALL_DIFF = 1e-2, 1e-3
LR, WD = 1e-3, 0.1


def _jax_params(name, seed=3):
    model, _ = jax_create_model(name, precision="pure_bf16")
    imgs = jnp.zeros((1, 64, 64, 3), jnp.float32)
    txts = jnp.zeros((1, 32), jnp.int32).at[:, 0].set(49406).at[:, 1].set(49407)
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed), imgs, txts)


@pytest.mark.parametrize("name", [TINY, "ViT-S-16-test", "coca-S-test"])
def test_parameter_dtypes_follow_the_jax_policy(name):
    """A leaf's marker (1 where the JAX leaf is bf16, 0 where fp32) goes
    through the converter's own key mapping to the port's key."""
    _, params = _jax_params(name)
    markers = jax.tree.map(lambda v: np.full(v.shape, float(v.dtype == jnp.bfloat16),
                                             np.float32), params)
    want = {k: bool(v.reshape(-1)[0]) if v.size else None
            for k, v in convert.state_dict_from_jax_params(markers).items()}
    model, _ = factory.create_model(name, "cpu", factory.compute_dtype("pure_bf16"),
                                    param_dtype=factory.param_dtype("pure_bf16"))
    got = {k: p.dtype == torch.bfloat16 for k, p in model.named_parameters()}
    assert got == want
    assert any(got.values()) and not all(got.values())
    assert factory.param_dtype("bf16") == torch.float32
    with pytest.raises(ValueError, match="precision"):
        factory.compute_dtype("fp8")


def test_convert_widens_bf16_leaves_exactly():
    _, params = _jax_params(TINY)
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    leaf = np.asarray(params["params"]["visual"]["transformer"]["resblocks_0"]["mlp"]
                      ["c_fc"]["kernel"])
    assert leaf.dtype == ml_dtypes.bfloat16
    got = sd["visual.transformer.resblocks.0.mlp.c_fc.weight"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, leaf.astype(np.float32).T)
    model, _ = factory.create_model(TINY, "cpu", torch.bfloat16, param_dtype=torch.bfloat16)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    back = model.visual.transformer.resblocks[0].mlp.c_fc.weight
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.detach().float().numpy(), got)     # bf16 -> fp32 -> bf16


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, 64, 64, 3)).astype(np.float32)
    txts = np.zeros((b, 32), np.int32)
    txts[:, 0] = 49406
    txts[:, 1:8] = rng.integers(1, 49000, (b, 7))
    for r in range(b):
        txts[r, 6 + r] = 49407
        txts[r, 7 + r:] = 0
    return imgs, txts


def _ulp(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """The spacing of ``dtype`` at |x| (bf16: 8 significant bits)."""
    x = np.maximum(np.abs(x.astype(np.float64)), 1e-30)
    bits = 8 if dtype == torch.bfloat16 else 24
    return 2.0 ** (np.floor(np.log2(x)) - (bits - 1))


def test_pure_bf16_step_matches_jax(monkeypatch):
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")
    jmodel, params = _jax_params(TINY, seed=5)
    imgs, txts = _batch()
    sched = (LR, 2, 10)
    tx = jax_optim.create_optimizer(jax_schedules.cosine_lr(*sched), weight_decay=WD)
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    cfg = dict(loss_type="colclip", alpha=0.5)
    jstep = jax_ts.make_train_step(jmodel, tx, jax_ts.TrainStepConfig(**cfg), donate=False)
    new_state, want = jstep(state, jnp.asarray(imgs), jnp.asarray(txts))
    np_tree = jax.tree.map(np.asarray, new_state)
    want_params = convert.state_dict_from_jax_params(np_tree.params)
    mu = next(s for s in jax.tree.leaves(np_tree.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
              if hasattr(s, "mu")).mu
    want_mu = convert.state_dict_from_jax_params(mu)

    model, _ = factory.create_model(TINY, "cpu", torch.bfloat16, param_dtype=torch.bfloat16)
    sd = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    model.train()
    opt = optim.create_optimizer(model, schedules.cosine_lr(*sched), weight_decay=WD)
    step = make_train_step(model, opt, schedules.cosine_lr(*sched), TrainStepConfig(**cfg))
    got = step(torch.from_numpy(imgs), torch.from_numpy(txts))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)

    lr = schedules.cosine_lr(*sched)(0)
    largest = max(np.linalg.norm(w) for w in want_mu.values())
    for name, p in model.named_parameters():
        m = opt.state[p]["exp_avg"]
        assert m.dtype == p.dtype, name                  # moments in the parameter's dtype
        g, w = m.double(), torch.from_numpy(want_mu[name]).double()
        if w.norm() < SMALL_MOMENT * largest:
            assert float((g - w).norm()) <= SMALL_DIFF * largest, name
        else:
            cos = float((g * w).sum() / (g.norm() * w.norm()))
            assert cos >= COS_MIN, (name, cos)
            assert abs(float(g.norm() / w.norm()) - 1) <= NORM_TOL, name
        new, ref = p.detach().float().numpy(), want_params[name]
        err = np.abs(new.astype(np.float64) - ref)
        ulps = 2 * _ulp(np.maximum(np.abs(ref), np.abs(sd[name])), p.dtype)
        assert (err <= 2 * lr * (1 + WD * np.abs(ref)) + ulps).all(), (name, err.max())


def test_main_trains_pure_bf16_and_resumes_its_bf16_state(tmp_path):
    argv = ["--device", "cpu", "--model", "ViT-S-16-test", "--dataset-type", "synthetic",
            "--train-num-samples", "8", "--batch-size", "8", "--epochs", "1",
            "--precision", "pure_bf16", "--logs", str(tmp_path), "--name", "bf16",
            "--workers", "0", "--log-every-n-steps", "1", "--save-frequency", "1",
            "--seed", "0"]
    assert main_mod.main(argv) == 0
    state = checkpoint.load_native_checkpoint(
        os.path.join(tmp_path, "bf16", "checkpoints", "epoch_1"))["state"]
    sd = state["state_dict"]
    assert sd["visual.transformer.resblocks.0.mlp.c_fc.weight"].dtype == torch.bfloat16
    assert sd["visual.ln_pre.weight"].dtype == torch.float32
    moments = {v["exp_avg"].dtype for v in state["optimizer"]["state"].values()}
    assert moments == {torch.bfloat16, torch.float32}
    argv[argv.index("--epochs") + 1] = "2"
    assert main_mod.main([*argv, "--resume", "latest"]) == 0
    with open(os.path.join(tmp_path, "bf16", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) for r in records)
