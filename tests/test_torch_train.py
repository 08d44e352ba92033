"""The port's train slice against the JAX package on the CPU: the model's
forward dict, the clip and colclip losses, the train step (losses, grad_norm
and every gradient), gradient accumulation, the optimizer, the schedules and
the logit-scale clamp. Tiny ``ViT-S-16-test-colxlip`` in fp32, the same
seeded numpy inputs and the same weights (JAX init ->
``convert.state_dict_from_jax_params`` -> strict load).

The JAX side runs with ``COLXLIP_GELU_IMPL=stock`` so that exact erf meets
the port's exact erf (the JAX default's degree-9 erf is 3.4e-6 away and
would take up the tolerance).

Tolerances: losses and grad_norm 1e-5 relative; each gradient tensor within
1e-4 of its largest |g| (fp32 sums in another order through two layers and
the MaxSim routing); the optimizer, fed the same gradients, within 1e-6.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.losses import clip_loss as jax_clip_loss
from colxlip_tpu.losses import colclip_loss as jax_colclip_loss
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu.training import optim as jax_optim
from colxlip_tpu.training import schedules as jax_schedules
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.losses import clip_loss, colclip_loss
from colxlip_tpu_torch.models import ColXLIP
from colxlip_tpu_torch.models import layers as layers_mod
from colxlip_tpu_torch.models.configs import CLIPVisionCfg
from colxlip_tpu_torch.models.vision import VisionTransformer
from colxlip_tpu_torch.models.layers import PatchDropout, gelu, patch_dropout_select
from colxlip_tpu_torch.parallel.train_step import (
    MAX_LOGIT_SCALE, TrainStepConfig, clamp_logit_scale, make_train_step)
from colxlip_tpu_torch.training import optim, schedules

TINY = "ViT-S-16-test-colxlip"
B = 4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
OPT_ATOL = 1e-6


@pytest.fixture(scope="module")
def jax_model():
    model, _ = jax_create_model(TINY, precision="fp32")
    imgs = jnp.zeros((1, 64, 64, 3), jnp.float32)
    txts = jnp.zeros((1, 32), jnp.int32).at[:, 0].set(49406).at[:, 1].set(49407)
    params = jax.jit(model.init)(jax.random.PRNGKey(3), imgs, txts)
    return model, jax.tree.map(np.asarray, params)


def _port_model(params) -> ColXLIP:
    model = ColXLIP(factory.model_config(TINY), dtype=torch.float32)
    sd = convert.state_dict_from_jax_params(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.train()


def _batch(seed=0, b=B, ctx=32):
    """Seeded NHWC images and token ids with EOT at a different place per row."""
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, 64, 64, 3)).astype(np.float32)
    txts = np.zeros((b, ctx), np.int32)
    txts[:, 0] = 49406
    txts[:, 1:12] = rng.integers(1, 49000, (b, 11))
    for i in range(b):
        txts[i, 6 + i] = 49407
        txts[i, 7 + i:] = 0
    return imgs, txts


def _grads_recorder() -> optax.GradientTransformation:
    """An optax transformation whose state becomes the gradients it is fed
    and whose update is zero: the JAX step's own gradients, exactly."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _jax_step_grads(jax_model, cfg, imgs, txts, monkeypatch):
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")
    model, params = jax_model
    tx = _grads_recorder()
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    step = jax_ts.make_train_step(model, tx, cfg, donate=False)
    new_state, metrics = step(state, jnp.asarray(imgs), jnp.asarray(txts))
    grads = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, new_state.opt_state))
    return {k: float(v) for k, v in metrics.items()}, grads


def _port_step(params, cfg, imgs, txts):
    model = _port_model(params)
    opt = optim.create_optimizer(model, schedules.cosine_lr(1e-3, 2, 10), weight_decay=0.1)
    step = make_train_step(model, opt, schedules.cosine_lr(1e-3, 2, 10), cfg)
    metrics = step(torch.from_numpy(imgs), torch.from_numpy(txts))
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


def _assert_step_matches(want_m, want_g, got_m, got_g):
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, err_msg=k)
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        tol = GRAD_REL * max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(got_g[k], w, rtol=0, atol=tol, err_msg=k)


def _dropout_tower(prob=0.5, generator=None) -> VisionTransformer:
    tower = VisionTransformer(CLIPVisionCfg(layers=1, width=64, head_width=32, image_size=64,
                                            patch_dropout=prob), 64, gelu, dtype=torch.float32)
    for p in tower.parameters():
        torch.nn.init.normal_(p, std=0.05, generator=torch.Generator().manual_seed(0))
    tower.patch_dropout.generator = generator
    return tower


def test_patch_dropout_keeps_top_k_tokens_when_training():
    """The module: identity in eval mode, max(1, int(n * (1 - p))) patch
    tokens by per-sample top-k of seeded normal scores when training, the
    class token always first."""
    x = torch.arange(2 * 17 * 4, dtype=torch.float32).reshape(2, 17, 4)
    drop = PatchDropout(0.75, generator=torch.Generator().manual_seed(5))
    assert drop.eval()(x) is x
    got = drop.train()(x)
    scores = torch.randn((2, 16), generator=torch.Generator().manual_seed(5))
    assert got.shape == (2, 1 + 4, 4) and torch.equal(got[:, 0], x[:, 0])
    assert torch.equal(got, patch_dropout_select(x, scores, 0.75))
    for b in range(2):           # the kept rows are patch tokens of that sample, no repeats
        rows = {tuple(r.tolist()) for r in got[b, 1:]}
        assert len(rows) == 4 and rows <= {tuple(r.tolist()) for r in x[b, 1:]}
    assert patch_dropout_select(x, scores, 0.999).shape == (2, 2, 4)      # never fewer than one
    assert PatchDropout(0.0).train()(x) is x
    with pytest.raises(ValueError, match="prob"):
        PatchDropout(1.0)
    with pytest.raises(ValueError, match="scores"):
        patch_dropout_select(x, scores[:, :5], 0.5)


def test_patch_dropout_in_the_vision_tower():
    """Before ln_pre, only when training: 16 patch tokens become 8; the same
    seed drops the same tokens; eval mode sees all 16."""
    images = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    tower = _dropout_tower(generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        pooled_eval, tokens_eval = tower.eval()(images)
        pooled, tokens = tower.train()(images)
        tower.patch_dropout.generator = torch.Generator().manual_seed(2)
        again = tower(images)
    assert tokens_eval.shape == (3, 16, 64) and tokens.shape == (3, 8, 64)
    assert torch.equal(again[0], pooled) and torch.equal(again[1], tokens)
    assert not torch.allclose(pooled, pooled_eval)
    # a gradient reaches the parameters through the kept tokens
    tower(images)[1].square().sum().backward()
    assert tower.conv1.weight.grad.abs().sum() > 0


def test_patch_dropout_needs_a_generator_and_the_step_refuses_it_as_jax_does(monkeypatch):
    """What the JAX step does with patch_dropout > 0, pinned beside the
    port's answer: it applies the model with train=True and no rngs, so
    flax raises InvalidRngError for the 'patch_dropout' stream. The port's
    module raises without a generator, and make_train_step refuses the model."""
    import flax

    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")
    from colxlip_tpu.factory import create_model as create

    jmodel, jcfg = create(TINY, precision="fp32", force_patch_dropout=0.5)
    imgs, txts = _batch(seed=5)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(txts))
    tx = _grads_recorder()
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    step = jax_ts.make_train_step(jmodel, tx, jax_ts.TrainStepConfig(loss_type="colclip"),
                                  donate=False)
    with pytest.raises(flax.errors.InvalidRngError, match="patch_dropout"):
        step(state, jnp.asarray(imgs), jnp.asarray(txts))

    with pytest.raises(RuntimeError, match="needs a torch.Generator"):
        _dropout_tower().train()(torch.from_numpy(imgs))
    model, cfg = factory.create_model(TINY, "cpu", torch.float32, force_patch_dropout=0.5)
    assert cfg.vision_cfg.patch_dropout == jcfg.vision_cfg.patch_dropout == 0.5
    with pytest.raises(NotImplementedError, match="InvalidRngError"):
        make_train_step(model.train(), optim.create_optimizer(model, 1e-3), None,
                        TrainStepConfig(loss_type="colclip"))
    with torch.no_grad():         # serving such a model is fine: eval mode drops nothing
        assert model.eval().encode_image(torch.from_numpy(imgs))[1].shape == (B, 16, 128)


def test_forward_dict_matches_jax(jax_model, monkeypatch):
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")
    model, params = jax_model
    imgs, txts = _batch(seed=1)
    want = model.apply(params, jnp.asarray(imgs), jnp.asarray(txts), train=True)
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(imgs), torch.from_numpy(txts))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=1e-5, err_msg=k)


def _features(seed=0, b=5, lt=9, li=11, d=16):
    rng = np.random.default_rng(seed)
    unit = lambda *s: (lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True))(  # noqa: E731
        rng.standard_normal(s)).astype(np.float32)
    tok_t = unit(b, lt, d)
    tok_t[0, 5:] = 0.0
    return [unit(b, d), unit(b, d), unit(b, li, d), tok_t]


@pytest.mark.parametrize("loss", ["clip", "colclip-nonzero", "colclip-valid",
                                  "colclip-nonzero-int8", "colclip-valid-int8"])
@pytest.mark.parametrize("bias", [None, -1.5])
def test_losses_match_jax(loss, bias):
    feats = _features()
    mask = (np.arange(9)[None, :] < np.array([5, 9, 3, 7, 8])[:, None]).astype(np.float32)
    scale = np.float32(11.0)
    # the int8 forward on the same features quantizes the same rows to the same
    # integers on both sides, so the bars of the default forward hold
    impl = "streaming_int8" if loss.endswith("-int8") else "streaming"

    def jax_fn(img, txt, tok_i, tok_t, s):
        b = None if bias is None else jnp.float32(bias)
        if loss == "clip":
            return jax_clip_loss(img, txt, s, logit_bias=b)
        mode = loss.split("-")[1]
        return jax_colclip_loss(img, txt, tok_i, tok_t, s, alpha=0.3, logit_bias=b,
                                maxsim_impl=impl, mask_mode=mode,
                                text_mask=jnp.asarray(mask) if mode == "valid" else None,
                                output_dict=False)

    args = [jnp.asarray(f) for f in feats] + [jnp.asarray(scale)]
    want, want_g = jax.value_and_grad(jax_fn, argnums=tuple(range(5)))(*args)
    targs = [torch.from_numpy(f).requires_grad_() for f in feats]
    targs.append(torch.tensor(scale, requires_grad=True))
    tb = None if bias is None else torch.tensor(bias)
    if loss == "clip":
        got = clip_loss(targs[0], targs[1], targs[4], logit_bias=tb)
    else:
        mode = loss.split("-")[1]
        got = colclip_loss(*targs, alpha=0.3, logit_bias=tb, mask_mode=mode, maxsim_impl=impl,
                           text_mask=torch.from_numpy(mask) if mode == "valid" else None,
                           output_dict=False)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    got_g = torch.autograd.grad(got, targs, allow_unused=True)
    for g, w in zip(got_g, want_g):
        g = np.zeros_like(np.asarray(w)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("loss_type,mask_mode", [
    ("colclip", "nonzero"), ("colclip", "valid"), ("clip", "nonzero")])
def test_train_step_matches_jax(jax_model, monkeypatch, loss_type, mask_mode):
    cfg = TrainStepConfig(loss_type=loss_type, mask_mode=mask_mode, maxsim_impl="streaming")
    jcfg = jax_ts.TrainStepConfig(loss_type=loss_type, mask_mode=mask_mode,
                                  maxsim_impl="streaming")
    imgs, txts = _batch(seed=2)
    want = _jax_step_grads(jax_model, jcfg, imgs, txts, monkeypatch)
    _assert_step_matches(*want, *_port_step(jax_model[1], cfg, imgs, txts))


def test_train_step_with_streaming_int8_matches_jax(jax_model, monkeypatch):
    """maxsim_impl='streaming_int8' trains a step: the int8 MaxSim forward and
    the straight-through backward against the JAX step under the same flag."""
    cfg = TrainStepConfig(loss_type="colclip", maxsim_impl="streaming_int8")
    jcfg = jax_ts.TrainStepConfig(loss_type="colclip", maxsim_impl="streaming_int8")
    imgs, txts = _batch(seed=7)
    want = _jax_step_grads(jax_model, jcfg, imgs, txts, monkeypatch)
    got = _port_step(jax_model[1], cfg, imgs, txts)
    _assert_step_matches(*want, *got)
    default = _port_step(jax_model[1], TrainStepConfig(loss_type="colclip"), imgs, txts)
    assert got[0]["token_contrastive_loss"] != default[0]["token_contrastive_loss"]


@pytest.mark.parametrize("loss_type", ["colclip", "clip"])
def test_train_step_through_fused_kernels_matches_jax(jax_model, monkeypatch, loss_type):
    """The whole slice with COLXLIP_LN_IMPL=fused COLXLIP_MLP_IMPL=fused on
    the port's side (on the CPU: the kernels' plain versions, their erf
    polynomial 1.5e-7 from erf) against the JAX step's losses and gradients."""
    cfg = TrainStepConfig(loss_type=loss_type, maxsim_impl="streaming")
    jcfg = jax_ts.TrainStepConfig(loss_type=loss_type, maxsim_impl="streaming")
    imgs, txts = _batch(seed=6)
    want = _jax_step_grads(jax_model, jcfg, imgs, txts, monkeypatch)
    # set after the JAX step ran: the JAX package reads the same variables
    monkeypatch.setenv("COLXLIP_LN_IMPL", "fused")
    monkeypatch.setenv("COLXLIP_MLP_IMPL", "fused")
    calls = []
    real = layers_mod.fused_mlp
    monkeypatch.setattr(layers_mod, "fused_mlp",
                        lambda *a, **k: calls.append("mlp") or real(*a, **k))
    _assert_step_matches(*want, *_port_step(jax_model[1], cfg, imgs, txts))
    assert len(calls) == 4        # one a block, two blocks a tower


def test_accum_freq_2_matches_jax(jax_model, monkeypatch):
    cfg = TrainStepConfig(loss_type="colclip", accum_freq=2, maxsim_impl="streaming")
    jcfg = jax_ts.TrainStepConfig(loss_type="colclip", accum_freq=2, maxsim_impl="streaming")
    imgs, txts = _batch(seed=3)
    want = _jax_step_grads(jax_model, jcfg, imgs, txts, monkeypatch)
    _assert_step_matches(*want, *_port_step(jax_model[1], cfg, imgs, txts))


def test_train_step_loss_falls(jax_model):
    model = _port_model(jax_model[1])
    sched = schedules.const_lr(1e-3, 0)
    step = make_train_step(model, optim.create_optimizer(model, sched, weight_decay=0.0),
                           sched, TrainStepConfig(loss_type="colclip"))
    imgs, txts = _batch(seed=4)
    losses = [float(step(torch.from_numpy(imgs), torch.from_numpy(txts))["total_loss"])
              for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert model.logit_scale.item() <= MAX_LOGIT_SCALE and step.step == 4


def _random_grads(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                        params)


@pytest.mark.parametrize("clip_norm,lock_image,lock_text", [
    (None, False, False), (0.5, False, False), (None, True, False), (100.0, False, True)])
def test_optimizer_schedule_and_clamp_match_optax(jax_model, clip_norm, lock_image, lock_text):
    """Both optimizers fed the same gradients for three steps; logit_scale
    starts just under ln 100 and is pushed over it, so the clamp acts."""
    params = jax.tree.map(np.copy, jax_model[1])
    params["params"]["logit_scale"] = np.float32(MAX_LOGIT_SCALE - 1e-4)
    jsched = jax_schedules.cosine_lr(1e-2, 1, 5)
    tx = jax_optim.create_optimizer(jsched, weight_decay=0.1, grad_clip_norm=clip_norm,
                                    lock_image=lock_image, lock_text=lock_text)
    sched = schedules.cosine_lr(1e-2, 1, 5)
    model = _port_model(params)
    opt = optim.create_optimizer(model, sched, weight_decay=0.1, grad_clip_norm=clip_norm,
                                 lock_image=lock_image, lock_text=lock_text)
    named = dict(model.named_parameters())
    jparams, state = jax.tree.map(jnp.asarray, params), tx.init(params)
    for i in range(3):
        grads = _random_grads(params, seed=i, scale=0.01)
        grads["params"]["logit_scale"] = np.float32(-1.0)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = jax_ts._clamp_logit_scale(optax.apply_updates(jparams, updates))
        for k, g in convert.state_dict_from_jax_params(grads).items():
            named[k].grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = sched(i)
        opt.step()
        clamp_logit_scale(model)
    want = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, jparams))
    got = {k: p.detach().numpy() for k, p in named.items()}
    assert float(got["logit_scale"]) == pytest.approx(MAX_LOGIT_SCALE)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=OPT_ATOL, err_msg=k)
    frozen = [k for k in named if optim.is_frozen(k, lock_image, lock_text)]
    assert bool(frozen) == (lock_image or lock_text)
    for k in frozen:
        np.testing.assert_array_equal(got[k], convert.state_dict_from_jax_params(params)[k])


@pytest.mark.parametrize("name,args", [
    ("cosine_lr", (1e-3, 5, 40)), ("const_lr", (1e-3, 5)),
    ("const_lr_cooldown", (1e-3, 5, 40, 10, 2.0, 1e-5)),
    ("const_lr_cooldown", (1e-3, 8, 10, 6))])
def test_schedules_match_jax(name, args):
    want = getattr(jax_schedules, name)(*args)
    got = getattr(schedules, name)(*args)
    # the JAX schedule runs in fp32: near the end of the cosine its
    # cancellation error is about fp32 eps x base_lr (1e-10 here)
    for step in range(45):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-9), step


def test_decay_mask_maps_one_to_one(jax_model):
    params = jax_model[1]
    mask = jax_optim.decay_mask(params)
    as_arrays = jax.tree.map(lambda p, m: np.full(np.shape(p), float(m), np.float32),
                             params, mask)
    want = convert.state_dict_from_jax_params(as_arrays)
    model = _port_model(params)
    for name, p in model.named_parameters():
        values = np.unique(want[name])
        assert values.size == 1, name
        assert bool(values[0]) == (not optim.is_no_decay(name, p)), name
    groups = optim.param_groups(model.named_parameters(), 0.2)
    assert sum(len(g["params"]) for g in groups) == len(want)
    assert sum(bool(np.unique(v)[0]) for v in want.values()) == len(groups[1]["params"])


def test_unported_options_raise(jax_model):
    feats = [torch.from_numpy(f) for f in _features()]
    scale = torch.tensor(10.0)
    with pytest.raises(ValueError, match="fused CE path does not support logit_bias"):
        clip_loss(feats[0], feats[1], scale, ce_impl="fused", logit_bias=torch.tensor(-1.0))
    # the data axis needs a process group (parallel/mesh.py); the
    # neighbourhood cap needs the ring, as in JAX
    with pytest.raises(RuntimeError, match="no process group"):
        clip_loss(feats[0], feats[1], scale, axis_name="data")
    with pytest.raises(ValueError, match="token_neighborhood requires token_dist='ring'"):
        colclip_loss(*feats, scale, token_neighborhood=2)
    with pytest.raises(ValueError, match="unknown impl"):
        colclip_loss(*feats, scale, maxsim_impl="int8")
    model = _port_model(jax_model[1])
    opt = optim.create_optimizer(model, 1e-3)
    with pytest.raises(ValueError, match="unknown axis"):
        make_train_step(model, opt, None, TrainStepConfig(), mesh="model")
    # every JAX loss type is ported (siglip, coca and distill since their
    # slice: tests/test_torch_siglip.py, tests/test_torch_coca.py); an unknown
    # one raises the JAX ValueError
    step = make_train_step(model, opt, None, dataclasses.replace(
        TrainStepConfig(), loss_type="triplet"))
    imgs, txts = _batch()
    with pytest.raises(ValueError, match="unknown loss_type: 'triplet'"):
        step(torch.from_numpy(imgs), torch.from_numpy(txts))
