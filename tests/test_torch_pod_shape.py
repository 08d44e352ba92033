"""The port's pod-shape step (``colxlip_tpu_torch/parallel/pod_shape.py``)
against the JAX package's on the CPU.

Fixtures as ``tests/test_pod_shape.py``: 8 ranks of b = 2, D 16, 5 image and
7 text tokens, EOT-zeroed text tails. ``pod_shape_loss`` with the true
per-rank banks (the ring layout: slot s on rank r holds the image block of
rank r - s and the text block of rank r + s) in both window modes and at
neighbourhoods 2 and 0 (the full ring): the loss and the gradients for the
local features and every bank against the JAX ``pod_shape_loss``
(maxsim 'xla'), and the mean over ranks against the JAX 8-device mesh loss
(``shard_map`` over the virtual CPU devices). Tolerance: losses 1e-5
relative, each gradient within 1e-5 of its largest |g|.

The banks of ``make_pod_banks`` equal the JAX rolls and carry no gradient
without ``gather_with_grad``; one ``make_pod_shape_step`` on
``ViT-S-16-test-colxlip`` in fp32 from the JAX weights against the JAX step
(both ``COLXLIP_GELU_IMPL=stock``): losses and ``grad_norm`` 1e-5 relative,
the updated parameters within ``_adam_tol``: a gradient bar (1e-4 of the
tensor's largest |g|, ``tests/test_torch_train.py``'s) carried through
AdamW's first step, which moves an element by lr g / (|g| + eps), so an
element whose gradient is near eps = 1e-6 moves by what the rounding of
that gradient decides.
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
from colxlip_tpu.losses import colclip_loss as jax_colclip_loss
from colxlip_tpu.parallel import pod_shape as jax_pod
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu.training import optim as jax_optim
from colxlip_tpu.training import schedules as jax_schedules
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.models import ColXLIP
from colxlip_tpu_torch.parallel import pod_shape
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.training import optim, schedules

WORLD = 8
B = 2
SCALE = 30.0
ALPHA = 0.6
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
TINY = "ViT-S-16-test-colxlip"
BANKS = ("all_image", "all_text", "tok_image_blocks", "tok_text_blocks")


@pytest.fixture(scope="module")
def feats():
    """The global batch of ``tests/test_pod_shape.py``'s fixture (seed 0)."""
    rng = np.random.default_rng(0)

    def l2n(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    n = WORLD * B
    i = l2n(rng.standard_normal((n, 16)).astype(np.float32))
    t = l2n(rng.standard_normal((n, 16)).astype(np.float32))
    ti = l2n(rng.standard_normal((n, 5, 16)).astype(np.float32))
    tt = l2n(rng.standard_normal((n, 7, 16)).astype(np.float32))
    for row, e in enumerate(rng.integers(2, 7, size=n)):
        tt[row, e:] = 0.0
    return tuple(x.astype(np.float32) for x in (i, t, ti, tt))


def _rank_inputs(feats, rank, k):
    """(local features, true collective banks) of one rank."""
    i, t, ti, tt = feats
    sl = slice(rank * B, (rank + 1) * B)

    def block(x, r):
        r %= WORLD
        return x[r * B:(r + 1) * B]

    banks = {"all_image": i, "all_text": t,
             "tok_image_blocks": np.stack([block(ti, rank - s) for s in range(k)]),
             "tok_text_blocks": np.stack([block(tt, rank + s) for s in range(k)])}
    return (i[sl], t[sl], ti[sl], tt[sl]), banks


def _jax_loss_and_grads(local, banks, rank, window_mode):
    def loss(local, banks):
        return jax_pod.pod_shape_loss(
            *local, jnp.float32(SCALE), alpha=ALPHA, maxsim_impl="xla",
            label_offset=rank * B, window_mode=window_mode, output_dict=False, **banks)

    args = (tuple(jnp.asarray(x) for x in local), {k: jnp.asarray(v) for k, v in banks.items()})
    value, (g_local, g_banks) = jax.value_and_grad(loss, argnums=(0, 1))(*args)
    return float(value), [np.asarray(g) for g in g_local] + [np.asarray(g_banks[k])
                                                             for k in BANKS]


def _port_loss_and_grads(local, banks, rank, window_mode):
    local = [torch.tensor(x, requires_grad=True) for x in local]
    banks = {k: torch.tensor(v, requires_grad=True) for k, v in banks.items()}
    out = pod_shape.pod_shape_loss(
        *local, torch.tensor(SCALE), alpha=ALPHA, label_offset=rank * B,
        window_mode=window_mode, **banks)
    out["total_loss"].backward()
    return ({k: float(v.detach()) for k, v in out.items()},
            [x.grad.numpy() for x in local] + [banks[k].grad.numpy() for k in BANKS])


@pytest.fixture(scope="module")
def mesh_loss(feats):
    """neighborhood -> the JAX 8-device local-loss + ring loss (pmean)."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    cache = {}

    def get(neighborhood):
        def per_device(i_, t_, ti_, tt_):
            out = jax_colclip_loss(
                i_, t_, ti_, tt_, jnp.float32(SCALE), alpha=ALPHA, axis_name="data",
                local_loss=True, gather_with_grad=True, maxsim_impl="xla",
                token_dist="ring", token_neighborhood=neighborhood)
            return jax.lax.pmean(out["total_loss"], "data")

        if neighborhood not in cache:
            cache[neighborhood] = float(jax.jit(shard_map(
                per_device, mesh=mesh, in_specs=(P("data"),) * 4, out_specs=P()))(
                    *(jnp.asarray(x) for x in feats)))
        return cache[neighborhood]
    return get


@pytest.mark.parametrize("window_mode", ["scan", "fused"])
@pytest.mark.parametrize("neighborhood", [2, 0])
def test_pod_shape_loss_and_grads_match_jax(feats, neighborhood, window_mode):
    """Each rank's loss and the gradients for its local features and its
    four banks, against the JAX pod_shape_loss on the same inputs."""
    k = neighborhood or WORLD
    for rank in (0, 3, WORLD - 1):
        local, banks = _rank_inputs(feats, rank, k)
        want_loss, want_grads = _jax_loss_and_grads(local, banks, rank, window_mode)
        got, got_grads = _port_loss_and_grads(local, banks, rank, window_mode)
        np.testing.assert_allclose(got["total_loss"], want_loss, rtol=LOSS_RTOL)
        for name, g, w in zip(("i", "t", "ti", "tt", *BANKS), got_grads, want_grads):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max(),
                                       err_msg=f"rank {rank} d{name}")


@pytest.mark.parametrize("window_mode", ["scan", "fused"])
@pytest.mark.parametrize("neighborhood", [2, 0])
def test_rank_mean_matches_the_jax_mesh_loss(feats, mesh_loss, neighborhood, window_mode):
    """The mean over ranks of the port's loss on the true banks is the JAX
    8-device local-loss + ring mesh loss (capped at 2, and the full ring)."""
    want = mesh_loss(neighborhood)
    k = neighborhood or WORLD
    per_rank = []
    for rank in range(WORLD):
        local, banks = _rank_inputs(feats, rank, k)
        with torch.no_grad():
            out = pod_shape.pod_shape_loss(
                *(torch.from_numpy(x) for x in local), torch.tensor(SCALE), alpha=ALPHA,
                label_offset=rank * B, window_mode=window_mode,
                **{name: torch.from_numpy(v) for name, v in banks.items()})
        per_rank.append(float(out["total_loss"]))
    np.testing.assert_allclose(np.mean(per_rank), want, rtol=LOSS_RTOL)


def test_banks_are_the_jax_rolls_and_detach_without_gather_with_grad(feats):
    i, t, ti, tt = (x[:B] for x in feats)
    names = ("image_features", "text_features", "token_image_features",
             "token_text_features")
    want = jax_pod.make_pod_banks({n: jnp.asarray(x) for n, x in zip(names, (i, t, ti, tt))},
                                  neighborhood=3, pod_devices=WORLD)
    local = {n: torch.tensor(x, requires_grad=True) for n, x in zip(names, (i, t, ti, tt))}
    got = pod_shape.make_pod_banks(local, neighborhood=3, pod_devices=WORLD)
    for name in BANKS:
        np.testing.assert_array_equal(got[name].detach().numpy(), np.asarray(want[name]))
    assert got["all_text"].shape == (WORLD * B, 16)
    assert got["tok_image_blocks"].shape == (3, B, 5, 16)
    assert got["tok_text_blocks"].shape == (3, B, 7, 16)
    full = pod_shape.make_pod_banks(local, neighborhood=0, pod_devices=4)
    assert full["tok_image_blocks"].shape[0] == 4

    def bank_grad(gather_with_grad):
        """d(loss)/d(token image features) through the banks alone (the
        local query side detached)."""
        x = torch.tensor(ti, requires_grad=True)
        banks = pod_shape.make_pod_banks(dict(local, token_image_features=x), neighborhood=3,
                                         pod_devices=WORLD, gather_with_grad=gather_with_grad)
        assert all(b.requires_grad == gather_with_grad for b in banks.values())
        loss = pod_shape.pod_shape_loss(
            *(local[n].detach() for n in names[:2]), x.detach(),
            local["token_text_features"].detach(), torch.tensor(SCALE), output_dict=False,
            **banks)
        if gather_with_grad:
            loss.backward()
        return x.grad

    assert float(bank_grad(True).abs().sum()) > 0.0
    assert bank_grad(False) is None


def test_blockwise_rows_modes_agree_and_refuse_an_unknown_mode(feats):
    local, banks = _rank_inputs(feats, 2, 4)
    tt, blocks = torch.from_numpy(local[3]), torch.from_numpy(banks["tok_image_blocks"])
    scan = pod_shape._blockwise_rows(tt, blocks, transpose=False, maxsim_impl="auto",
                                     mask_mode="nonzero", window_mode="scan")
    fused = pod_shape._blockwise_rows(tt, blocks, transpose=False, maxsim_impl="auto",
                                      mask_mode="nonzero", window_mode="fused")
    assert scan.shape == (B, 4 * B) and scan.dtype == torch.float32
    torch.testing.assert_close(scan, fused, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="window_mode"):
        pod_shape._blockwise_rows(tt, blocks, transpose=False, maxsim_impl="auto",
                                  mask_mode="nonzero", window_mode="ring")


@pytest.fixture(scope="module")
def jax_model():
    model, _ = jax_create_model(TINY, precision="fp32")
    imgs = jnp.zeros((1, 64, 64, 3), jnp.float32)
    txts = jnp.zeros((1, 32), jnp.int32).at[:, 0].set(49406).at[:, 1].set(49407)
    params = jax.jit(model.init)(jax.random.PRNGKey(5), imgs, txts)
    return model, jax.tree.map(np.asarray, params)


def _batch(b=4, seed=1):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, 64, 64, 3)).astype(np.float32)
    txts = np.zeros((b, 32), np.int32)
    txts[:, 0] = 49406
    txts[:, 1:8] = rng.integers(1, 49000, (b, 7))
    for r in range(b):
        txts[r, 5 + r] = 49407
        txts[r, 6 + r:] = 0
    return imgs, txts


def _adam_tol(param: torch.Tensor, lr: float, rel: float, eps: float = 1e-6) -> np.ndarray:
    """Per-element bound on the difference of two first AdamW steps whose
    gradients differ by at most ``rel`` of the tensor's largest |g|: the
    update lr g / (|g| + eps) has slope lr eps / (|g| + eps)^2 in g; plus
    four fp32 ulps of the larger of the parameter and the step for the
    update's own rounding, and a millionth of the step (optax's bias
    correction takes 1 - beta2 ** t in fp32, 9.5e-7 off at t = 1)."""
    g = param.grad.detach().abs().numpy().astype(np.float64)
    ulps = 4 * np.spacing(np.maximum(np.abs(param.detach().numpy()), np.float32(lr)))
    return lr * rel * g.max() * eps / (g + eps) ** 2 + ulps + 1e-6 * lr


def _port_model(params) -> ColXLIP:
    model = ColXLIP(factory.model_config(TINY), dtype=torch.float32)
    sd = convert.state_dict_from_jax_params(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.train()


POD_CFG = dict(loss_type="colclip", alpha=0.7, token_neighborhood=2, gather_with_grad=True)


def test_pod_shape_step_matches_jax(jax_model, monkeypatch):
    """One step at M = 4, K = 2 with AdamW (cosine schedule, weight decay
    0.1): the losses, grad_norm and every updated parameter."""
    monkeypatch.setenv("COLXLIP_GELU_IMPL", "stock")
    model, params = jax_model
    imgs, txts = _batch()
    sched = (1e-3, 2, 10)
    tx = jax_optim.create_optimizer(jax_schedules.cosine_lr(*sched), weight_decay=0.1)
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    jstep = jax_pod.make_pod_shape_step(
        model, tx, jax_ts.TrainStepConfig(maxsim_impl="xla", **POD_CFG), pod_devices=4,
        donate=False)
    new_state, want = jstep(state, jnp.asarray(imgs), jnp.asarray(txts))
    want_params = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, new_state.params))

    port = _port_model(params)
    opt = optim.create_optimizer(port, schedules.cosine_lr(*sched), weight_decay=0.1)
    step = pod_shape.make_pod_shape_step(port, opt, schedules.cosine_lr(*sched),
                                         TrainStepConfig(**POD_CFG), pod_devices=4)
    got = step(torch.from_numpy(imgs), torch.from_numpy(txts))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    lr = schedules.cosine_lr(*sched)(0)
    for name, p in port.named_parameters():
        err = np.abs(p.detach().numpy().astype(np.float64) - want_params[name])
        assert (err <= _adam_tol(p, lr, 1e-4)).all(), (name, err.max())


def test_pod_shape_step_window_modes_agree_and_reduce_to_the_one_device_step(jax_model):
    """'scan' and 'fused' are one function (losses 1e-6, parameters within
    ``_adam_tol`` of gradients 1e-6 apart); with M = 1, K = 1 and the banks'
    gradients kept, the pod step is the one-device colclip step."""
    _, params = jax_model
    imgs, txts = (torch.from_numpy(x) for x in _batch(seed=2))
    results = []
    for mode in ("scan", "fused"):
        model = _port_model(params)
        opt = optim.create_optimizer(model, 1e-3, weight_decay=0.1)
        step = pod_shape.make_pod_shape_step(model, opt, None, TrainStepConfig(**POD_CFG),
                                             pod_devices=4, window_mode=mode)
        results.append((step(imgs, txts), dict(model.named_parameters())))
    (m_scan, p_scan), (m_fused, p_fused) = results
    for k in m_scan:
        np.testing.assert_allclose(float(m_fused[k]), float(m_scan[k]), rtol=1e-6, err_msg=k)
    for name, p in p_scan.items():
        err = (p_fused[name] - p).detach().abs().numpy()
        assert (err <= _adam_tol(p, 1e-3, 1e-6)).all(), (name, err.max())

    one = [_port_model(params) for _ in range(2)]
    cfg = TrainStepConfig(loss_type="colclip", alpha=0.7, gather_with_grad=True)
    pod = pod_shape.make_pod_shape_step(one[0], optim.create_optimizer(one[0], 1e-3), None,
                                        cfg, pod_devices=1)
    ref = make_train_step(one[1], optim.create_optimizer(one[1], 1e-3), None, cfg)
    got, want = pod(imgs, txts), ref(imgs, txts)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="colclip"):
        pod_shape.make_pod_shape_step(one[0], optim.create_optimizer(one[0], 1e-3), None,
                                      TrainStepConfig(loss_type="clip"), pod_devices=4)
