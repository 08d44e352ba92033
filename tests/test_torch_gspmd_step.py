"""The port's sharded step (``colxlip_tpu_torch/parallel/gspmd.py``) at 4
gloo ranks against the JAX package: one colclip step of the tiny
``ViT-S-16-test-colxlip`` (4 heads in each tower, so P = 2 and P = 4 both
split ``in_proj`` across heads) from one JAX init (``convert``) on one
seeded global batch of 8, each data index feeding its rows
(``tests/torch_dist_worker.py`` suite ``gspmd``, spawned once):

- the cases of ``GSPMD_CASES``: FSDP at data 4, TP at 2 x 2, FSDP + TP at
  2 x 2, TP at 1 x 4, and FSDP + TP at 2 x 2 with ``COLXLIP_LN_IMPL=fused
  COLXLIP_MLP_IMPL=fused`` (their plain versions on the CPU; the MLP's
  row-parallel bias is added once, after the sum), each against the JAX
  one-device ``make_train_step`` on the global batch, and the 2 x 2 FSDP +
  TP case also against the JAX ``make_train_step_gspmd(fsdp=True)`` on
  ``create_mesh(4, model_parallel=2)``: metrics within 1e-5 relative, the
  parameters after the step within ``rtol=2e-4, atol=2e-6`` (the bars of
  ``tests/test_torch_dist_step.py``); the tensor-parallel cases and the
  token embedding within the JAX gspmd test's ``rtol=3e-3, atol=3e-5``
  (one or two elements of a tensor sit near AdamW's eps, where the order of
  the sums over the axes decides their first step);
- every moment's placements are its parameter's, the updated parameters
  keep them, a local shard has the JAX shard's shape, and every gradient
  replicated over 'model' is bit-equal across the model group; the clip
  over sharded gradients scales them by the global norm's factor;
- for the 2 x 2 FSDP + TP state: a sharded save restored into a fresh
  sharded state is bit-equal; a whole ``state.pt`` written here restores
  into the sharded layout unchanged; this process reads the ranks' sharded
  save whole (``load_native_checkpoint``) and finds the JAX layout
  (``in_proj_weight`` unpermuted);
- the save contracts of ``tests/test_sharded_ckpt.py`` on a 4-rank data
  mesh: the round trip into a template of other values, the mid-epoch
  sidecar, the background save whose rotation waits for it.

The JAX side runs with ``COLXLIP_GELU_IMPL=stock`` (exact erf, as the port).
"""
from __future__ import annotations

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.parallel import gspmd as jax_gspmd
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu.parallel.mesh import create_mesh
from colxlip_tpu.training import optim as jax_optim
from colxlip_tpu.training import schedules as jax_schedules
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.training import checkpoint as ck
from colxlip_tpu_torch.training import optim, schedules

import torch_dist_worker as worker

W, B, CTX = 4, 8, 32
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-6
METRIC_RTOL = 1e-5
# the token embedding: a few elements of the rows the batch uses move by what
# the rounding of a gradient near AdamW's eps decides (its first step moves an
# element by lr g / (|g| + 1e-6)); the sums over the data and model axes come
# in another order than the one-device step's. Held to the JAX gspmd test's
# own bars (tests/test_gspmd.py: rtol=3e-3, atol=3e-5)
LOOSE = {"token_embedding.weight": (3e-3, 3e-5)}


# a tensor-parallel case sums each row-parallel product over the model group
# in another order too: held to the JAX gspmd test's bars, as that test holds
# the JAX tensor-parallel step against its one-device step
TP_RTOL, TP_ATOL = 3e-3, 3e-5


def _param_tol(name, case):
    if worker.GSPMD_CASES[case][0] > 1:
        return dict(rtol=TP_RTOL, atol=TP_ATOL)
    rtol, atol = LOOSE.get(name, (PARAM_RTOL, PARAM_ATOL))
    return dict(rtol=rtol, atol=atol)


def _texts(rng, n, ctx):
    texts = np.zeros((n, ctx), np.int32)
    texts[:, 0] = 49406
    lengths = rng.integers(3, ctx - 1, n)
    for i, length in enumerate(lengths):
        texts[i, 1:length] = rng.integers(1, 49000, length - 1)
        texts[i, length] = 49407
    return texts


def _jax_step(model, params, inputs, mesh=None):
    cfg = jax_ts.TrainStepConfig(loss_type="colclip", maxsim_impl="xla",
                                 gather_with_grad=True)
    tx = jax_optim.create_optimizer(jax_schedules.cosine_lr(*worker.STEP_LR),
                                    weight_decay=worker.STEP_WD)
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    images, texts = jnp.asarray(inputs["images"]), jnp.asarray(inputs["texts"])
    if mesh is None:
        return jax_ts.make_train_step(model, tx, cfg, donate=False)(state, images, texts), None
    sharded, _ = jax_gspmd.shard_state(state, mesh, fsdp=True)
    step = jax_gspmd.make_train_step_gspmd(model, tx, cfg, mesh, donate=False, fsdp=True)
    return step(sharded, images, texts), sharded


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX steps, the whole state.pt and the 4 ranks' results."""
    mp = pytest.MonkeyPatch()
    mp.setenv("COLXLIP_GELU_IMPL", "stock")
    model, _ = jax_create_model(worker.TINY, precision="fp32")
    rng = np.random.default_rng(31)
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    inputs = {"images": images, "texts": _texts(rng, B, CTX)}
    params = jax.jit(model.init)(jax.random.PRNGKey(11), jnp.asarray(images[:1]),
                                 jnp.asarray(inputs["texts"][:1]))
    params = jax.tree.map(np.asarray, params)
    sd = convert.state_dict_from_jax_params(params)

    # a whole checkpoint of a one-process port step, for the sharded restore
    work = tmp_path_factory.mktemp("gspmd")
    port, _ = factory.create_model(worker.TINY, "cpu", torch.float32, seed=3)
    port.train()
    sched = schedules.cosine_lr(*worker.STEP_LR)
    opt = optim.create_optimizer(port, sched, weight_decay=worker.STEP_WD)
    step = make_train_step(port, opt, sched, TrainStepConfig(loss_type="colclip"))
    step(torch.from_numpy(images), torch.from_numpy(inputs["texts"]))
    whole = ck.save_checkpoint(str(work / "whole"), ck.train_state(port, opt, step.step),
                               epoch=7, name="whole")
    np.savez(work / "inputs.npz", **inputs, whole_path=np.array(whole),
             **{f"param/{k}": v for k, v in sd.items()})
    os.makedirs(work / "ranks")
    # the ranks run while this process compiles and runs the two JAX steps
    ranks = []
    spawn = threading.Thread(target=lambda: ranks.append(worker.spawn_ranks(
        "gspmd", W, str(work / "inputs.npz"), str(work / "ranks"))))
    spawn.start()
    try:
        one, _ = _jax_step(model, params, inputs)
        (gspmd_state, gspmd_metrics), sharded = _jax_step(
            model, params, inputs, create_mesh(W, model_parallel=2))
    finally:
        spawn.join()
    assert ranks, "the gspmd ranks failed (their logs are in the exception above)"
    ranks = ranks[0]
    yield {"one": one, "gspmd": (gspmd_state, gspmd_metrics), "sharded": sharded,
           "ranks": ranks, "whole": whole, "work": work,
           "optimizer_names": ck.optimizer_param_names(port, opt)}
    mp.undo()


def _want(state):
    return convert.state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))


@pytest.mark.parametrize("case", list(worker.GSPMD_CASES))
def test_sharded_step_matches_the_jax_one_device_step(setup, case):
    new_state, metrics = setup["one"]
    want = _want(new_state)
    ranks = setup["ranks"]
    for r, got in enumerate(ranks):
        for k, v in metrics.items():
            np.testing.assert_allclose(got[f"{case}/metric/{k}"], float(v), rtol=METRIC_RTOL,
                                       err_msg=f"{case} rank {r} {k}")
    got = ranks[0]                  # the whole parameters reach rank 0
    names = {k[len(f"{case}/param/"):] for k in got if k.startswith(f"{case}/param/")}
    assert names == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[f"{case}/param/{k}"], w, **_param_tol(k, case),
                                   err_msg=f"{case} {k}")


def test_fsdp_tp_step_matches_the_jax_gspmd_step(setup):
    new_state, metrics = setup["gspmd"]
    want = _want(new_state)
    got = setup["ranks"][0]
    for k, v in metrics.items():
        np.testing.assert_allclose(got[f"fsdp_tp_2x2/metric/{k}"], float(v), rtol=METRIC_RTOL,
                                   err_msg=k)
    for k, w in want.items():
        np.testing.assert_allclose(got[f"fsdp_tp_2x2/param/{k}"], w,
                                   **_param_tol(k, "fsdp_tp_2x2"),
                                   err_msg=k)


@pytest.mark.parametrize("case", list(worker.GSPMD_CASES))
def test_placements_moments_and_replicated_gradients(setup, case):
    p, fsdp, _ = worker.GSPMD_CASES[case]
    ranks = setup["ranks"]
    names = [k[len(f"{case}/placements/"):] for k in ranks[0]
             if k.startswith(f"{case}/placements/")]
    assert names
    for got in ranks:
        for k in names:
            assert bool(got[f"{case}/moments_follow/{k}"]), (case, k)
    # c_fc [512, 128] is the JAX kernel [128, 512]: 'model' takes its 512
    # columns, FSDP the largest free dim ('data' on 512 alone, on 128 beside
    # 'model'); the updated state keeps both
    c_fc = "visual.transformer.resblocks.0.mlp.c_fc.weight"
    placements = str(ranks[0][f"{case}/placements/{c_fc}"])
    want = {(1, True): "(Shard(dim=0),)", (2, True): "(Shard(dim=1), Shard(dim=0))",
            (2, False): "(Replicate(), Shard(dim=0))", (4, False): "(Replicate(), Shard(dim=0))"}
    assert placements == want[p, fsdp]
    data = W // p
    assert tuple(ranks[0][f"{case}/local_shape/{c_fc}"]) == (
        (512 // data, 128) if p == 1 else (512 // p, 128 // (data if fsdp else 1)))
    # a gradient replicated over 'model' is the same on every rank of a model group
    if p > 1:
        grads = [k for k in ranks[0] if k.startswith(f"{case}/grad/")]
        assert grads
        for d in range(W // p):
            group = ranks[d * p:(d + 1) * p]
            for k in grads:
                for other in group[1:]:
                    np.testing.assert_array_equal(other[k], group[0][k], err_msg=k)


def test_grad_norm_and_the_clip_see_the_global_gradient(setup):
    """grad_norm of the sharded step is the JAX step's (the norm of the
    global gradient, each shard counted once), and the clip at half that
    norm halves every whole gradient on every rank."""
    _, metrics = setup["one"]
    for got in setup["ranks"]:
        np.testing.assert_allclose(got["fsdp_tp_2x2/metric/grad_norm"],
                                   float(metrics["grad_norm"]), rtol=METRIC_RTOL)
        np.testing.assert_allclose(got["clip/norm"], got["fsdp_tp_2x2/metric/grad_norm"],
                                   rtol=METRIC_RTOL)
        assert got["clip/max_rel_err"] <= 1e-6


def test_local_shards_have_the_jax_shard_shapes(setup):
    """A rank's shard of the 2 x 2 FSDP + TP state is the JAX shard,
    transposed as the weight is."""
    sharded = setup["sharded"].params["params"]
    block = sharded["visual"]["transformer"]["resblocks_0"]
    got = setup["ranks"][0]
    prefix = "fsdp_tp_2x2/local_shape/visual.transformer.resblocks.0."
    for port, leaf in (("attn.in_proj_weight", block["attn"]["in_proj"]["kernel"]),
                       ("attn.out_proj.weight", block["attn"]["out_proj"]["kernel"]),
                       ("mlp.c_fc.weight", block["mlp"]["c_fc"]["kernel"]),
                       ("mlp.c_proj.weight", block["mlp"]["c_proj"]["kernel"])):
        jax_shard = leaf.addressable_shards[0].data.shape
        assert tuple(got[prefix + port]) == tuple(reversed(jax_shard)), port


def test_sharded_and_whole_saves_read_each_other(setup):
    ranks = setup["ranks"]
    for got in ranks:
        assert bool(got["restore/bit_equal"])
        assert int(got["restore/step"]) == 1 and int(got["restore/epoch"]) == 1
    # the whole state.pt, restored into the sharded layout and gathered back
    whole = ck.load_native_checkpoint(setup["whole"])["state"]
    assert int(ranks[0]["whole/step"]) == whole["step"] == 1
    for k, v in whole["state_dict"].items():
        np.testing.assert_array_equal(ranks[0][f"whole/param/{k}"], v.numpy(), err_msg=k)
    by_name = ck.optimizer_state_by_name(whole["optimizer"], setup["optimizer_names"])
    assert len(by_name["state"]) == len(whole["state_dict"])
    for k, v in by_name["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(ranks[0][f"whole/{key}/{k}"], v[key].numpy(),
                                          err_msg=f"{key} {k}")
    # the ranks' sharded save read whole in this process: the true layout
    saved = ck.load_native_checkpoint(str(setup["work"] / "ranks" / "ckpt" / "epoch_1"))
    assert saved["epoch"] == 1 and saved["name"] == "gspmd" and saved["state"]["step"] == 1
    for k, v in saved["state"]["state_dict"].items():
        np.testing.assert_array_equal(v.numpy(), ranks[0][f"fsdp_tp_2x2/param/{k}"], err_msg=k)
    osd = saved["state"]["optimizer"]
    assert sorted(osd["state"]) == list(range(len(saved["state"]["state_dict"])))


def test_save_contracts_of_the_jax_sharded_checkpoint(setup):
    for got in setup["ranks"]:
        assert str(got["contract/path"]).endswith("epoch_2")
        assert int(got["contract/epoch"]) == 2 and str(got["contract/name"]) == "t"
        assert int(got["contract/step"]) == 3
        np.testing.assert_array_equal(got["contract/w"],
                                      np.arange(32, dtype=np.float32).reshape(8, 4))
        assert got["contract/w_local"].shape == (2, 4)
        assert float(got["contract/scale"]) == 7.0 and bool(got["contract/same_layout"])
        assert str(got["contract/sidecar_path"]).endswith("epoch_latest")
        assert int(got["contract/sidecar"]) == 5
        assert bool(got["contract/kept_before_finish"])
        assert bool(got["contract/rotated_after_finish"])
        np.testing.assert_array_equal(got["contract/background_w"],
                                      np.arange(32, dtype=np.float32).reshape(8, 4) + 1.0)
