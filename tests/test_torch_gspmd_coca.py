"""Tensor parallelism for CoCa, the attentional pooler and the int8 MLP
(``colxlip_tpu_torch/parallel/gspmd.py``, ``parallel/tensor_parallel.py``)
against the JAX package, at 4 gloo ranks (data 2 x model 2, FSDP too) and
at 2 (1 x 2), each spawned once (``tests/torch_dist_worker.py`` suite
``gspmd_coca``) while this process runs the JAX side:

- one coca step of ``coca-S-test`` (2 heads in every attention, so P = 2
  splits the vision and decoder self-attention, the CoCa text tower's masked
  blocks, the decoder's cross-attention with its packed ``in_proj`` and
  both attentional poolers' separate ``q_proj`` / ``k_proj`` / ``v_proj``)
  from one JAX init (``convert``) on one seeded global batch of 8, against
  the JAX one-device coca step on that batch: metrics within 1e-5
  relative, every gradient within cosine 0.9999 and 1e-3 of its norm (a
  gradient under 1e-4 of the step's largest norm has no direction to
  compare, as ``chip_smoke.compare_step`` holds it: by its difference);
- the sharded save of the state after that step, read whole here, equals
  the ranks' whole parameters and goes back through the JAX importer
  (``convert_openclip_state_dict``) into the JAX tree's layout;
- ``main --model coca-S-test --model-parallel 2`` at 2 ranks trains the
  global batch with the losses of one process (1e-5);
- ``partition_params`` on the CoCa tree against the JAX ``partition_params``
  leaf for leaf; the one leaf the port packs, the cross-attention's
  ``in_proj`` (three JAX kernels), is sharded as the self-attention's packed
  ``in_proj`` is, by whole rows, and regrouped to heads when it runs;
- ``COLXLIP_MLP_INT8=fwd``: an ``MLP`` at P = 2 equals the same module at
  P = 1 bit for bit in the forward (the scales are the model group's maxima
  and the int32 sums are added before the one rescale) and within fp32
  rounding in the straight-through gradients, while the split that
  quantizes each shard with its own scales differs; one colclip step of
  ``ViT-S-16-test-colxlip`` under the plan against the port's one-device
  int8 step.

The JAX side runs with ``COLXLIP_GELU_IMPL=stock`` (exact erf, as the port).
"""
from __future__ import annotations

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.parallel import gspmd as jax_gspmd
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu.parallel.mesh import create_mesh as jax_create_mesh
from colxlip_tpu.training.checkpoint import convert_openclip_state_dict
from colxlip_tpu_torch import main as main_mod
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.parallel import gspmd
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.training import checkpoint as ck
from colxlip_tpu_torch.training import optim, schedules

import torch_dist_worker as worker

B, CTX = 8, 32
METRIC_RTOL = 1e-5
GRAD_COS, GRAD_NORM = 0.9999, 1e-3
VANISHING = 1e-4
# the int8 step under the plan against the one-device int8 step: the
# attention's row-parallel sums come in another order, and an element that
# lands on the other side of an int8 rounding moves the next MLP by a step
INT8_STEP_RTOL = 1e-4
WORLDS = (4, 2)


def _coca_texts(rng, n):
    """SOT, content, EOT at a row's own place, pads after it, and one pad
    inside the content of row 1 (the CLS mask's case)."""
    texts = np.zeros((n, CTX), np.int32)
    texts[:, 0] = 49406
    for i in range(n):
        end = 6 + 3 * i % (CTX - 8)
        texts[i, 1:end] = rng.integers(1, 49000, end - 1)
        texts[i, end] = 49407
    texts[1, 3] = 0
    return texts


def _texts(rng, n):
    texts = np.zeros((n, CTX), np.int32)
    texts[:, 0] = 49406
    for i, length in enumerate(rng.integers(3, CTX - 1, n)):
        texts[i, 1:length] = rng.integers(1, 49000, length - 1)
        texts[i, length] = 49407
    return texts


def _recorder():
    """An optax transformation whose state becomes the gradients it is fed."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _jax_coca_step(model, params, images, texts):
    """(metrics, gradients in the port's layout) of the JAX one-device step."""
    tx = _recorder()
    state = jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
    step = jax_ts.make_train_step(model, tx, jax_ts.TrainStepConfig(loss_type="coca"),
                                  donate=False)
    new_state, metrics = step(state, jnp.asarray(images), jnp.asarray(texts))
    grads = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, new_state.opt_state))
    return {k: float(v) for k, v in metrics.items()}, grads


def _main_argv(logs, name, *extra):
    """coca-S-test through main: 2 steps on 16 synthetic samples, batch 8
    (global: the ranks of one data index read the same rows)."""
    return ["--device", "cpu", "--model", worker.COCA, "--dataset-type", "synthetic",
            "--train-num-samples", "16", "--batch-size", "8", "--epochs", "1", "--lr", "1e-4",
            "--warmup", "2", "--lr-scheduler", "const", "--gather-with-grad", "--precision",
            "fp32", "--logs", str(logs), "--name", name, "--workers", "0",
            "--log-every-n-steps", "1", "--seed", "0", "--save-frequency", "0", *extra]


def _int8_one_device_step(state, images, texts):
    """The port's one-device colclip step of the tiny model built under
    ``COLXLIP_MLP_INT8=fwd``."""
    model = worker._with_env({"COLXLIP_MLP_INT8": "fwd"}, lambda: worker._gspmd_model(state,
                                                                                     False))
    schedule = schedules.cosine_lr(*worker.STEP_LR)
    opt = optim.create_optimizer(model, schedule, weight_decay=worker.STEP_WD)
    step = make_train_step(model, opt, schedule,
                           TrainStepConfig(loss_type="colclip", gather_with_grad=True))
    return {k: float(v) for k, v in step(torch.from_numpy(images),
                                         torch.from_numpy(texts)).items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX step, the port's one-device int8 step and both rank groups'
    results."""
    mp = pytest.MonkeyPatch()
    mp.setenv("COLXLIP_GELU_IMPL", "stock")
    rng = np.random.default_rng(41)
    images = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    coca_texts, texts = _coca_texts(rng, B), _texts(rng, B)
    jmodel, _ = jax_create_model(worker.COCA, precision="fp32")
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(7), jnp.asarray(images[:1]), jnp.asarray(coca_texts[:1])))
    tiny, _ = jax_create_model(worker.TINY, precision="fp32")
    tiny_params = jax.tree.map(np.asarray, jax.jit(tiny.init)(
        jax.random.PRNGKey(11), jnp.asarray(images[:1]), jnp.asarray(texts[:1])))
    tiny_sd = convert.state_dict_from_jax_params(tiny_params)
    work = tmp_path_factory.mktemp("gspmd_coca")
    np.savez(work / "inputs.npz", images=images, coca_texts=coca_texts, texts=texts,
             **{f"param/{k}": v for k, v in convert.state_dict_from_jax_params(params).items()},
             **{f"tiny/{k}": v for k, v in tiny_sd.items()})
    ranks = {}

    def spawn(world):
        out = work / f"w{world}"
        os.makedirs(out)
        ranks[world] = worker.spawn_ranks("gspmd_coca", world, str(work / "inputs.npz"),
                                          str(out))

    def main_ranks():
        os.makedirs(work / "main")
        ranks["main"] = worker.spawn_ranks("main", 2, "-", str(work / "main"), _main_argv(
            work / "logs", "mp", "--model-parallel", "2"))

    threads = [threading.Thread(target=spawn, args=(w,)) for w in WORLDS]
    threads.append(threading.Thread(target=main_ranks))
    for t in threads:
        t.start()
    try:
        want = _jax_coca_step(jmodel, params, images, coca_texts)
        int8_want = _int8_one_device_step({k: torch.from_numpy(v) for k, v in tiny_sd.items()},
                                          images, texts)
        assert main_mod.main(_main_argv(work / "logs", "one")) == 0
    finally:
        for t in threads:
            t.join()
        mp.undo()
    for w in (*WORLDS, "main"):
        assert w in ranks, f"the {w} ranks failed (see the log above)"
    return {"want": want, "int8_want": int8_want, "ranks": ranks, "jax_params": params,
            "logs": work / "logs"}


@pytest.mark.parametrize("world", WORLDS)
def test_coca_tp_step_matches_jax_one_device(setup, world):
    want_m, want_g = setup["want"]
    for r, res in enumerate(setup["ranks"][world]):
        got_m = {k[len("coca/metric/"):]: float(v) for k, v in res.items()
                 if k.startswith("coca/metric/")}
        assert set(got_m) == set(want_m)
        for k, v in want_m.items():
            np.testing.assert_allclose(got_m[k], v, rtol=METRIC_RTOL, err_msg=f"rank {r} {k}")
        got_g = {k[len("coca/grad/"):]: v for k, v in res.items() if k.startswith("coca/grad/")}
        assert set(got_g) == set(want_g)
        largest = max(np.linalg.norm(w) for w in want_g.values())
        for k, w in want_g.items():
            g = got_g[k].astype(np.float64)
            w = np.asarray(w, np.float64)
            nw, ng = np.linalg.norm(w), np.linalg.norm(g)
            if nw < VANISHING * largest:
                assert np.linalg.norm(g - w) <= VANISHING * largest, (r, k)
                continue
            assert (g * w).sum() / (nw * ng) >= GRAD_COS, (r, k)
            assert abs(ng - nw) <= GRAD_NORM * nw, (r, k)


@pytest.mark.parametrize("world", WORLDS)
def test_coca_tp_places_the_cross_attention_and_poolers(setup, world):
    res = setup["ranks"][world][0]
    placements = {k[len("coca/placements/"):]: str(v) for k, v in res.items()
                  if k.startswith("coca/placements/")}
    model_dim = {"in_proj_weight": 0, "q_proj.weight": 0, "k_proj.weight": 0,
                 "v_proj.weight": 0, "out_proj.weight": 1}
    for name, pl in placements.items():
        for suffix, dim in model_dim.items():
            if (name.startswith(("text_decoder.cross_attn.", "attn_pool.", "visual.attn_pool."))
                    and name.endswith(suffix)):
                assert pl.endswith(f"Shard(dim={dim}))"), (name, pl)


@pytest.mark.parametrize("world", WORLDS)
def test_coca_sharded_save_reads_back_whole(setup, world):
    res = setup["ranks"][world][0]
    whole = ck.load_native_checkpoint(str(res["coca/save"]))
    assert whole["epoch"] == 1 and whole["name"] == "coca" and whole["state"]["step"] == 1
    sd = whole["state"]["state_dict"]
    params = {k[len("coca/param/"):]: v for k, v in res.items() if k.startswith("coca/param/")}
    assert set(sd) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # the JAX layout: the packed in_proj splits back into the three kernels
    back = convert_openclip_state_dict({k: v.numpy() for k, v in sd.items()})["params"]
    for name in ("text", "text_decoder", "to_logits"):
        want = jax.tree_util.tree_leaves_with_path(setup["jax_params"]["params"][name])
        got = dict(jax.tree_util.tree_leaves_with_path(back[name]))
        assert len(got) == len(want), name
        for path, w in want:
            assert got[path].shape == w.shape, (name, path)
    d = params["text_decoder.cross_attn.0.attn.in_proj_weight"].shape[1]
    np.testing.assert_array_equal(
        back["text_decoder"]["cross_attn_0"]["attn"]["k_proj"]["kernel"],
        params["text_decoder.cross_attn.0.attn.in_proj_weight"][d:2 * d].T)


def test_main_model_parallel_trains_coca_with_the_one_process_losses(setup):
    import json

    assert [int(r["rc"]) for r in setup["ranks"]["main"]] == [0, 0]
    metrics = {}
    for name in ("one", "mp"):
        with open(setup["logs"] / name / "metrics.jsonl") as f:
            metrics[name] = [json.loads(line) for line in f]
    assert [m["step"] for m in metrics["mp"]] == [m["step"] for m in metrics["one"]] == [1, 2]
    for a, b in zip(metrics["one"], metrics["mp"]):
        for k in ("total_loss", "contrastive_loss", "caption_loss", "logit_scale"):
            np.testing.assert_allclose(b[k], a[k], rtol=METRIC_RTOL, err_msg=f"{k} {a['step']}")


def _codes(shape, placements, sizes):
    """Every element's (data, model) shard as (d + 1) * 8 + m + 1 (0 for an
    axis of one or a replicated one)."""
    from torch.distributed.tensor import Shard

    idx = np.indices(shape)
    total = np.ones(shape, int) * 9
    for weight, axis, pl in zip((8, 1), ("data", "model"), placements):
        if isinstance(pl, Shard):
            total += weight * (idx[pl.dim] // (shape[pl.dim] // sizes[axis]))
    return total


def _jax_codes(shape, spec, sizes):
    entries = list(spec) + [None] * (len(shape) - len(spec))
    idx = np.indices(shape)
    total = np.ones(shape, int) * 9
    for weight, axis in ((8, "data"), (1, "model")):
        if axis in entries:
            dim = entries.index(axis)
            total += weight * (idx[dim] // (shape[dim] // sizes[axis]))
    return total


@pytest.mark.parametrize("devices,p,fsdp", [(4, 2, False), (4, 2, True), (2, 2, False)])
def test_partition_params_equals_jax_for_coca(setup, devices, p, fsdp):
    model, _ = jax_create_model(worker.COCA, precision="fp32")
    tree = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), setup["jax_params"])
    mesh = jax_create_mesh(devices, model_parallel=p)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    specs = jax_gspmd.partition_params(tree, mesh, fsdp=fsdp)
    coded = jax.tree.map(lambda leaf, spec: _jax_codes(tuple(leaf.shape), spec, sizes),
                         tree, specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = convert.state_dict_from_jax_params(coded)
    port, _ = factory.create_model(worker.COCA, "cpu", torch.float32)
    shapes = {n: tuple(q.shape) for n, q in port.named_parameters()}
    got = gspmd.partition_params(shapes, sizes, fsdp=fsdp)
    assert set(got) == set(want) == set(shapes)
    for name, shape in shapes.items():
        codes = _codes(shape, got[name], sizes)
        jax_codes = np.asarray(want[name]).astype(int)
        if name.startswith("text_decoder.cross_attn.") and ".attn.in_proj_" in name:
            # three JAX leaves (kernels [D, D] split by columns, biases),
            # packed by rows: the port splits the packed leaf as the
            # self-attention's packed leaf of that shape, holding as many
            # elements a shard as the JAX layout
            assert np.array_equal(np.sort(codes, axis=None), np.sort(jax_codes, axis=None))
            leaf = name.rsplit(".", 1)[-1]
            assert got[name] == gspmd.partition_params(
                {f"transformer.resblocks.0.attn.{leaf}": shape}, sizes,
                fsdp=fsdp)[f"transformer.resblocks.0.attn.{leaf}"], name
            continue
        np.testing.assert_array_equal(codes, jax_codes, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_int8_mlp_at_p2_equals_p1_in_the_forward(setup, world):
    for r, res in enumerate(setup["ranks"][world]):
        lo, hi = res["int8/rows"]
        # the forward bit for bit; the per-shard-scale split is not
        np.testing.assert_array_equal(res["int8/p2/y"], res["int8/p1/y"], err_msg=f"rank {r}")
        assert np.abs(res["int8/naive/y"] - res["int8/p1/y"]).max() > 1e-3
        tol = dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["int8/p2/dx"], res["int8/p1/dx"], **tol)
        np.testing.assert_allclose(res["int8/p2/c_fc.weight.grad"],
                                   res["int8/p1/c_fc.weight.grad"][lo:hi], **tol)
        np.testing.assert_allclose(res["int8/p2/c_proj.weight.grad"],
                                   res["int8/p1/c_proj.weight.grad"][:, lo:hi], **tol)
        np.testing.assert_allclose(res["int8/p2/c_proj.bias.grad"],
                                   res["int8/p1/c_proj.bias.grad"], **tol)


@pytest.mark.parametrize("world", WORLDS)
def test_int8_step_under_the_plan_matches_one_device(setup, world):
    want = setup["int8_want"]
    for r, res in enumerate(setup["ranks"][world]):
        got = {k[len("int8_step/metric/"):]: float(v) for k, v in res.items()
               if k.startswith("int8_step/metric/")}
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=INT8_STEP_RTOL, err_msg=f"rank {r} {k}")
