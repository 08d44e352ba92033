"""The port's data-parallel train step at 2 ranks against the JAX
``make_train_step(mesh=create_mesh(2))``: one colclip step of the tiny
``ViT-S-16-test-colxlip`` from the same weights (JAX init ->
``convert.state_dict_from_jax_params``) on the same seeded global batch,
each rank feeding its own rows.

Cases (``tests/torch_dist_worker.py`` ``STEP_CASES``): full mode with and
without ``gather_with_grad``, ``accum_freq=2`` (the cached-negative splice
gathers inside the loss), and the recipe flags composed: local loss, the
token ring capped at 2 ranks and texts of 16 tokens fed to the 32-token
model (``--text-ctx``). The ranks (gloo) are spawned once for the file;
rank 1 starts from other weights, which the step's broadcast from rank 0
replaces. The JAX side runs with ``COLXLIP_GELU_IMPL=stock`` (exact erf, as
the port). Parameters after the step agree within the JAX mesh test's
``rtol=2e-4, atol=2e-6`` (``tests/test_train_step.py``), the metrics within
1e-5 relative, and the two ranks hold the same parameters bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu.parallel.mesh import create_mesh
from colxlip_tpu.training import optim as jax_optim
from colxlip_tpu.training import schedules as jax_schedules
from colxlip_tpu_torch import convert

import torch_dist_worker as worker

W, B, CTX = 2, 4, 32
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-6
METRIC_RTOL = 1e-5


def _texts(rng, n, ctx):
    texts = np.zeros((n, ctx), np.int32)
    texts[:, 0] = 49406
    lengths = rng.integers(3, ctx - 1, n)
    for i, length in enumerate(lengths):
        texts[i, 1:length] = rng.integers(1, 49000, length - 1)
        texts[i, length] = 49407
    return texts


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX model and weights, the inputs and the 2 ranks' results."""
    mp = pytest.MonkeyPatch()
    mp.setenv("COLXLIP_GELU_IMPL", "stock")
    model, _ = jax_create_model(worker.TINY, precision="fp32")
    rng = np.random.default_rng(21)
    images = rng.standard_normal((W * B, 64, 64, 3)).astype(np.float32)
    inputs = {"images": images, "texts": _texts(rng, W * B, CTX),
              "texts_ctx16": _texts(rng, W * B, 16)}
    params = jax.jit(model.init)(jax.random.PRNGKey(7), jnp.asarray(images[:1]),
                                 jnp.asarray(inputs["texts"][:1]))
    params = jax.tree.map(np.asarray, params)
    sd = convert.state_dict_from_jax_params(params)
    work = tmp_path_factory.mktemp("dist_step")
    np.savez(work / "inputs.npz", **inputs, **{f"param/{k}": v for k, v in sd.items()})
    ranks = worker.spawn_ranks("step", W, str(work / "inputs.npz"), str(work))
    yield model, params, inputs, ranks
    mp.undo()


@pytest.mark.parametrize("case", list(worker.STEP_CASES))
def test_port_step_matches_the_jax_mesh_step(setup, case):
    model, params, inputs, ranks = setup
    kw = dict(worker.STEP_CASES[case])
    ctx = kw.pop("text_ctx", None)
    texts = inputs["texts"] if ctx is None else inputs[f"texts_ctx{ctx}"]
    cfg = dataclasses.replace(jax_ts.TrainStepConfig(loss_type="colclip", maxsim_impl="xla"),
                              **kw)
    tx = jax_optim.create_optimizer(jax_schedules.cosine_lr(*worker.STEP_LR),
                                    weight_decay=worker.STEP_WD)
    mesh = create_mesh(W)
    state = jax_ts.replicate_state(
        jax_ts.TrainState(jnp.zeros((), jnp.int32), params, tx.init(params)), mesh)
    step = jax_ts.make_train_step(model, tx, cfg, mesh=mesh, donate=False)
    new_state, metrics = step(state, jnp.asarray(inputs["images"]), jnp.asarray(texts))
    want = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, new_state.params))

    for r, got in enumerate(ranks):
        for k, v in metrics.items():
            np.testing.assert_allclose(got[f"{case}/metric/{k}"], float(v), rtol=METRIC_RTOL,
                                       err_msg=f"{case} rank {r} {k}")
        names = {k[len(f"{case}/param/"):] for k in got if k.startswith(f"{case}/param/")}
        assert names == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[f"{case}/param/{k}"], w, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=f"{case} rank {r} {k}")
    for k in names:
        np.testing.assert_array_equal(ranks[0][f"{case}/param/{k}"],
                                      ranks[1][f"{case}/param/{k}"], err_msg=k)
