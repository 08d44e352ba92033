"""The port's collectives and distributed losses against the JAX package at
4 ranks: ``parallel/collectives.py`` (the gather with and without grad and
under local loss, the ring shift), ``clip_loss`` (full and local, with and
without ``gather_with_grad``, dense and fused) and ``colclip_loss`` (full
mode, local loss with the token gather, the token ring, its neighbourhood
cap, the 'valid' mask, the ring without ``gather_with_grad``).

The port runs as 4 gloo ranks (``tests/torch_dist_worker.py``, spawned once
for the file); the JAX side runs in this process through ``shard_map`` over
4 of the virtual CPU devices of ``tests/conftest.py``, with the same
``check_vma=False`` as its train step. The inputs are the same seeded numpy
arrays, fp32. Each rank's value and its local features' gradients (the
gradient of its own loss copy, through the collectives' backward) are held
against the JAX device of the same index: losses within 1e-5 relative,
gradients within 1e-5 of their largest magnitude.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from colxlip_tpu.losses import clip_loss as jax_clip_loss
from colxlip_tpu.losses import colclip_loss as jax_colclip_loss
from colxlip_tpu.parallel import collectives as jax_collectives

import torch_dist_worker as worker

W, B, D, LT, LI = 4, 3, 16, 7, 5
N = W * B
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(15)
    token_text = _unit(rng.standard_normal((N, LT, D)))
    eot = rng.integers(2, LT, N)
    live = np.arange(LT)[None, :] < eot[:, None]
    token_text *= live[:, :, None]              # text tokens at and after EOT are zero
    text_mask = (rng.random((N, LT)) > 0.3) & live
    text_mask[:, 0] = True
    return {
        "image": _unit(rng.standard_normal((N, D))),
        "text": _unit(rng.standard_normal((N, D))),
        "token_image": _unit(rng.standard_normal((N, LI, D))),
        "token_text": token_text.astype(np.float32),
        "text_mask": text_mask.astype(np.float32),
        "cot_gather": rng.standard_normal((W, N, D)).astype(np.float32),
        "cot_shift": rng.standard_normal((W, B, D)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the 4 ranks' results): the ranks are spawned once here."""
    work = tmp_path_factory.mktemp("dist_losses")
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    return inputs, worker.spawn_ranks("losses", W, str(work / "inputs.npz"), str(work))


def _sharded(fn, n_in, n_out):
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("data"),) * n_in,
                             out_specs=(P("data"),) * n_out, check_vma=False))


def _jax_case(kind, kw, inputs):
    """(values [W, ...], grads: list of [W, ...]) from the JAX functions,
    device by device."""
    kw = dict(kw)
    if kind in ("gather", "shift"):
        def f(v):
            if kind == "gather":
                return jax_collectives.gather_features(v, axis_name="data", **kw)
            return jax_collectives.ring_shift(v, "data", kw["shift"])

        def per(x, cot):
            y, vjp = jax.vjp(f, x)
            return y[None], vjp(cot[0])[0]
        y, g = _sharded(per, 2, 2)(inputs["image"], inputs[f"cot_{kind}"])
        return np.asarray(y), [np.asarray(g).reshape(W, B, D)]

    scale = jnp.float32(worker.LOSS_SCALE)
    names = ("image", "text") if kind == "clip" else (
        "image", "text", "token_image", "token_text")

    def per(mask, *feats):
        def loss(*f):
            if kind == "clip":
                return jax_clip_loss(*f, scale, axis_name="data", **kw)
            return jax_colclip_loss(*f, scale, alpha=worker.LOSS_ALPHA, axis_name="data",
                                    maxsim_impl="xla", text_mask=mask, **kw)["total_loss"]
        value, grads = jax.value_and_grad(loss, argnums=tuple(range(len(feats))))(*feats)
        return (value[None], *grads)
    out = _sharded(per, 1 + len(names), 1 + len(names))(
        inputs["text_mask"], *(inputs[k] for k in names))
    return np.asarray(out[0]), [np.asarray(g).reshape(W, B, *g.shape[1:]) for g in out[1:]]


@pytest.mark.parametrize("case", worker.loss_cases("losses"))
def test_port_rank_matches_jax_device(runs, case):
    inputs, ranks = runs
    kind, kw = worker.LOSS_CASES[case]
    want_value, want_grads = _jax_case(kind, kw, inputs)
    for r, got in enumerate(ranks):
        value = got[f"{case}/value"]
        if kind in ("gather", "shift"):
            np.testing.assert_array_equal(value, want_value[r], err_msg=f"{case} rank {r}")
        else:
            np.testing.assert_allclose(value, want_value[r], rtol=LOSS_RTOL,
                                       err_msg=f"{case} rank {r}")
        for i, want in enumerate(want_grads):
            tol = GRAD_REL * max(np.abs(want).max(), 1e-12)
            np.testing.assert_allclose(got[f"{case}/grad{i}"], want[r], rtol=0, atol=tol,
                                       err_msg=f"{case} rank {r} grad {i}")


def test_full_mode_is_one_loss_on_every_rank_and_local_loss_is_not(runs):
    """Full mode computes the identical global loss on every rank; local
    loss gives each rank its own rows' loss, whose mean is the full loss."""
    _, ranks = runs
    full = [float(r["clip_full/value"]) for r in ranks]
    local = [float(r["clip_local/value"]) for r in ranks]
    assert len(set(full)) == 1
    assert len(set(local)) == W
    np.testing.assert_allclose(np.mean(local), full[0], rtol=1e-5)


def test_gather_with_grad_gives_the_global_batch_gradient(runs):
    """With gather_with_grad each rank's feature gradient is the gradient of
    the one global loss times the number of ranks (every rank's copy
    contributes, as the JAX all_gather VJP sums): held against the loss
    over all rows on one device."""
    inputs, ranks = runs
    img = jnp.asarray(inputs["image"])
    txt = jnp.asarray(inputs["text"])
    g_img, g_txt = jax.grad(lambda a, b: jax_clip_loss(a, b, jnp.float32(worker.LOSS_SCALE)),
                            argnums=(0, 1))(img, txt)
    got_img = np.concatenate([r["clip_full_gather_with_grad/grad0"] for r in ranks])
    got_txt = np.concatenate([r["clip_full_gather_with_grad/grad1"] for r in ranks])
    for got, want in ((got_img, g_img), (got_txt, g_txt)):
        want = W * np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * np.abs(want).max())


ONE_DEVICE_FLAGS = {
    "clip_local_loss": ("clip", dict(local_loss=True)),
    "clip_fused_local_loss": ("clip", dict(local_loss=True, ce_impl="fused")),
    "colclip_local_loss": ("colclip", dict(local_loss=True)),
    "colclip_ring": ("colclip", dict(token_dist="ring")),
    "colclip_local_ring_cap2": ("colclip", dict(local_loss=True, token_dist="ring",
                                                token_neighborhood=2, mask_mode="valid")),
}


@pytest.mark.parametrize("case", list(ONE_DEVICE_FLAGS))
def test_one_device_local_loss_and_ring_are_the_single_device_loss(case):
    """At axis_name=None local_loss and token_dist='ring' (and its cap) take
    the single-device branch, as the JAX functions do: values and gradients
    equal the JAX single-device ones."""
    import torch

    from colxlip_tpu_torch.losses import clip_loss, colclip_loss

    kind, kw = ONE_DEVICE_FLAGS[case]
    inputs = _inputs()
    names = ("image", "text") if kind == "clip" else ("image", "text", "token_image",
                                                      "token_text")
    scale = worker.LOSS_SCALE

    def jax_loss(*f):
        if kind == "clip":
            return jax_clip_loss(*f, jnp.float32(scale), **kw)
        return jax_colclip_loss(*f, jnp.float32(scale), alpha=worker.LOSS_ALPHA,
                                maxsim_impl="xla", text_mask=jnp.asarray(inputs["text_mask"]),
                                **kw)["total_loss"]
    want, want_g = jax.value_and_grad(jax_loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(inputs[k]) for k in names))
    feats = [torch.from_numpy(inputs[k]).requires_grad_(True) for k in names]
    if kind == "clip":
        got = clip_loss(*feats, torch.tensor(scale), **kw)
    else:
        got = colclip_loss(*feats, torch.tensor(scale), alpha=worker.LOSS_ALPHA,
                           text_mask=torch.from_numpy(inputs["text_mask"]),
                           **kw)["total_loss"]
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for f, w in zip(feats, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(f.grad.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max())


def test_token_neighborhood_without_the_ring_raises_as_jax():
    import torch

    from colxlip_tpu_torch.losses import colclip_loss

    inputs = _inputs()
    names = ("image", "text", "token_image", "token_text")
    with pytest.raises(ValueError) as jax_err:
        jax_colclip_loss(*(jnp.asarray(inputs[k]) for k in names), jnp.float32(10.0),
                         token_neighborhood=2)
    with pytest.raises(ValueError) as err:
        colclip_loss(*(torch.from_numpy(inputs[k]) for k in names), torch.tensor(10.0),
                     token_neighborhood=2)
    assert str(err.value) == str(jax_err.value)


def test_the_data_axis_needs_a_group_and_the_model_axis_is_refused():
    """Without a process group the 'data' axis raises and every helper reads
    one rank; create_mesh needs a group for either mesh, and the 'model'
    axis is no axis name of the loss collectives (its group comes from the
    mesh, parallel/gspmd.py)."""
    from colxlip_tpu_torch.parallel import mesh

    assert mesh.resolve_group(None) is None and mesh.data_group() is None
    assert (mesh.rank(), mesh.world()) == (0, 1)
    assert mesh.broadcast_str("name") == "name"
    assert mesh.initialize_multihost(None, 1, 0, backend="gloo") is False
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.create_mesh()
    with pytest.raises(ValueError, match="unknown axis"):
        mesh.resolve_group("model")
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.create_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="--dist-coordinator"):
        mesh.initialize_multihost(None, 2, 0, backend="gloo")
