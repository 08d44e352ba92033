"""The port's partition rules (``colxlip_tpu_torch/parallel/gspmd.py``
``partition_params``) against the JAX ``partition_params``, in process and
without ranks: on the ``ViT-S-16-test-colxlip`` JAX tree and the JAX meshes
of ``tests/test_gspmd.py`` (``create_mesh`` over the conftest's virtual
devices), with and without FSDP, every leaf's layout must be the same.

Each JAX leaf becomes an array that holds, for every element, the data and
model shard that element lies in (a sentinel where an axis of more than one
device replicates it); ``convert.state_dict_from_jax_params`` carries those
arrays to the port's names and layouts (transposed kernels, ``conv1``
reordered), where they must equal the same arrays built from the port's
placements. Sharding over an axis of size one is the whole tensor, as the
JAX replication there is. The scalars stay whole, and
``validate_gspmd_config`` refuses what the JAX function refuses, in its
words.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from colxlip_tpu.factory import create_model as jax_create_model
from colxlip_tpu.parallel import gspmd as jax_gspmd
from colxlip_tpu.parallel import train_step as jax_ts
from colxlip_tpu.parallel.mesh import create_mesh
from colxlip_tpu_torch import convert, factory
from colxlip_tpu_torch.parallel import gspmd
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig

TINY = "ViT-S-16-test-colxlip"
# (devices, model_parallel) as in tests/test_gspmd.py
MESHES = [(8, 4), (8, 1), (4, 2), (2, 2)]


@pytest.fixture(scope="module")
def shapes():
    """The JAX tree's leaf shapes and the port's parameter shapes."""
    model, _ = jax_create_model(TINY, precision="fp32")
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3), jnp.float32), jnp.zeros((1, 32), jnp.int32))
    port, _ = factory.create_model(TINY, "cpu", seed=0)
    return tree, {n: tuple(p.shape) for n, p in port.named_parameters()}


def _code(shard, size):
    """An element's shard on one axis: its index, -1 where an axis of more
    than one device replicates it (an axis of one holds everything at 0)."""
    return shard if shard is not None else (-1 if size > 1 else 0)


def _jax_codes(leaf_shape, spec, sizes):
    """[leaf shape] int array: (data code + 1) * 8 + model code + 1."""
    entries = list(spec) + [None] * (len(leaf_shape) - len(spec))
    idx = np.indices(leaf_shape) if leaf_shape else np.zeros((0,), int)
    codes = []
    for axis in ("data", "model"):
        size = sizes.get(axis, 1)
        dims = [i for i, e in enumerate(entries) if e == axis]
        if dims:
            block = leaf_shape[dims[0]] // size
            codes.append(idx[dims[0]] // block)
        else:
            codes.append(np.full(leaf_shape, _code(None, size), int))
    return (codes[0] + 1) * 8 + codes[1] + 1


def _port_codes(shape, placements, sizes):
    idx = np.indices(shape) if shape else np.zeros((0,), int)
    codes = []
    for axis, pl in zip(("data", "model"), list(placements) + [Replicate()]):
        size = sizes.get(axis, 1)
        if isinstance(pl, Shard):
            codes.append(idx[pl.dim] // (shape[pl.dim] // size))
        else:
            codes.append(np.full(shape, _code(None, size), int))
    return (codes[0] + 1) * 8 + codes[1] + 1


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("devices,p", MESHES, ids=[f"{n}x{p}" for n, p in MESHES])
def test_partition_params_equals_jax_leaf_for_leaf(shapes, devices, p, fsdp):
    tree, port_shapes = shapes
    mesh = create_mesh(devices, model_parallel=p)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    specs = jax_gspmd.partition_params(tree, mesh, fsdp=fsdp)
    coded = jax.tree.map(lambda leaf, spec: _jax_codes(tuple(leaf.shape), spec, sizes),
                         tree, specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = convert.state_dict_from_jax_params(coded)
    got = gspmd.partition_params(port_shapes, sizes, fsdp=fsdp)
    assert set(got) == set(want) == set(port_shapes)
    for name, shape in port_shapes.items():
        assert len(got[name]) == len(sizes), name
        np.testing.assert_array_equal(_port_codes(shape, got[name], sizes),
                                      np.asarray(want[name]).astype(int), err_msg=name)


def test_partition_rules_by_name(shapes):
    """tests/test_gspmd.py's readings on the port's names: column- and
    row-parallel kernels, FSDP on the free largest dim, the scalars whole."""
    _, port_shapes = shapes
    blk = "visual.transformer.resblocks.0."
    tp = gspmd.partition_params(port_shapes, {"data": 2, "model": 4})
    assert tp[blk + "attn.in_proj_weight"] == (Replicate(), Shard(0))
    assert tp[blk + "attn.out_proj.weight"] == (Replicate(), Shard(1))
    assert tp[blk + "mlp.c_fc.weight"] == (Replicate(), Shard(0))
    assert tp[blk + "mlp.c_proj.weight"] == (Replicate(), Shard(1))
    assert tp[blk + "mlp.c_fc.bias"] == (Replicate(), Replicate())
    fsdp = gspmd.partition_params(port_shapes, {"data": 2, "model": 4}, fsdp=True)
    assert fsdp[blk + "mlp.c_fc.bias"] == (Shard(0), Replicate())
    assert fsdp[blk + "attn.out_proj.weight"] == (Shard(0), Shard(1))
    dp = gspmd.partition_params(port_shapes, {"data": 8}, fsdp=True)
    assert dp[blk + "mlp.c_fc.weight"] == (Shard(0),)        # [512, 128]: the 512
    # conv1 [128, 3, 16, 16] is the JAX [768, 128] kernel: its 768 rows shard
    # as the patch rows
    assert dp["visual.conv1.weight"] == (Shard(2),)
    # the 17-row position embedding shards its 128 columns
    assert dp["visual.positional_embedding"] == (Shard(1),)
    for table in (tp, fsdp, dp):
        assert all(isinstance(pl, Replicate) for pl in table["logit_scale"])
    assert gspmd.jax_view("visual.conv1.weight", (128, 3, 16, 16)) == ((768, 128), (2, 0))


CONFIGS = {
    "local_loss": dict(local_loss=True, gather_with_grad=True),
    "ring": dict(token_dist="ring", gather_with_grad=True),
    "accum_freq": dict(accum_freq=2, gather_with_grad=True),
    "no_gather_with_grad": dict(),
    "all_four": dict(local_loss=True, token_dist="ring", accum_freq=2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_validate_gspmd_config_refuses_as_jax(name):
    kw = CONFIGS[name]
    with pytest.raises(ValueError) as want:
        jax_gspmd.validate_gspmd_config(dataclasses.replace(jax_ts.TrainStepConfig(), **kw))
    with pytest.raises(ValueError) as got:
        gspmd.validate_gspmd_config(dataclasses.replace(TrainStepConfig(), **kw))
    assert str(got.value) == str(want.value)
    gspmd.validate_gspmd_config(TrainStepConfig(gather_with_grad=True))
