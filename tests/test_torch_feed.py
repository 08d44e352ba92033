"""The port's feeds against the JAX package: the packed buffer
(``parallel/data_feed.py``), the planar YUV420 codec (``ops/yuv420.py``) and
the train step on a packed buffer.

Tolerances: the packed buffer, its unpacking, the numpy codec and the
packed step against the separate step are exact; ``decode_yuv420`` (fp32,
the upsample and the 3 x 3 affine in another order of operations) is held
to 1e-5 of the JAX decode and to the JAX bar of 2e-4 of the numpy
reference (tests/test_yuv420.py).
"""
from __future__ import annotations

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.ops import yuv420 as jax_yuv420
from colxlip_tpu.parallel import data_feed as jax_feed
from colxlip_tpu_torch import factory
from colxlip_tpu_torch.data.transforms import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from colxlip_tpu_torch.ops import yuv420
from colxlip_tpu_torch.parallel import data_feed
from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
from colxlip_tpu_torch.training import optim

TINY = "ViT-S-16-test-colxlip"


def _batch(b=4, hw=(12, 16), ctx=32, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    texts = rng.integers(0, 49408, (b, ctx)).astype(np.int32)
    return images, texts


def _smooth_rgb(rng, h, w, n=1):
    coarse = rng.integers(0, 256, (n, h // 4, w // 4, 3)).astype(np.float32)
    up = coarse.repeat(4, axis=1).repeat(4, axis=2)
    return np.clip(up + rng.normal(0, 6, up.shape), 0, 255).astype(np.uint8)


def test_pack_batch_is_bit_equal_to_jax():
    images, texts = _batch()
    got = data_feed.pack_batch(images, texts)
    np.testing.assert_array_equal(got, jax_feed.pack_batch(images, texts))
    assert got.dtype == np.uint8 and got.shape == (4, 12 * 16 * 3 + 2 * 32)
    yuv = yuv420.rgb_to_yuv420(images)
    np.testing.assert_array_equal(data_feed.pack_batch(yuv, texts),
                                  jax_feed.pack_batch(yuv, texts))
    with pytest.raises(ValueError, match="uint8"):
        data_feed.pack_batch(images.astype(np.float32), texts)
    with pytest.raises(ValueError, match="uint16"):
        data_feed.pack_batch(images, texts + (1 << 16))
    with pytest.raises(ValueError, match="batch"):
        data_feed.pack_batch(images, texts[:3])


@pytest.mark.parametrize("yuv", [False, True], ids=["rgb", "yuv420"])
def test_unpack_batch_inverts_pack_as_jax_does(yuv):
    images, texts = _batch(seed=1)
    texts[0, :3] = (0, 255, 49407)
    if yuv:
        images = yuv420.rgb_to_yuv420(images)
    img_shape = images.shape[1:]
    buf = data_feed.pack_batch(images, texts)
    got_i, got_t = data_feed.unpack_batch(torch.from_numpy(buf), img_shape, 32)
    want_i, want_t = jax_feed.unpack_batch(jnp.asarray(buf), img_shape, 32)
    assert got_i.dtype == torch.uint8 and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_i.numpy(), images)
    np.testing.assert_array_equal(got_t.numpy(), texts)


def test_device_feeder_on_the_cpu():
    images, texts = _batch()
    buf, none = data_feed.DeviceFeeder("cpu", packed=True)(images, texts)
    assert none is None and buf.dtype == torch.uint8
    np.testing.assert_array_equal(buf.numpy(), data_feed.pack_batch(images, texts))
    got_i, got_t = data_feed.DeviceFeeder("cpu")(images, texts)
    np.testing.assert_array_equal(got_i.numpy(), images)
    np.testing.assert_array_equal(got_t.numpy(), texts)


def test_yuv420_numpy_codec_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    rgb = _smooth_rgb(rng, 32, 48, n=2)
    got = yuv420.rgb_to_yuv420(rgb)
    np.testing.assert_array_equal(got, jax_yuv420.rgb_to_yuv420(rgb))
    np.testing.assert_array_equal(yuv420.rgb_to_yuv420(rgb[0]), got[0])   # 3-D input
    np.testing.assert_array_equal(yuv420.yuv420_to_rgb(got), jax_yuv420.yuv420_to_rgb(got))
    for a, b in zip(yuv420.split_planes(got, 32, 48), jax_yuv420.split_planes(got, 32, 48)):
        np.testing.assert_array_equal(a, b)
    back = np.clip(yuv420.yuv420_to_rgb(got), 0, 255)
    assert yuv420.psnr(rgb, back) == jax_yuv420.psnr(rgb, back)
    assert yuv420.yuv420_rows(224) == 336
    with pytest.raises(ValueError, match="even"):
        yuv420.rgb_to_yuv420(rgb[:, :31])

    class Ship:
        ship = "yuv420"

    np.testing.assert_array_equal(yuv420.apply_ship_format(Ship(), rgb), got)
    np.testing.assert_array_equal(yuv420.apply_ship_format(Ship(), rgb, native=True), got)
    assert yuv420.apply_ship_format(Ship(), rgb.astype(np.float32)).dtype == np.float32


def test_decode_yuv420_matches_jax_and_the_numpy_reference():
    rng = np.random.default_rng(1)
    yuv = yuv420.rgb_to_yuv420(_smooth_rgb(rng, 32, 48, n=2))
    got = yuv420.decode_yuv420(torch.from_numpy(yuv), OPENAI_DATASET_MEAN, OPENAI_DATASET_STD)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 32, 48, 3)
    want = np.asarray(jax_yuv420.decode_yuv420(jnp.asarray(yuv), OPENAI_DATASET_MEAN,
                                               OPENAI_DATASET_STD))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ref = (yuv420.yuv420_to_rgb(yuv) / 255.0 - np.asarray(OPENAI_DATASET_MEAN, np.float32)) \
        / np.asarray(OPENAI_DATASET_STD, np.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-4)
    with pytest.raises(ValueError, match="planar"):
        yuv420.decode_yuv420(torch.zeros(2, 34, 48, dtype=torch.uint8), OPENAI_DATASET_MEAN,
                             OPENAI_DATASET_STD)


@pytest.fixture
def one_intra_op_thread():
    """The test workers share the CPU: one intra-op thread a process keeps
    the tiny steps from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("wire", ["uint8", "yuv420"])
def test_packed_step_equals_the_separate_step(wire, one_intra_op_thread):
    """The JAX test_packed_feed bar: step(buf, None) gives the metrics and
    the parameters of step(images, texts), bit for bit, over two steps."""
    model, cfg = factory.create_model(TINY, "cpu", torch.float32, seed=0)
    model.train()
    size = cfg.vision_cfg.image_size
    ctx = cfg.text_cfg.context_length
    rng = np.random.default_rng(2)
    images = _smooth_rgb(rng, size, size, n=4)
    if wire == "yuv420":
        images = yuv420.rgb_to_yuv420(images)
    texts = np.zeros((4, ctx), np.int32)
    texts[:, 0] = 49406
    texts[:, 1:6] = rng.integers(1, 49000, (4, 5))
    texts[np.arange(4), 6 + np.arange(4)] = 49407

    def build(m, packed_feed=None):
        opt = optim.create_optimizer(m, 1e-3, weight_decay=0.1)
        return make_train_step(m, opt, None, TrainStepConfig(), packed_feed=packed_feed)

    other = copy.deepcopy(model)
    separate, packed = build(model), build(other, (images.shape[1:], ctx))
    buf = torch.from_numpy(data_feed.pack_batch(images, texts))
    for _ in range(2):
        want = separate(torch.from_numpy(images), torch.from_numpy(texts))
        got = packed(buf, None)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for (name, p), q in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(p, q), name
    with pytest.raises(ValueError, match="buf, None"):
        packed(buf, torch.from_numpy(texts))
