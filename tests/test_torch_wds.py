"""The port's tar-shard pipeline (``data/wds.py``, ``data/transforms.py``,
``data/pack.py``) against the JAX package on the same seeded shards
(``data/shard_writer.py``: 64-96 px JPEGs, the recaption JSON layout).

Everything here is exact: shard lists, samples, dataset sizes, the
equal-batch rounding and rollover, the train and eval transforms, packed
records, and whole pipelines batch for batch over two epochs. The pipelines
run with one worker: with more, the bounded queue interleaves the workers'
samples in thread order.
"""
from __future__ import annotations

import io
import json
import os
import random
import tarfile
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from colxlip_tpu.data import pack as jax_pack
from colxlip_tpu.data import transforms as jax_transforms
from colxlip_tpu.data import wds as jax_wds
from colxlip_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from colxlip_tpu_torch.data import pack, shard_writer, transforms, wds
from colxlip_tpu_torch.data.tokenizer import SimpleTokenizer
from colxlip_tpu_torch.training.train import train_one_epoch

SIZE = 32


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("wds")
    kw = dict(short_side=64, long_side=(64, 96), quality=90, workers=3)
    shard_writer.write_shards(str(root / "json"), 3, 8, seed=0, **kw)
    shard_writer.write_shards(str(root / "txt"), 2, 8, seed=1, **kw)
    for name in ("0000.tar", "0001.tar"):      # plain-caption shards: .txt for .json
        path = str(root / "txt" / name)
        samples = list(jax_wds.iter_tar_samples(path))
        with tarfile.open(path, "w") as tf:
            for sample in samples:
                key = sample["__key__"].decode()
                _add(tf, f"{key}.jpg", sample["jpg"])
                _add(tf, f"{key}.txt", json.loads(sample["json"])["raw_caption"].encode())
    return root


def _spec(root, kind, n):
    return str(root / kind / ("{0000..%04d}.tar" % (n - 1)))


# ---------------------------------------------------------------------------
# shard lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["a-{0..3}.tar", "x{00..11}y{1..2}.tar", "plain.tar",
                                     "d/{7..9}/s{0..1}.tar", "{0000..0000}.tar"])
def test_braceexpand_matches_jax(pattern):
    assert wds.braceexpand(pattern) == jax_wds.braceexpand(pattern)


@pytest.mark.parametrize("urls,weights", [
    ("a{0..2}.tar::b{0..1}.tar", "1::3"), ("a{0..2}.tar::b{0..1}.tar", None),
    (["p.tar", "q.tar"], [0.5, 2.0]), ("s{0..4}.tar", None)])
def test_expand_urls_matches_jax(urls, weights):
    assert wds.expand_urls(urls, weights) == jax_wds.expand_urls(urls, weights)


def test_expand_urls_refuses_mismatched_weights():
    for mod in (wds, jax_wds):
        with pytest.raises(ValueError, match="weights"):
            mod.expand_urls("a{0..1}.tar::b.tar", "1::2::3")


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_shard_selection_matches_jax(seed, epoch):
    urls = [f"s{i}.tar" for i in range(11)]
    for rank, world in ((0, 1), (1, 2)):
        for worker, workers in ((0, 1), (1, 3), (2, 3)):
            kw = dict(seed=seed, epoch=epoch, rank=rank, world_size=world, worker_id=worker,
                      num_workers=workers)
            assert wds.deterministic_shards(urls, **kw) == jax_wds.deterministic_shards(urls, **kw)
    for weights in (None, [float(i % 3 + 1) for i in range(11)]):
        for worker in (0, 3):
            kw = dict(seed=seed, epoch=epoch, worker_id=worker, num_shards=20)
            assert list(wds.resampled_shards(urls, weights, **kw)) == list(
                jax_wds.resampled_shards(urls, weights, **kw))


def test_shared_epoch():
    e = wds.SharedEpoch(3)
    e.set_value(5)
    assert e.get_value() == 5


# ---------------------------------------------------------------------------
# tar reading, sizes, rounding
# ---------------------------------------------------------------------------

def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def test_iter_tar_samples_matches_jax_on_a_corrupt_shard(tmp_path, shard_dir, caplog):
    """Dotted extensions, a directory member, and a shard cut off inside a
    member: both log and keep what they read before the cut."""
    path = str(tmp_path / "bad.tar")
    with tarfile.open(path, "w") as tf:
        _add(tf, "k1.jpg", b"\xff\xd8x" * 40)
        _add(tf, "k1.meta.tsv", b"a\tb")
        info = tarfile.TarInfo("subdir")
        info.type = tarfile.DIRTYPE
        tf.addfile(info)
        _add(tf, "k2.JPG", b"y" * 3000)
        _add(tf, "k2.txt", b"caption")
        _add(tf, "k3.json", b"{}" * 2000)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3500)
    for p in (path, _spec(shard_dir, "json", 1).replace("{0000..0000}", "0000"),
              str(tmp_path / "missing.tar")):
        assert list(wds.iter_tar_samples(p)) == list(jax_wds.iter_tar_samples(p))
    assert "Ignoring" in caplog.text
    assert wds.split_member_name("a/b.c/key.meta.tsv") == ("a/b.c/key", "meta.tsv")


def test_get_dataset_size_matches_jax(tmp_path, shard_dir):
    shards = wds.expand_urls(_spec(shard_dir, "json", 3))[0]
    assert wds.get_dataset_size(shards) == jax_wds.get_dataset_size(shards) == 24
    d = tmp_path / "len"
    d.mkdir()
    for i in range(3):
        (d / f"{i}.tar").write_bytes(b"")
    (d / "__len__").write_text("42\n")
    full = [str(d / f"{i}.tar") for i in range(3)]
    for case in (full, full[:2], [str(tmp_path / "none" / "0.tar")], []):
        assert wds.get_dataset_size(case) == jax_wds.get_dataset_size(case)
    assert wds.get_dataset_size(full) == 42 and wds.get_dataset_size(full[:2]) is None
    (d / "sizes.json").write_text(json.dumps({"0.tar": 5}))
    assert wds.get_dataset_size(full) is None is jax_wds.get_dataset_size(full)


@pytest.mark.parametrize("n,b,world,workers", [(100, 8, 1, 1), (100, 8, 1, 4), (7, 8, 1, 2),
                                                (3072, 256, 1, 8), (1000, 16, 2, 3)])
def test_round_num_batches_matches_jax(n, b, world, workers):
    assert wds._round_num_batches(n, b, world, workers) == jax_wds._round_num_batches(
        n, b, world, workers)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _images(seed=0):
    rng = np.random.default_rng(seed)
    out = [Image.fromarray(rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8))
           for h, w in rng.integers(20, 90, (4, 2))]
    out.append(Image.fromarray(rng.integers(0, 256, (12, 90, 3), dtype=np.uint8)))  # fallback
    out.append(Image.fromarray(rng.integers(0, 256, (40, 40), dtype=np.uint8)))     # gray
    return out


def test_sample_rrc_box_matches_jax():
    for w, h in ((64, 48), (512, 700), (200, 10), (10, 200), (1, 1)):
        for scale, ratio in (((0.9, 1.0), (3 / 4, 4 / 3)), ((0.08, 1.0), (0.5, 2.0))):
            a, b = random.Random(w * h), random.Random(w * h)
            for _ in range(5):
                assert transforms.sample_rrc_box(w, h, scale, ratio, a) == \
                    jax_transforms.sample_rrc_box(w, h, scale, ratio, b)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("on_device", [False, True], ids=["float32", "uint8"])
def test_image_transform_is_bit_equal_to_jax(is_train, on_device):
    aug = transforms.AugmentationCfg(scale=(0.5, 1.0))
    got_t = transforms.image_transform(SIZE, is_train, aug_cfg=aug,
                                       normalize_on_device=on_device)
    want_t = jax_transforms.image_transform(SIZE, is_train,
                                            aug_cfg=jax_transforms.AugmentationCfg((0.5, 1.0)),
                                            normalize_on_device=on_device)
    for i, img in enumerate(_images()):
        got, want = got_t(img, rng=random.Random(i)), want_t(img, rng=random.Random(i))
        assert got.dtype == want.dtype == (np.uint8 if on_device else np.float32)
        np.testing.assert_array_equal(got, want)
    seeded = transforms.image_transform(SIZE, is_train, seed=3)
    jax_seeded = jax_transforms.image_transform(SIZE, is_train, seed=3)
    for img in _images(1):
        np.testing.assert_array_equal(seeded(img), jax_seeded(img))


@pytest.mark.parametrize("raw_aug", ["rrc", "crop"])
def test_apply_raw_is_bit_equal_to_jax(raw_aug):
    rng = np.random.default_rng(4)
    for on_device in (False, True):
        got_t = transforms.image_transform(SIZE, True, normalize_on_device=on_device,
                                           raw_aug=raw_aug)
        want_t = jax_transforms.image_transform(SIZE, True, normalize_on_device=on_device,
                                                raw_aug=raw_aug)
        for i, (h, w) in enumerate(((40, 48), (32, 32), (20, 50))):
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            np.testing.assert_array_equal(got_t.apply_raw(arr, rng=random.Random(i)),
                                          want_t.apply_raw(arr, rng=random.Random(i)))


def test_augmentation_cfg_from_kwargs_matches_jax():
    got = transforms.AugmentationCfg.from_kwargs({"scale": [0.4, 1.0], "ratio": (0.5, 2.0)})
    want = jax_transforms.AugmentationCfg.from_kwargs({"scale": [0.4, 1.0],
                                                       "ratio": (0.5, 2.0)})
    assert (got.scale, got.ratio) == (want.scale, want.ratio) == ((0.4, 1.0), (0.5, 2.0))
    with pytest.raises(ValueError, match="color_jitter"):
        transforms.AugmentationCfg.from_kwargs({"color_jitter": 0.4})
    with pytest.raises(ValueError, match="raw_aug"):
        transforms.image_transform(SIZE, True, raw_aug="flip")
    with pytest.raises(ValueError, match="ship"):
        transforms.image_transform(SIZE, True, ship="nv12")


# ---------------------------------------------------------------------------
# packed raw records
# ---------------------------------------------------------------------------

def test_raw_records_and_packed_shards_match_jax(tmp_path, shard_dir):
    arr = np.random.default_rng(5).integers(0, 256, (7, 9, 3), dtype=np.uint8)
    record = pack.encode_raw(arr)
    assert record == jax_pack.encode_raw(arr)
    np.testing.assert_array_equal(pack.decode_raw(record), arr)
    for bad in (record[:-1], b"XXXX" + record[4:]):
        with pytest.raises(ValueError):
            pack.decode_raw(bad)
    with pytest.raises(ValueError):
        pack.encode_raw(arr.astype(np.float32))
    spec = _spec(shard_dir, "json", 3)
    got_paths, got_n = pack.pack_shards(spec, str(tmp_path / "port"), size=40, workers=2)
    want_paths, want_n = jax_pack.pack_shards(spec, str(tmp_path / "jax"), size=40)
    assert got_n == want_n == 24
    for g, w in zip(got_paths, want_paths):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()
    assert (tmp_path / "port" / "sizes.json").read_text() == \
        (tmp_path / "jax" / "sizes.json").read_text()
    with pytest.raises(ValueError, match="already"):
        pack.pack_shard(got_paths[0], str(tmp_path / "again.tar"))
    assert pack.main(["--urls", spec, "--out-dir", str(tmp_path / "cli"), "--size", "40"]) == 0


# ---------------------------------------------------------------------------
# whole pipelines
# ---------------------------------------------------------------------------

def _pipelines(spec, *, caption_key="json", resampled=False, on_device=False, native=False,
               raw_aug="rrc", ship="rgb", aug=None, num_samples=None, batch=4):
    kw = dict(urls=spec, batch_size=batch, num_samples=num_samples, resampled=resampled,
              seed=3, num_workers=1, caption_key=caption_key, native_decode=native,
              decode_threads=2)
    t_kw = dict(normalize_on_device=on_device, raw_aug=raw_aug, ship=ship)
    port = wds.WdsTrainPipeline(
        wds.WdsConfig(**kw),
        transforms.image_transform(SIZE, True, aug_cfg=aug and transforms.AugmentationCfg(**aug),
                                   **t_kw),
        SimpleTokenizer(context_length=24))
    jax = jax_wds.WdsTrainPipeline(
        jax_wds.WdsConfig(**kw),
        jax_transforms.image_transform(
            SIZE, True, aug_cfg=aug and jax_transforms.AugmentationCfg(**aug), **t_kw),
        JaxTokenizer(context_length=24))
    return port, jax


def _assert_same_batches(port, jax, epochs=(0, 1)):
    seen = 0
    for epoch in epochs:
        port.set_epoch(epoch)
        jax.set_epoch(epoch)
        got, want = list(port), list(jax)
        assert len(got) == len(want) == port.num_batches
        for (gi, gt), (wi, wt) in zip(got, want):
            assert gi.dtype == wi.dtype and gi.shape == wi.shape
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gt, wt)
            seen += 1
    return seen


CASES = {
    "json": dict(),
    "json-resampled": dict(resampled=True),
    "json-uint8": dict(on_device=True),
    "json-native": dict(native=True),
    "json-native-uint8": dict(native=True, on_device=True),
    "json-yuv420": dict(ship="yuv420"),
    "json-native-yuv420": dict(native=True, ship="yuv420"),
    "json-aug-scale": dict(aug={"scale": (0.3, 1.0)}),
    "txt": dict(caption_key="txt"),
    "txt-resampled-uint8": dict(caption_key="txt", resampled=True, on_device=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_batches_are_bit_equal_to_jax(shard_dir, case):
    kw = CASES[case]
    kind = kw.get("caption_key", "json")
    spec = _spec(shard_dir, kind, 3 if kind == "json" else 2)
    port, jax = _pipelines(spec, **kw)
    assert _assert_same_batches(port, jax) == 2 * port.num_batches > 0
    images, texts = next(iter(port))
    if kw.get("ship") == "yuv420":
        assert images.dtype == np.uint8 and images.shape == (4, SIZE * 3 // 2, SIZE)
    elif kw.get("on_device"):
        assert images.dtype == np.uint8 and images.shape == (4, SIZE, SIZE, 3)
    else:
        assert images.dtype == np.float32 and images.shape == (4, SIZE, SIZE, 3)
    assert texts.shape == (4, 1, 24) and texts.dtype == np.int32


@pytest.mark.parametrize("raw_aug", ["rrc", "crop"])
def test_pipeline_on_packed_shards_is_bit_equal_to_jax(tmp_path, shard_dir, raw_aug):
    pack.pack_shards(_spec(shard_dir, "json", 3), str(tmp_path), size=40)
    port, jax = _pipelines(str(tmp_path / "{0000..0002}.tar"), raw_aug=raw_aug,
                           on_device=raw_aug == "crop")
    assert _assert_same_batches(port, jax) == 12


def test_equal_batch_rollover_matches_jax(shard_dir):
    """--train-num-samples above what the shards hold: the last full batch
    and the partial one repeat until the epoch has its batches."""
    port, jax = _pipelines(_spec(shard_dir, "json", 3), num_samples=60, batch=5)
    assert port.num_batches == 12
    assert _assert_same_batches(port, jax, epochs=(0,)) == 12


def test_an_empty_split_raises_as_jax_does(tmp_path):
    (tmp_path / "empty.tar").write_bytes(b"")
    port, jax = _pipelines(str(tmp_path / "empty.tar"), num_samples=8)
    for p in (port, jax):
        with pytest.raises(RuntimeError, match="yielded no samples"):
            list(p)


def test_epoch_cut_short_stops_its_workers(shard_dir):
    """train_one_epoch leaves an epoch at steps_per_epoch while the loader
    threads still hold samples: closing the pipeline's generator (on the
    prefetch thread that runs it) must stop them before the next epoch, also
    while the caller still holds the iterator (so no refcount closes it)."""
    pipe = wds.WdsTrainPipeline(
        wds.WdsConfig(urls=_spec(shard_dir, "json", 3), batch_size=2, num_workers=3,
                      seed=0, shuffle_buffer=1),
        transforms.image_transform(SIZE, True), SimpleTokenizer(context_length=24))
    assert pipe.num_batches == 12

    class Step:
        step = 0

        def __call__(self, images, texts):
            self.step += 1
            return {"total_loss": torch.zeros(())}

    def alive(epoch):
        return [t.name for t in threading.enumerate()
                if t.name.startswith(f"wds-worker-e{epoch}-") and t.is_alive()]

    step = Step()
    for epoch in (0, 1):
        pipe.set_epoch(epoch)
        it = iter(pipe)
        steps, _ = train_one_epoch(step, it, epoch=epoch, global_batch_size=2,
                                   steps_per_epoch=2, device="cpu", log_every_n_steps=10)
        assert steps == 2
        deadline = time.monotonic() + 10
        while alive(epoch) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not alive(epoch), alive(epoch)
    assert step.step == 4
