"""The port's training entry point on tar shards: ``main(["--device", "cpu",
"--train-data", ...])`` on seeded shards (``data/shard_writer.py``: 24
samples of 64-96 px, ``ViT-S-16-test`` at ``--force-image-size 64``) trains,
saves and resumes across epochs, with each feed flag, and refuses what it
must: ``--packed-feed`` without a uint8 wire format or on the synthetic
stream, an unknown ``--aug-cfg`` key, ``--pipeline grain``.
"""
from __future__ import annotations

import json
import math
import os

import pytest
import torch

from colxlip_tpu_torch import main as main_mod
from colxlip_tpu_torch.data import pack, shard_writer

TINY = "ViT-S-16-test"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The test workers share the CPU: one intra-op thread a process keeps
    the tiny steps from oversubscribing it (the loader threads run beside)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("tar")
    shard_writer.write_shards(str(root / "jpg"), 3, 8, short_side=64, long_side=(64, 96),
                              quality=90, workers=3)
    pack.pack_shards(str(root / "jpg" / "{0000..0002}.tar"), str(root / "raw"), size=72)
    return root


def _argv(logs, name, spec, *extra, epochs=2):
    return ["--device", "cpu", "--model", TINY, "--force-image-size", "64", "--train-data",
            spec, "--batch-size", "4", "--epochs", str(epochs), "--lr", "1e-3", "--warmup",
            "2", "--precision", "fp32", "--logs", str(logs), "--name", name, "--workers", "2",
            "--log-every-n-steps", "1", "--save-frequency", "1", "--seed", "0", *extra]


def _records(logs, name):
    with open(os.path.join(logs, name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_main_trains_on_tar_shards_saves_and_resumes(tmp_path, shards):
    """24 samples, batch 4, 2 workers: 6 batches an epoch (sizes.json)."""
    spec = str(shards / "jpg" / "{0000..0002}.tar")
    assert main_mod.main(_argv(tmp_path, "run", spec)) == 0
    ckpts = tmp_path / "run" / "checkpoints"
    assert {"epoch_1", "epoch_2"} <= set(os.listdir(ckpts))
    recs = _records(tmp_path, "run")
    assert [r["step"] for r in recs] == list(range(1, 13))
    assert all(math.isfinite(r["total_loss"]) for r in recs)
    assert main_mod.main(_argv(tmp_path, "run", spec, "--resume", "latest", epochs=3)) == 0
    assert os.path.isdir(ckpts / "epoch_3")
    with open(tmp_path / "run" / "out.log") as f:
        assert "epoch_2' (epoch 2)" in f.read()
    assert [r["step"] for r in _records(tmp_path, "run")] == list(range(1, 19))


FEEDS = {
    "native-decode": ["--native-decode"],
    "normalize-on-device": ["--normalize-on-device"],
    "native-uint8-packed": ["--native-decode", "--normalize-on-device", "--packed-feed"],
    "yuv420": ["--ship-format", "yuv420"],
    "yuv420-packed": ["--ship-format", "yuv420", "--packed-feed"],
    "aug-cfg": ["--aug-cfg", "scale=(0.5, 1.0)", "ratio=(0.75, 1.25)"],
    "resampled": ["--dataset-resampled"],
    "raw-rrc": ["raw"],
    "raw-crop-packed": ["raw", "--raw-aug", "crop", "--normalize-on-device", "--packed-feed"],
}


@pytest.mark.parametrize("feed", list(FEEDS))
def test_main_trains_with_each_feed(tmp_path, shards, feed):
    flags = list(FEEDS[feed])
    kind = "jpg"
    if flags and flags[0] == "raw":
        kind, flags = "raw", flags[1:]
    spec = str(shards / kind / "{0000..0002}.tar")
    assert main_mod.main(_argv(tmp_path, feed, spec, *flags, "--save-frequency", "0",
                               "--steps-per-epoch", "2", epochs=1)) == 0
    recs = _records(tmp_path, feed)
    assert len(recs) == 2
    assert all(math.isfinite(r["total_loss"]) for r in recs)
    with open(tmp_path / feed / "out.log") as f:
        log = f.read()
    assert ("Packed feed" in log) == ("--packed-feed" in flags)


REFUSED = [
    (["--packed-feed"], "requires a uint8 wire format"),
    (["--packed-feed", "--normalize-on-device", "--dataset-type", "synthetic"],
     "requires the webdataset pipeline"),
    (["--aug-cfg", "color_jitter=0.4"], "color_jitter"),
    (["--pipeline", "grain"], "--pipeline grain"),
]


@pytest.mark.parametrize("flags,message", REFUSED, ids=[m for _, m in REFUSED])
def test_main_refuses_what_the_tar_feed_cannot_take(tmp_path, monkeypatch, shards, flags,
                                                    message):
    def no_model(*a, **k):
        raise AssertionError("refused flags must stop main before any model work")

    monkeypatch.setattr(main_mod, "create_model_and_transforms", no_model)
    spec = str(shards / "jpg" / "{0000..0002}.tar")
    assert main_mod.main(_argv(tmp_path, "refused", spec, *flags)) == 1
    with open(tmp_path / "refused" / "out.log") as f:
        log = f.read()
    assert "ERROR" in log and message in log
