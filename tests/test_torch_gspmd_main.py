"""``python -m colxlip_tpu_torch.main`` with sharded state in two gloo
processes (``tests/torch_dist_worker.py`` suite ``main``), tiny
``ViT-S-16-test-colxlip`` on synthetic data, against one process of the
port at the global batch (the pattern of the JAX
``tests/test_multihost.py::test_two_process_fsdp_sharded_checkpoint_resume``
and ``tests/test_main_driver.py::test_main_model_parallel``):

- ``--fsdp --gather-with-grad --lr-scheduler const``: 2 epochs with sharded
  saves (every rank its shards, ``meta.json`` beside them), then ``--epochs
  3 --resume latest`` from the sharded ``epoch_2``; the logged losses and
  ``logit_scale`` of all 6 steps (``grad_norm`` of the first) equal the
  one-process run's within 1e-5 (at learning rate 1e-4: ``LR``), and the resumed run's epoch-end eval on a seeded
  Flickr-layout suite (the whole parameters gathered on both ranks, rank 0
  evaluating a plain copy) writes the one-process run's results;
- the sharded ``epoch_3`` read whole in this process equals rank 0's
  parameters after the run;
- ``--model-parallel 2 --gather-with-grad`` at 2 ranks trains the same
  global batch (both ranks read the same rows) with the one-process run's
  losses within 1e-5.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
from PIL import Image

from colxlip_tpu_torch import main as main_mod
from colxlip_tpu_torch.training.checkpoint import is_sharded_checkpoint, load_native_checkpoint

import torch_dist_worker as worker

W = 2
METRIC_RTOL = 1e-5
LOSSES = ("total_loss", "global_contrastive_loss", "token_contrastive_loss", "logit_scale")
# AdamW moves an element whose gradient is near its eps (1e-6) by about
# lr * (that gradient's rounding) / eps, so the trajectories of two sum
# orders part in proportion to lr: at 1e-3 the third step's loss reads 1.45e-5
# apart, at 1e-4 they stay within the bar over the six steps. The gradient
# norm, which jumps from 16 to 855 at the second step, is held at the first
# step only: later it reads up to 2.1e-5 apart, the same digits as the
# data-parallel step's (tests/test_torch_dist_main.py holds one step too)
LR = 1e-4


def _write_flickr(root, n_images=6, seed=0):
    """A Flickr30k-layout suite of seeded JPEGs; returns its root_dir."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "flickr30k-images")
    os.makedirs(img_dir)
    anns = []
    for i in range(n_images):
        arr = (rng.random((int(rng.integers(40, 90)), 64, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, f"{i}.jpg"), quality=90)
        anns.append({"image": f"flickr30k-images/{i}.jpg",
                     "caption": [f"a photo {i} {j}" for j in range(2)]})
    with open(os.path.join(img_dir, "flickr30k_val.json"), "w") as f:
        json.dump(anns, f)
    return img_dir


def _argv(logs, name, *extra, epochs, batch):
    return ["--device", "cpu", "--model", worker.TINY, "--dataset-type", "synthetic",
            "--train-num-samples", "16", "--batch-size", str(batch), "--epochs", str(epochs),
            "--lr", str(LR), "--warmup", "2", "--lr-scheduler", "const", "--gather-with-grad",
            "--precision", "fp32", "--logs", str(logs), "--name", name, "--workers", "0",
            "--log-every-n-steps", "1", "--seed", "0", *extra]


def _metrics(logs, name):
    with open(os.path.join(logs, name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _results(logs, name):
    with open(os.path.join(logs, name, "checkpoints", "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run(work, argv):
    os.makedirs(work, exist_ok=True)
    return worker.spawn_ranks("main", W, "-", str(work), argv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gspmd_main")
    flickr = _write_flickr(str(root / "flickr"))
    suite = ["--retrieval-flickr", "--flickr-data-root-dir", flickr,
             "--allow-degraded-tokenizer", "--val-frequency", "3"]
    logs = root / "logs"
    fsdp = ["--fsdp", "--save-frequency", "1"]
    runs = {}

    def sharded():
        runs["first"] = _run(root / "first", _argv(logs, "fsdp", *fsdp, epochs=2, batch=4))
        runs["second"] = _run(root / "second", _argv(logs, "fsdp", *fsdp, "--resume", "latest",
                                                     *suite, epochs=3, batch=4))

    def model_parallel():
        runs["mp"] = _run(root / "mp", _argv(logs, "mp", "--model-parallel", "2",
                                             "--save-frequency", "0", epochs=1, batch=8))

    # the two 2-rank runs go on beside the one-process run at the global batch
    threads = [threading.Thread(target=fn) for fn in (sharded, model_parallel)]
    for t in threads:
        t.start()
    try:
        assert main_mod.main(_argv(logs, "one", "--save-frequency", "0", *suite, epochs=3,
                                   batch=8)) == 0
    finally:
        for t in threads:
            t.join()
    assert set(runs) == {"first", "second", "mp"}, "a 2-rank run failed"
    return {"logs": logs, **runs}


def test_fsdp_saves_shards_and_resumes_with_the_one_process_losses(runs):
    logs = runs["logs"]
    assert [int(r["rc"]) for r in runs["first"] + runs["second"]] == [0] * 4
    ckpts = logs / "fsdp" / "checkpoints"
    assert sorted(e for e in os.listdir(ckpts) if e.startswith("epoch")) == [
        "epoch_1", "epoch_2", "epoch_3"]
    for tag in ("epoch_1", "epoch_2", "epoch_3"):
        assert is_sharded_checkpoint(str(ckpts / tag))
        assert {f"__{r}_0.distcp" for r in range(W)} <= set(os.listdir(ckpts / tag))
    with open(logs / "fsdp" / "out.log") as f:
        assert "resuming checkpoint" in f.read()
    one, two = _metrics(logs, "one"), _metrics(logs, "fsdp")
    assert [m["step"] for m in one] == [m["step"] for m in two] == list(range(1, 7))
    for a, b in zip(one, two):
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=METRIC_RTOL, err_msg=f"{k} {a['step']}")
    np.testing.assert_allclose(two[0]["grad_norm"], one[0]["grad_norm"], rtol=METRIC_RTOL)


def test_epoch_end_eval_gathers_the_sharded_parameters(runs):
    logs = runs["logs"]
    got, want = _results(logs, "fsdp"), _results(logs, "one")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [3]
    assert got == want


def _whole(ranks, name):
    """The whole tensor from the ranks' shards on a data mesh of W ranks."""
    placements = str(ranks[0][f"placements/{name}"])
    if "Shard" not in placements:
        return ranks[0][f"param/{name}"]
    dim = int(placements.split("Shard(dim=")[1].split(")")[0])
    return np.concatenate([r[f"param/{name}"] for r in ranks], axis=dim)


def test_sharded_checkpoint_reads_whole_as_the_trained_parameters(runs):
    saved = load_native_checkpoint(str(runs["logs"] / "fsdp" / "checkpoints" / "epoch_3"))
    assert saved["epoch"] == 3 and saved["name"] == "fsdp" and saved["state"]["step"] == 6
    sd = saved["state"]["state_dict"]
    ranks = runs["second"]
    names = [k[len("param/"):] for k in ranks[0] if k.startswith("param/")]
    assert sorted(names) == sorted(sd)
    sharded = [n for n in names if "Shard" in str(ranks[0][f"placements/{n}"])]
    assert len(sharded) > len(names) // 2
    for n in names:
        np.testing.assert_array_equal(_whole(ranks, n), sd[n].numpy(), err_msg=n)


def test_model_parallel_trains_the_global_batch_with_the_one_process_losses(runs):
    logs = runs["logs"]
    assert [int(r["rc"]) for r in runs["mp"]] == [0, 0]
    one, mp = _metrics(logs, "one")[:2], _metrics(logs, "mp")
    assert [m["step"] for m in mp] == [1, 2]
    for a, b in zip(one, mp):
        for k in LOSSES:
            np.testing.assert_allclose(b[k], a[k], rtol=METRIC_RTOL, err_msg=f"{k} {a['step']}")
    np.testing.assert_allclose(mp[0]["grad_norm"], one[0]["grad_norm"], rtol=METRIC_RTOL)
