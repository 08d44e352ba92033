"""``python -m colxlip_tpu_torch.main`` in two gloo processes (``--device cpu
--dist-coordinator 127.0.0.1:<port> --dist-num-processes 2
--dist-process-id r``), tiny ``ViT-S-16-test-colxlip`` on synthetic data,
each rank through ``tests/torch_dist_worker.py`` (suite ``main``):

- no ``--name``: rank 0 names the run and every rank uses that name;
- 2 epochs, then ``--epochs 3 --resume latest``: only rank 0 writes
  ``out.log``, ``params.txt``, ``metrics.jsonl`` and the checkpoints;
  ``--log-local`` gives rank 1 ``out-1.log``; both ranks end with the same
  parameters bit for bit, equal to rank 0's last checkpoint;
- with ``--gather-with-grad`` a step at 2 ranks of 4 logs the losses and
  the gradient norm of a step in one process at batch 8 (the global-batch
  gradient) within 1e-5;
- ``--preempt-save`` with the stop flag set on rank 1 alone stops both ranks
  at the same step, and rank 0 saves the mid-epoch checkpoint;
- the recipe flags composed (``--local-loss --token-dist ring
  --token-neighborhood 2 --text-ctx 16``) train.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from colxlip_tpu_torch import main as main_mod
from colxlip_tpu_torch.training.checkpoint import load_native_checkpoint

import torch_dist_worker as worker

W = 2
METRIC_RTOL = 1e-5


def _argv(logs, *extra, epochs=2, batch=4, samples=32):
    return ["--device", "cpu", "--model", worker.TINY, "--dataset-type", "synthetic",
            "--train-num-samples", str(samples), "--batch-size", str(batch),
            "--epochs", str(epochs),
            "--lr", "1e-3", "--warmup", "2", "--precision", "fp32", "--logs", str(logs),
            "--workers", "0", "--log-every-n-steps", "1", "--save-frequency", "1",
            "--seed", "0", *extra]


def _run(work, *argv, extra=None):
    os.makedirs(work, exist_ok=True)
    return worker.spawn_ranks("main", W, "-", str(work), list(argv), extra_argv=extra)


def _log(path):
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two 2-rank runs into one log directory: 2 epochs, then a third
    resumed from the latest checkpoint."""
    root = tmp_path_factory.mktemp("dist_main")
    logs = root / "logs"
    first = _run(root / "first", *_argv(logs, "--log-local", "--save-most-recent"))
    (name,) = os.listdir(logs)
    second = _run(root / "second", *_argv(logs, "--log-local", "--name", name, "--resume",
                                          "latest", epochs=3))
    return logs, name, first, second


def test_ranks_share_one_run_name_and_rank0_writes_alone(trained):
    logs, name, first, _ = trained
    assert [int(r["rc"]) for r in first] == [0, 0]
    assert os.listdir(logs) == [name]           # one name for both ranks
    base = logs / name
    assert sorted(os.listdir(base)) == ["checkpoints", "metrics.jsonl", "out-1.log",
                                        "out.log", "params.txt"]
    assert sorted(os.listdir(base / "checkpoints")) == ["epoch_1", "epoch_2", "epoch_3",
                                                        "epoch_latest"]
    with open(base / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    # 32 samples, 4 a rank and 2 ranks: 4 steps an epoch, 3 epochs over the two runs
    assert steps == list(range(1, 13))
    rank1 = _log(base / "out-1.log")
    assert "rank 1 of 2" in rank1 and "Train Epoch: 2 [step 12]" in rank1
    assert "rank 0 of 2" in _log(base / "out.log")


def test_resume_latest_reaches_every_rank_and_parameters_stay_bit_equal(trained):
    logs, name, first, second = trained
    assert [int(r["rc"]) for r in second] == [0, 0]
    assert [int(r["steps_run"]) for r in second] == [12, 12]
    for log in ("out.log", "out-1.log"):
        assert "resuming checkpoint" in _log(logs / name / log)
    ckpt = load_native_checkpoint(str(logs / name / "checkpoints" / "epoch_3"))
    sd = ckpt["state"]["state_dict"]
    for run in (first, second):
        keys = [k for k in run[0] if k.startswith("param/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(run[0][k], run[1][k], err_msg=k)
    for k in (k for k in second[0] if k.startswith("param/")):
        np.testing.assert_array_equal(second[0][k], sd[k[len("param/"):]].numpy(), err_msg=k)


def test_two_ranks_train_as_one_process_on_the_global_batch(tmp_path):
    """Full mode with gather_with_grad: the 2-rank step logs the losses and
    the gradient norm of a one-process step at batch 8 on the same rows (the
    global-batch gradient, averaged over the ranks). One step: later steps
    drift apart through AdamW, whose first updates are about lr * sign(g)
    for every gradient, however small."""
    assert main_mod.main(_argv(tmp_path / "one", "--name", "r", "--gather-with-grad",
                               "--save-frequency", "0", batch=8, epochs=1, samples=8)) == 0
    _run(tmp_path / "two", *_argv(tmp_path / "two", "--name", "r", "--gather-with-grad",
                                  "--save-frequency", "0", epochs=1, samples=8))
    logged = []
    for run in ("one", "two"):
        with open(tmp_path / run / "r" / "metrics.jsonl") as f:
            logged.append([json.loads(line) for line in f])
    assert [m["step"] for m in logged[0]] == [m["step"] for m in logged[1]] == [1]
    assert [m["samples_per_second_per_device"] * 2 for m in logged[1]] == \
        [m["samples_per_second"] for m in logged[1]]
    for one, two in zip(*logged):
        for k in ("total_loss", "global_contrastive_loss", "token_contrastive_loss",
                  "grad_norm", "logit_scale"):
            np.testing.assert_allclose(two[k], one[k], rtol=METRIC_RTOL, err_msg=k)


def test_stop_flag_on_one_rank_stops_both_at_the_same_step(tmp_path):
    logs = tmp_path / "logs"
    runs = _run(tmp_path / "w", *_argv(logs, "--name", "cut", "--log-local", "--preempt-save",
                                       "--preempt-check-every", "1", epochs=3),
                extra={1: ["--stop-after-step", "3"]})
    assert [int(r["rc"]) for r in runs] == [0, 0]
    assert [int(r["steps_run"]) for r in runs] == [3, 3]
    for log in ("out.log", "out-1.log"):
        assert "stop requested: leaving epoch 0 after 3 step(s)" in _log(logs / "cut" / log)
    assert "received signal" in _log(logs / "cut" / "out-1.log")
    assert "received signal" not in _log(logs / "cut" / "out.log")
    ckpts = logs / "cut" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["epoch_latest"]
    with open(ckpts / "epoch_latest" / "preempt.json") as f:
        assert json.load(f)["step_in_epoch"] == 3


def test_recipe_flags_composed_train(tmp_path):
    """--local-loss --token-dist ring --token-neighborhood 2 --text-ctx 16
    at 2 ranks: finite losses on both, the same parameters on both."""
    runs = _run(tmp_path / "w", *_argv(tmp_path / "logs", "--name", "recipe", "--local-loss",
                                       "--token-dist", "ring", "--token-neighborhood", "2",
                                       "--text-ctx", "16", "--save-frequency", "0",
                                       epochs=1))
    assert [int(r["rc"]) for r in runs] == [0, 0]
    with open(tmp_path / "logs" / "recipe" / "metrics.jsonl") as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    assert len(losses) == 4 and np.isfinite(losses).all()
    for k in (k for k in runs[0] if k.startswith("param/")):
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)
