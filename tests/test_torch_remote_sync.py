"""``--remote-sync`` (``colxlip_tpu_torch/utils/file_utils.py``,
``training/checkpoint.py`` ``get_latest_checkpoint_remote``, ``main``)
against the JAX package, with no network: a stub ``aws`` on ``PATH`` maps
``s3://<bucket>/<key>`` onto a local directory and records every argv.

- each function issues the JAX function's argv to the stub and gives its
  result (sync both ways, the listing's natural sort over ``epoch_<N>``
  only, a failed or missing ``aws``);
- the fsspec protocol puts the tree under a local ``file://`` directory;
- the background thread syncs until its stop event is set, then ends;
- ``main --remote-sync``: a run syncs its log directory at startup and
  after its last save; a fresh log directory with ``--resume latest`` pulls
  the newest remote checkpoint and logs the losses of an uninterrupted run
  (exact on the CPU; a constant learning rate, so the 2-epoch run's
  schedule is the 3-epoch run's). The two JAX refusals are in
  ``tests/test_torch_driver.py``.
"""
from __future__ import annotations

import json
import os
import stat
import sys
import textwrap

import pytest

from colxlip_tpu.training import checkpoint as jax_checkpoint
from colxlip_tpu.utils import file_utils as jax_fu
from colxlip_tpu_torch import main as main_mod
from colxlip_tpu_torch.training import checkpoint
from colxlip_tpu_torch.utils import file_utils as fu

TINY = "ViT-S-16-test"

STUB = textwrap.dedent('''\
    #!{python}
    """aws s3 sync / ls over a local directory (AWS_STUB_ROOT)."""
    import json, os, shutil, sys
    args = sys.argv[1:]
    with open(os.environ["AWS_STUB_LOG"], "a") as f:
        f.write(json.dumps(args) + "\\n")
    if os.environ.get("AWS_STUB_FAIL"):
        sys.stderr.write("stub failure\\n")
        sys.exit(1)
    root = os.environ["AWS_STUB_ROOT"]

    def local(p):
        return os.path.join(root, p[len("s3://"):]) if p.startswith("s3://") else p

    if args[:2] == ["s3", "sync"]:
        src, dst = local(args[2]), local(args[3])
        if os.path.isdir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
    elif args[:2] == ["s3", "ls"]:
        d = local(args[2])
        if not os.path.isdir(d):
            sys.exit(1)
        for name in sorted(os.listdir(d)):
            if os.path.isdir(os.path.join(d, name)):
                print(" " * 27 + "PRE " + name + "/")
            else:
                print("2026-01-01 00:00:00       1234 " + name)
    else:
        sys.exit(2)
''')


@pytest.fixture
def aws(tmp_path, monkeypatch):
    """The stub on PATH: (its bucket root, a reader of the argvs it got)."""
    bin_dir, root = tmp_path / "bin", tmp_path / "s3"
    bin_dir.mkdir()
    root.mkdir()
    stub = bin_dir / "aws"
    stub.write_text(STUB.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "aws.log"
    log.write_text("")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("AWS_STUB_ROOT", str(root))
    monkeypatch.setenv("AWS_STUB_LOG", str(log))

    def calls():
        return [json.loads(line) for line in log.read_text().splitlines()]
    return root, calls


def _tree(base, files):
    for rel, text in files.items():
        path = os.path.join(base, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


def _read_tree(base):
    out = {}
    for root, _, files in os.walk(base):
        for name in files:
            path = os.path.join(root, name)
            with open(path) as f:
                out[os.path.relpath(path, base)] = f.read()
    return out


FILES = {"out.log": "a\n", "checkpoints/epoch_1/state.pt": "x", "checkpoints/epoch_2/state.pt": "y"}


@pytest.mark.parametrize("name", ["remote_sync_s3", "remote_sync_pull", "remote_sync"])
def test_s3_sync_issues_the_jax_argv(tmp_path, aws, name):
    root, calls = aws
    local = tmp_path / "local"
    _tree(local, FILES)
    results = []
    for mod, bucket in ((jax_fu, "ref"), (fu, "port")):
        src, dst = str(local), f"s3://{bucket}/run"
        if name == "remote_sync_pull":
            src, dst = f"s3://{bucket}/run", str(tmp_path / f"pulled_{bucket}")
            _tree(root / bucket / "run", FILES)
        results.append(getattr(mod, name)(src, dst))
    got = calls()
    assert results == [True, True] and len(got) == 2
    assert [a[:2] + a[4:] for a in got] == [["s3", "sync", "--exact-timestamps"]] * 2
    assert got[1] == [g.replace("s3://ref/", "s3://port/").replace("pulled_ref", "pulled_port")
                      for g in got[0]]
    if name == "remote_sync_pull":
        assert _read_tree(tmp_path / "pulled_port") == FILES
    else:
        assert _read_tree(root / "port" / "run") == _read_tree(root / "ref" / "run") == FILES


def test_s3_sync_failures_return_false_as_jax(tmp_path, aws, monkeypatch):
    monkeypatch.setenv("AWS_STUB_FAIL", "1")
    for mod in (jax_fu, fu):
        assert mod.remote_sync_s3(str(tmp_path), "s3://b/run") is False
        assert mod.remote_sync_pull("s3://b/run", str(tmp_path / "x")) is False
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))          # no aws at all
    for mod in (jax_fu, fu):
        assert mod.remote_sync(str(tmp_path), "s3://b/run") is False


def test_latest_remote_checkpoint_as_jax(aws, monkeypatch):
    root, calls = aws
    prefix = root / "b" / "run" / "checkpoints"
    for name in ("epoch_1", "epoch_2", "epoch_10", "epoch_9", "epoch_latest", "epoch_3.tmp",
                 "other"):
        (prefix / name).mkdir(parents=True)
    remote = "s3://b/run/checkpoints"
    for arg in (remote, remote + "/"):
        got = checkpoint.get_latest_checkpoint_remote(arg)
        assert got == jax_checkpoint.get_latest_checkpoint_remote(arg) == remote + "/epoch_10"
    assert calls()[-1] == ["s3", "ls", remote + "/"]
    empty = "s3://b/none"
    assert checkpoint.get_latest_checkpoint_remote(empty) is None
    assert jax_checkpoint.get_latest_checkpoint_remote(empty) is None
    (root / "b" / "bare").mkdir()
    assert checkpoint.get_latest_checkpoint_remote("s3://b/bare") is None


def test_fsspec_puts_the_tree_under_a_local_url(tmp_path):
    local = tmp_path / "local"
    _tree(local, FILES)
    for mod, name in ((jax_fu, "jax"), (fu, "port")):
        assert mod.remote_sync(str(local), f"file://{tmp_path / name}", "fsspec") is True
    assert _read_tree(tmp_path / "port") == _read_tree(tmp_path / "jax") == FILES


def test_sync_thread_runs_until_stopped(tmp_path, aws):
    _, calls = aws
    local = tmp_path / "local"
    _tree(local, FILES)
    thread = fu.start_sync_process(0.05, str(local), "s3://b/run")
    assert thread.daemon and thread.name == "remote-sync"
    for _ in range(400):
        if len(calls()) >= 2:
            break
        thread.join(0.05)
    assert len(calls()) >= 2
    thread.stop_event.set()
    thread.join(10)
    assert not thread.is_alive()
    done = len(calls())
    thread.join(0.2)
    assert len(calls()) == done


def _argv(logs, *extra, epochs):
    return ["--device", "cpu", "--model", TINY, "--dataset-type", "synthetic",
            "--train-num-samples", "8", "--batch-size", "8", "--epochs", str(epochs),
            "--lr", "1e-3", "--warmup", "2", "--precision", "fp32", "--logs", str(logs),
            "--name", "run", "--workers", "0", "--log-every-n-steps", "1",
            "--save-frequency", "1", "--seed", "0", "--lr-scheduler", "const", *extra]


def _losses(logs):
    with open(os.path.join(logs, "run", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [(r["step"], r["total_loss"]) for r in records]


def test_main_syncs_and_resumes_from_the_remote_latest(tmp_path, aws):
    root, calls = aws
    sync = ("--remote-sync", "s3://bucket/runs")
    first = tmp_path / "first"
    assert main_mod.main(_argv(first, *sync, epochs=2)) == 0
    remote = root / "bucket" / "runs" / "run"
    # the startup sync, then the final one after the last save
    assert [c[:4] for c in calls()] == [["s3", "sync", str(first / "run"), "s3://bucket/runs/run"]] * 2
    assert sorted(os.listdir(remote / "checkpoints")) == ["epoch_1", "epoch_2"]
    assert os.path.isfile(remote / "checkpoints" / "epoch_2" / "state.pt")
    with open(remote / "metrics.jsonl") as f, open(first / "run" / "metrics.jsonl") as g:
        assert f.read() == g.read()

    fresh = tmp_path / "fresh"
    assert main_mod.main(_argv(fresh, *sync, "--resume", "latest", epochs=3)) == 0
    made = calls()[2:]
    assert made[0] == ["s3", "ls", "s3://bucket/runs/run/checkpoints/"]
    assert made[1][:4] == ["s3", "sync", "s3://bucket/runs/run/checkpoints/epoch_2",
                           str(fresh / "run" / "checkpoints" / "epoch_2")]
    with open(fresh / "run" / "out.log") as f:
        assert "Found latest checkpoint" in f.read()
    assert sorted(os.listdir(remote / "checkpoints")) == ["epoch_1", "epoch_2", "epoch_3"]

    whole = tmp_path / "whole"
    assert main_mod.main(_argv(whole, epochs=3)) == 0
    assert _losses(fresh) == _losses(whole)[2:]               # exact on the CPU
    assert [s for s, _ in _losses(fresh)] == [3]
