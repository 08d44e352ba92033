"""A run of ``run.py``: its refusal without a card, its import check, and
its result line, on the CPU at the test model's size (the look for a card
skipped)."""
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench import core, run

ROOT = core.ROOT
TRAIN = "train.vit-b-16-colxlip.colclip-b256"
EMBED = "embed.vit-b-16-colxlip.index-search"


def cpu_run(cell, small, capsys, trace=0, fault=None, seed=2147483911):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], need_card=False, device=torch.device("cpu"),
                   fault=fault, overrides=small(cell))
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.mark.parametrize("names, found", [
    (["jax", "jax.numpy", "numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client", "flax.linen", "flaxx"], ["flax.linen", "jaxlib.xla_client"]),
    (["colxlip_tpu", "colxlip_tpu.ops.maxsim", "colxlip_tpu_torch.ops"],
     ["colxlip_tpu", "colxlip_tpu.ops.maxsim"]),
    (["colxlip_tpu_torch", "colxlip_tpu_torch.models.clip", "jaxtyping"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert core.forbidden_modules(names) == found


def test_run_refuses_without_a_card():
    """No card here: the run exits with a code other than 0 and prints no
    result, rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", TRAIN,
                           "--seed", "2147483912", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == run.EXIT_NO_CARD
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_run_without_the_program_prints_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", TRAIN,
                           "--seed", "2147483913", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_module_of_jax_loaded_fails_the_run(small, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, result, err = cpu_run(TRAIN, small, capsys)
    assert rc == run.EXIT_FORBIDDEN and result is None
    assert "jax" in err


@pytest.mark.parametrize("cell", [TRAIN, EMBED])
def test_result_line(cell, small, capsys):
    rc, result, err = cpu_run(cell, small, capsys)
    assert rc == 0 and result["correct"] is True
    e2e, _ = core.cell_metrics(core.manifest(), cell)
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert result["device"]["platform"] == "cpu" and result["failed"] == 0
    assert result["attempted"] > 0
    # the checks come last, in the line and on standard error
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", [TRAIN, EMBED])
def test_traced_result_line(cell, small, capsys):
    rc, result, _ = cpu_run(cell, small, capsys, trace=1)
    assert rc == 0 and result["correct"] is True
    assert result["device"]["window_s"] > 0
    gaps = result["breakdown"]["idle_gaps"]
    assert gaps and all(label.startswith("portbench.") for label, _ in gaps)
    # a CPU run reads no device metric
    assert "train.mfu" not in result["metrics"] and "embed.idle_share" not in result["metrics"]
