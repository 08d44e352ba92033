"""The comparison that decides ``correct`` fails what it has to fail: the
control (the reference in float8 in the program's place) and each fault a
cell can have, planted under a whole run at the test model's size on the
CPU, with the cells' own limits. A sound run passes them."""
import json

import pytest
import torch

from portbench import core, run

MAN = core.manifest()
TRAIN_CELLS = [w["name"] for w in MAN["workloads"] if w["name"].startswith("train.")]
EMBED_CELLS = [w["name"] for w in MAN["workloads"] if w["name"].startswith("embed.")]
FAULTS = [(c, f) for c in TRAIN_CELLS
          for f in ("half_batch", "frozen", "no_decay", "decay_all")] \
    + [(c, f) for c in EMBED_CELLS for f in ("altered", "half_batch")]


def run_line(cell, small, capsys, fault, seed, dtype="float32"):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", "0"], need_card=False, device=torch.device("cpu"),
                  fault=fault, overrides=small(cell, dtype))
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault, small, capsys):
    result = run_line(cell, small, capsys, fault, 2147483921)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", TRAIN_CELLS + EMBED_CELLS)
def test_a_sound_run_is_correct(cell, small, capsys):
    result = run_line(cell, small, capsys, None, 2147483922)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("cell", TRAIN_CELLS + EMBED_CELLS)
def test_the_control_is_not_correct(cell, small, capsys):
    """The control at the cell's limits, at the program's own bfloat16
    setting of the test model."""
    result = run_line(cell, small, capsys, "control", 2147483923, "bfloat16")
    assert result["correct"] is False, result["checks"]
