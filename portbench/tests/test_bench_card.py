"""Each cell once on the card, briefly: it runs, and its outputs are
correct. Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from portbench import core

CELLS = [w["name"] for w in core.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                           "--seed", "2147483931", "--seconds", "2", "--trace", "0"],
                          cwd=core.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
