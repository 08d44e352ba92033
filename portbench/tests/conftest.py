"""Shared fixtures of the benchmark's own tests: a cell's files overridden
down to the CPU test model (``ViT-S-16-test-colxlip``) and small traffic."""
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TEST_MODEL = "ViT-S-16-test-colxlip"
TRAIN_PARAMS = {"batch": 8, "pool": 4, "ref_block": 4, "warm_steps": 4, "trace_steps": 2}
EMBED_PARAMS = {"callers": [{"clients": 1, "kind": "image", "items": [16, 16], "tokens": True},
                            {"clients": 3, "kind": "text", "items": [1, 1], "tokens": True}],
                "image_pool": 32, "text_pool": 32, "plan_requests": 8, "keep_every": 2,
                "keep_max": 4, "max_batch": 8, "trace_seconds": 0.5}


def small_overrides(cell: str, dtype: str = "float32") -> dict:
    """The cell at the CPU test model's size. In float32 the program's gaps
    from the reference are rounding alone, so a sound run passes the
    cell's limits and a planted fault or the control shows plainly."""
    with open(ROOT / "colxlip_tpu_torch" / "model_configs" / f"{TEST_MODEL}.json") as f:
        model = json.load(f)
    params = TRAIN_PARAMS if cell.startswith("train.") else EMBED_PARAMS
    return {"config": {"model_name": TEST_MODEL, "model": model, "dtype": dtype},
            "params": params}


@pytest.fixture
def small():
    """``small(cell, dtype='float32')``: the overrides above."""
    return small_overrides


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_environ(monkeypatch):
    """A run sets the cell's program settings and cache directories in the
    environment; each test gets its own copy of it."""
    import os
    for key, value in list(os.environ.items()):
        monkeypatch.setenv(key, value)
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)
