"""What every run shares: the manifest, a cell's files found by name, the
program's model built from the benchmark's own weights, the checks of
outputs against their limits, the import check and the result line."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
from typing import Any, Dict, Iterable, List, Optional

from .yardstick.flops import Geometry

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_DIR = pathlib.Path(__file__).resolve().parent
FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "colxlip_tpu")
# build and kernel caches of the program, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": ".portbench_cache/triton",
              "TORCH_EXTENSIONS_DIR": ".portbench_cache/torch_extensions"}


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One entry of the manifest's ``workloads`` with its files: the
    workload (``workloads/<name>.json``) and its configuration
    (``configs/<config>.json``)."""
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool

    @property
    def kind(self) -> str:
        return self.workload["kind"]

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def chips(self) -> int:
        return self.workload.get("chips", 1)

    @property
    def geometry(self) -> Geometry:
        return Geometry.from_model(self.config["model"])

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


def load_cell(name: str, seed: int, seconds: float, trace: bool,
              overrides: Optional[dict] = None) -> Cell:
    """The cell's files by name. ``overrides`` (tests only) replaces keys of
    the workload (``params`` merged key by key) and of the configuration."""
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = load_json(BENCH_DIR / "configs" / f"{workload['config']}.json")
    if overrides:
        workload = {**workload, **overrides.get("workload", {}),
                    "params": {**workload["params"], **overrides.get("params", {})}}
        config = {**config, **overrides.get("config", {})}
    return Cell(name, workload, config, seed, seconds, trace)


def cell_metrics(man: dict, cell: str):
    """(end-to-end entries, per-layer entries) the manifest gives ``cell``."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in man["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return e2e, per_layer


def set_environment(cell: Cell) -> None:
    """The workload's program settings, and the caches inside the checkout.
    Set before the program is imported: its modules read them when built."""
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    os.environ.update(cell.workload.get("env", {}))


def load_kind(kind: str):
    """The traffic kind's module, ``traffic/<kind>.py``."""
    return importlib.import_module(f"portbench.traffic.{kind}")


def load_reference(cell: "Cell"):
    """The configuration's plain reference, ``reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{cell.config['reference']}")


def load_reader(metric: str):
    """The per-layer metric's reader, ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """Module names whose top-level name (before the first dot) is one of
    ``FORBIDDEN_TOP_LEVEL``, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_TOP_LEVEL)


# The program's model on the benchmark's weights -------------------------------------

# every setting the reference assumes, as the program's config must hold it
_VISION_SETTINGS = {"mlp_ratio": 4.0, "ls_init_value": None, "patch_dropout": 0.0,
                    "attentional_pool": False, "no_ln_pre": False,
                    "pos_embed_type": "learnable", "final_ln_after_pool": False,
                    "pool_type": "tok"}
_TEXT_SETTINGS = {"mlp_ratio": 4.0, "ls_init_value": None, "embed_cls": False,
                  "no_causal_mask": False, "pool_type": "argmax", "proj_type": "linear",
                  "proj_bias": False}


def check_program_config(cfg, model: dict) -> None:
    """Raise unless the program's registered config is the configuration
    file's model: its sizes and every setting the reference assumes."""
    g = Geometry.from_model(model)
    v, t = cfg.vision_cfg, cfg.text_cfg
    found = {"embed_dim": cfg.embed_dim, "image_size": v.image_size,
             "patch_size": v.patch_size, "v_width": v.width, "v_layers": v.layers,
             "v_head_width": v.head_width, "t_ctx": t.context_length, "t_width": t.width,
             "t_layers": t.layers, "t_heads": t.heads, "vocab_size": t.vocab_size}
    wrong = {k: (val, getattr(g, k)) for k, val in found.items() if val != getattr(g, k)}
    for obj, want in ((v, _VISION_SETTINGS), (t, _TEXT_SETTINGS)):
        wrong.update({k: (getattr(obj, k), w) for k, w in want.items() if getattr(obj, k) != w})
    for k in ("quick_gelu", "gelu_approximate"):
        if getattr(cfg, k):
            wrong[k] = (True, False)
    if wrong:
        raise RuntimeError(f"the program's config differs from the benchmark's "
                           f"(found, expected): {wrong}")


def build_program_model(cell: Cell, device, train: bool):
    """The program's ColXLIP from its registry, built on ``device`` without
    its own initialisation, holding the benchmark's weights for ``cell.seed``."""
    import torch
    from colxlip_tpu_torch.factory import model_config
    from colxlip_tpu_torch.models.clip import ColXLIP

    from .weights import make_state

    cfg = model_config(cell.config["model_name"])
    check_program_config(cfg, cell.config["model"])
    dtype = getattr(torch, cell.config["dtype"])
    with torch.device(device):
        model = ColXLIP(cfg, dtype=dtype)
    model.load_state_dict(make_state(cell.geometry, cell.seed, device), strict=True)
    return model.train(train), cfg


class Stages:
    """Seconds of each stage of a run's set-up, printed to standard error."""

    def __init__(self):
        self.items: List[tuple] = []
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.items.append((name, now - self._t))
        self._t = now

    def line(self) -> str:
        return "setup stages: " + ", ".join(f"{n} {s:.2f} s" for n, s in self.items)


# Checks and the result line ---------------------------------------------------------

@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_from(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    missing = sorted(set(limits) - set(values))
    if missing:
        raise RuntimeError(f"no reading for the limits {missing}")
    return [Check(k, values[k], limits[k]) for k in limits]


def emit(result: Dict[str, Any], checks: List[Check]) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output, with the
    checks under the key that comes last."""
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    print(json.dumps(result), flush=True)
