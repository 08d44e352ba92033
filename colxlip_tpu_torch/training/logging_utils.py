"""Logging, meters and experiment bookkeeping: port of
``colxlip_tpu/training/logging_utils.py``.

  - ``AverageMeter``
  - ``setup_logging``: console + the experiment's ``out.log``
  - ``dump_params``: the flags to ``params.txt``
  - ``MetricsWriter``: an always-on JSONL stream of scalars, plus
    TensorBoard / wandb where those packages import (a missing package
    degrades to JSONL with a warning, as in the JAX package)
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional


class AverageMeter:
    """Running average: last value, sum, count and mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def setup_logging(log_file: Optional[str], level=logging.INFO) -> None:
    """Root logger -> console + optional per-experiment file."""
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(message)s", datefmt="%Y-%m-%d,%H:%M:%S"
    )
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers = []
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)


def dump_params(args, path: str) -> None:
    """Flattened args dump, one ``name: value`` line per flag."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for name in sorted(vars(args)):
            f.write(f"{name}: {getattr(args, name)}\n")


class MetricsWriter:
    """Scalar streams to JSONL and (if available) TensorBoard / wandb.

    ``--report-to wandb`` initializes a run named after the experiment, logs
    every scalar with the step, and finishes on close. Missing packages
    degrade to JSONL with a warning rather than failing the run.
    """

    def __init__(self, log_dir: str, report_to: str = "",
                 wandb_project: str = "colxlip_tpu",
                 wandb_notes: str = "", run_name: Optional[str] = None,
                 resume: bool = False, config: Optional[dict] = None):
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        self._wandb = None
        sinks = {s.strip() for s in report_to.split(",") if s.strip()}
        if "tensorboard" in sinks:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tensorboard"))
            except Exception:
                logging.getLogger(__name__).warning(
                    "tensorboard unavailable; falling back to JSONL only"
                )
        if "wandb" in sinks:
            try:
                import wandb

                wandb.init(
                    project=wandb_project,
                    name=run_name or os.path.basename(log_dir),
                    notes=wandb_notes,
                    dir=log_dir,
                    resume="auto" if resume else None,
                    config=config or {},
                )
                self._wandb = wandb
            except Exception as e:
                logging.getLogger(__name__).warning(
                    "wandb unavailable (%s); falling back to JSONL only", e
                )

    def write(self, metrics: Dict[str, float], step: int) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log(
                {k: float(v) for k, v in metrics.items()}, step=step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
