"""The train state on disk and back: port of the native half of
``colxlip_tpu/training/checkpoint.py``.

A checkpoint is a directory ``epoch_<N>`` (or ``epoch_latest``) under the
experiment's ``checkpoints/`` holding ``state.pt``: one ``torch.save`` of

    {"epoch": int, "name": str,
     "state": {"step": int, "state_dict": ..., "optimizer": ...}}

with the model's ``state_dict`` in the OpenCLIP layout the port uses
everywhere and the ``torch.optim.AdamW`` state. A mid-epoch (preemption)
save adds a ``preempt.json`` sidecar with the steps of the epoch already
run. Every save is written into ``<tag>.tmp`` and renamed, so a crash leaves
no half-written ``epoch_<N>``, and resume picks only names that match
``epoch_<N>`` / ``epoch_latest`` exactly. Saves are synchronous and whole;
the JAX package's orbax directories are not read.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
SIDECAR = "preempt.json"


def train_state(model: nn.Module, optimizer: torch.optim.Optimizer, step: int) -> Dict[str, Any]:
    """The state a checkpoint holds (references, not copies: save it before
    the next step)."""
    return {"step": int(step), "state_dict": model.state_dict(),
            "optimizer": optimizer.state_dict()}


def restore_train_state(state: Mapping[str, Any], model: nn.Module,
                        optimizer: torch.optim.Optimizer) -> int:
    """Load a checkpoint's state into the model and the optimizer (strictly);
    returns the optimizer step count to go on from."""
    model.load_state_dict(state["state_dict"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def _replace_dir(tmp: str, path: str) -> None:
    """Put the finished directory ``tmp`` at ``path``, replacing what is
    there: the old one is renamed aside first, so ``path`` is never missing
    for longer than the two renames."""
    backup = path + ".old"
    # a crash between the two renames leaves a stale .old; clear it, or the
    # next rename onto it fails for ever after
    shutil.rmtree(backup, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, backup)
    os.rename(tmp, path)
    shutil.rmtree(backup, ignore_errors=True)


def save_checkpoint(checkpoint_dir: str, state: Mapping[str, Any], *, epoch: int,
                    name: str = "", most_recent: bool = False,
                    step_in_epoch: int = 0) -> str:
    """Write ``epoch_<N>`` (or ``epoch_latest``) under ``checkpoint_dir``.

    ``step_in_epoch > 0`` marks a mid-epoch (preemption) checkpoint:
    ``epoch`` is then the incomplete epoch's index and the ``preempt.json``
    sidecar records how many optimizer steps of it already ran, so resume
    fast-forwards the data stream instead of replaying or losing the partial
    epoch."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    tag = "epoch_latest" if most_recent else f"epoch_{epoch}"
    path = os.path.join(os.path.abspath(checkpoint_dir), tag)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"epoch": int(epoch), "name": name, "state": dict(state)},
               os.path.join(tmp, STATE_FILE))
    if step_in_epoch > 0:
        with open(os.path.join(tmp, SIDECAR), "w") as f:
            json.dump({"epoch": int(epoch), "step_in_epoch": int(step_in_epoch)}, f)
    _replace_dir(tmp, path)
    return path


def read_step_in_epoch(checkpoint_path: str) -> int:
    """Steps of the checkpoint's epoch already run (0 for whole-epoch saves).
    A later save into the same name replaces the whole directory, so a stale
    sidecar never outlives its checkpoint."""
    try:
        with open(os.path.join(checkpoint_path, SIDECAR)) as f:
            return int(json.load(f)["step_in_epoch"])
    except (OSError, ValueError, KeyError):
        return 0


def load_native_checkpoint(path: str, map_location: Union[str, torch.device] = "cpu"
                           ) -> Dict[str, Any]:
    """The payload of a checkpoint directory written by ``save_checkpoint``."""
    state_file = os.path.join(os.path.abspath(path), STATE_FILE)
    if not os.path.isfile(state_file):
        raise FileNotFoundError(
            f"{path}: no {STATE_FILE} (a checkpoint of this package is a directory "
            "holding one; orbax directories of the JAX package are not read)")
    return torch.load(state_file, map_location=map_location, weights_only=True)


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def get_latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The newest ``epoch_*`` directory by natural sort, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    # positive selection: only finished checkpoints are named exactly
    # epoch_<N> or epoch_latest; .tmp / .old leftovers of a crashed save and
    # any other suffix are never picked
    entries = [e for e in os.listdir(checkpoint_dir)
               if re.fullmatch(r"epoch_(\d+|latest)", e)]
    if not entries:
        return None
    numbered = sorted((e for e in entries if e != "epoch_latest"), key=_natural_key)
    latest_path = os.path.join(checkpoint_dir, "epoch_latest")
    if "epoch_latest" not in entries:
        return os.path.join(checkpoint_dir, numbered[-1])
    if not numbered:
        return latest_path
    # Both exist. The save order is numbered-then-latest, so a current
    # epoch_latest is at least as new as the newest numbered directory; a
    # crash between the two leaves a stale one. Resolve by mtime, ties to
    # epoch_latest.
    newest_numbered = os.path.join(checkpoint_dir, numbered[-1])
    try:
        if os.stat(newest_numbered).st_mtime > os.stat(latest_path).st_mtime:
            return newest_numbered
    except OSError:
        pass
    return latest_path


def rotate_checkpoints(checkpoint_dir: str, current_epoch: int) -> None:
    """--delete-previous-checkpoint: remove every numbered checkpoint older
    than ``current_epoch`` (so it also rotates with --save-frequency > 1)."""
    for entry in os.listdir(checkpoint_dir):
        m = re.fullmatch(r"epoch_(\d+)", entry)
        if m and int(m.group(1)) < current_epoch:
            shutil.rmtree(os.path.join(checkpoint_dir, entry), ignore_errors=True)


def save_pt_checkpoint(path: str, model: Union[nn.Module, Mapping[str, torch.Tensor]], *,
                       epoch: int = 0, name: str = "") -> str:
    """Write an OpenCLIP-layout ``.pt``: {'state_dict', 'epoch', 'name'} with
    fp32 CPU tensors, what ``--pretrained`` and the JAX package's
    ``load_pt_checkpoint`` read."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    sd = {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}
    torch.save({"state_dict": sd, "epoch": int(epoch), "name": name}, path)
    return path
