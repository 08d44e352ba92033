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
``epoch_<N>`` / ``epoch_latest`` exactly. Saves are whole; the JAX
package's orbax directories are not read.

``save_checkpoint_async`` (``--async-checkpoint``) takes a snapshot of the
state, which is finished when it returns (the live tensors are updated in
place by the next step), and writes it with ``save_checkpoint`` in a
background thread; one save is in flight at a time and ``wait_for_saves``
joins it, re-raising the writer's failure.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
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


_SAVE_THREAD: Optional[threading.Thread] = None
_SAVE_ERROR: Optional[BaseException] = None
# seconds of the last async save: the blocking snapshot, the background write
ASYNC_SECONDS: Dict[str, Optional[float]] = {"snapshot": None, "write": None}


def wait_for_saves() -> None:
    """Block until the in-flight async save (if any) has finished. A failure
    of the background writer is re-raised here, as ``RuntimeError("async
    checkpoint save failed")`` from it: a swallowed save error would let
    training end with rc 0 and no checkpoint, where the synchronous save
    raises."""
    global _SAVE_THREAD, _SAVE_ERROR
    if _SAVE_THREAD is not None:
        _SAVE_THREAD.join()
        _SAVE_THREAD = None
    if _SAVE_ERROR is not None:
        err, _SAVE_ERROR = _SAVE_ERROR, None
        raise RuntimeError("async checkpoint save failed") from err


def snapshot_state(state: Any, device_budget: int = 0) -> Any:
    """A finished copy of ``state`` (nested dicts, lists and tuples of
    tensors and plain values). CUDA tensors are copied on the device when
    their bytes fit in ``device_budget``, else into pinned host buffers with
    one synchronize at the end; CPU tensors are cloned."""
    tensors = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, Mapping):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(state)
    on_device = sum(t.numel() * t.element_size() for t in tensors if t.is_cuda)
    keep_on_device = on_device <= device_budget

    def copy(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if not x.is_cuda or keep_on_device:
                return x.clone()
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return host.copy_(x, non_blocking=True)
        if isinstance(x, Mapping):
            return type(x)((k, copy(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    snap = copy(state)
    if on_device and not keep_on_device:
        torch.cuda.synchronize()
    return snap


def save_checkpoint_async(checkpoint_dir: str, state: Mapping[str, Any], *, epoch: int,
                          name: str = "", most_recent: bool = False,
                          also_most_recent: bool = False,
                          rotate_keep_epoch: Optional[int] = None) -> None:
    """Checkpoint without stopping training for the write.

    Joins the previous save first (one in flight at a time), snapshots
    ``state`` (``snapshot_state``; the device budget in bytes is
    ``$COLXLIP_ASYNC_SNAPSHOT_HBM``, default 0: a host copy), and writes the
    snapshot with ``save_checkpoint`` in a daemon thread.
    ``also_most_recent`` writes ``epoch_latest`` from the same snapshot after
    ``epoch_<N>``; ``rotate_keep_epoch`` runs ``rotate_checkpoints`` only
    once the save that supersedes the old checkpoints is on disk. The
    writer's failure is re-raised by the next ``wait_for_saves``."""
    global _SAVE_THREAD
    wait_for_saves()
    t0 = time.perf_counter()
    snap = snapshot_state(state, int(os.environ.get("COLXLIP_ASYNC_SNAPSHOT_HBM", 0)))
    ASYNC_SECONDS.update(snapshot=time.perf_counter() - t0, write=None)

    def write():
        global _SAVE_ERROR
        t1 = time.perf_counter()
        try:
            save_checkpoint(checkpoint_dir, snap, epoch=epoch, name=name,
                            most_recent=most_recent)
            if also_most_recent and not most_recent:
                save_checkpoint(checkpoint_dir, snap, epoch=epoch, name=name,
                                most_recent=True)
            if rotate_keep_epoch is not None:
                rotate_checkpoints(checkpoint_dir, rotate_keep_epoch)
            ASYNC_SECONDS["write"] = time.perf_counter() - t1
            logger.info("async checkpoint of epoch %d: snapshot %.3f s (blocking), "
                        "write %.3f s (background)", epoch, ASYNC_SECONDS["snapshot"],
                        ASYNC_SECONDS["write"])
        except Exception as e:  # noqa: BLE001 - re-raised by wait_for_saves
            logger.exception("async checkpoint save failed (epoch %d)", epoch)
            _SAVE_ERROR = e

    _SAVE_THREAD = threading.Thread(target=write, daemon=True, name="async-checkpoint")
    _SAVE_THREAD.start()


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
