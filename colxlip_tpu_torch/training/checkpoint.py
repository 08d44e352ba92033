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
``epoch_<N>`` / ``epoch_latest`` exactly. The JAX package's orbax
directories are not read.

Sharded state (``parallel/gspmd.py``: DTensor parameters and moments
spread over processes) is saved by ``save_checkpoint_sharded``: every rank
writes only its shards through ``torch.distributed.checkpoint`` into the
same ``<tag>.tmp`` (the ``state`` of ``sharded_train_state``: the model's
and the optimizer's sharded state dicts, the optimizer keyed by parameter
name), rank 0 adds ``meta.json`` (epoch and name) and the sidecar and
renames the directory once every rank's write is done.
``restore_sharded_checkpoint`` reads it back into a sharded template, each
rank its own shards. The two formats read each other: ``load_native_checkpoint``
reads a sharded directory whole (moments included, the optimizer back in
``optimizer.state_dict()``'s layout), and ``restore_train_state`` puts a
whole state into a sharded model, each rank keeping its shards.

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
META_FILE = "meta.json"
SHARDED_MARK = ".metadata"       # torch.distributed.checkpoint's index file


def train_state(model: nn.Module, optimizer: torch.optim.Optimizer, step: int) -> Dict[str, Any]:
    """The state a checkpoint holds (references, not copies: save it before
    the next step)."""
    return {"step": int(step), "state_dict": model.state_dict(),
            "optimizer": optimizer.state_dict()}


def restore_train_state(state: Mapping[str, Any], model: nn.Module,
                        optimizer: torch.optim.Optimizer) -> int:
    """Load a checkpoint's whole state into the model and the optimizer
    (strictly); returns the optimizer step count to go on from. A sharded
    model (DTensor parameters) keeps each rank's shards of it."""
    if _is_sharded(model):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_model_state_dict, set_optimizer_state_dict)

        full = StateDictOptions(full_state_dict=True)
        set_model_state_dict(model, dict(state["state_dict"]), options=full)
        set_optimizer_state_dict(
            model, optimizer,
            optimizer_state_by_name(state["optimizer"], optimizer_param_names(model, optimizer)),
            options=full)
        return int(state["step"])
    model.load_state_dict(state["state_dict"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def _is_sharded(model: nn.Module) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in model.parameters())


def optimizer_param_names(model: nn.Module, optimizer: torch.optim.Optimizer) -> list:
    """The parameter name of each of the optimizer's parameters, in the order
    ``optimizer.state_dict()`` numbers them."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def optimizer_state_by_name(osd: Mapping[str, Any], names: list) -> Dict[str, Any]:
    """``optimizer.state_dict()`` (parameters numbered across the groups)
    -> the same state keyed by parameter name (``names[i]`` for number i),
    the layout of ``torch.distributed.checkpoint.state_dict``."""
    return {"state": {names[int(i)]: dict(v) for i, v in osd["state"].items()},
            "param_groups": [{**g, "params": [names[int(i)] for i in g["params"]]}
                             for g in osd["param_groups"]]}


def optimizer_state_by_id(osd: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``optimizer_state_by_name``: the groups' names are
    numbered in order across the groups, as ``optimizer.state_dict()``
    numbers its parameters."""
    ids: Dict[str, int] = {}
    groups = []
    for g in osd["param_groups"]:
        for n in g["params"]:
            ids[n] = len(ids)
        groups.append({**g, "params": [ids[n] for n in g["params"]]})
    return {"state": {ids[n]: dict(v) for n, v in osd["state"].items()},
            "param_groups": groups}


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
    """Block until the in-flight async save (if any) has finished; a sharded
    one is finished on every rank (each must call this). A failure
    of the background writer is re-raised here, as ``RuntimeError("async
    checkpoint save failed")`` from it: a swallowed save error would let
    training end with rc 0 and no checkpoint, where the synchronous save
    raises."""
    global _SAVE_THREAD, _SAVE_ERROR
    if _SAVE_THREAD is not None:
        _SAVE_THREAD.join()
        _SAVE_THREAD = None
    if _PENDING_SHARDED is not None:
        _finish_sharded_save()
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


def state_fully_addressable(state: Any) -> bool:
    """True when every tensor of ``state`` lives whole in this process (no
    DTensor spread over more than one rank): the whole save above handles
    it. False for FSDP or tensor-parallel state over several processes,
    which ``save_checkpoint_sharded`` saves."""
    from torch.distributed.tensor import DTensor

    found = []
    _map_tensors(state, found.append)
    return all(not isinstance(t, DTensor) or t.device_mesh.size() == 1 for t in found)


def sharded_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                        step: int) -> Dict[str, Any]:
    """The state a sharded checkpoint holds: the model's and the optimizer's
    sharded state dicts (DTensors; the optimizer keyed by parameter name).
    Every rank must call it (a fresh optimizer's state is created here)."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(model, optimizer)
    return {"step": int(step), "state_dict": model_sd, "optimizer": optim_sd}


def restore_sharded_train_state(state: Mapping[str, Any], model: nn.Module,
                                optimizer: torch.optim.Optimizer) -> int:
    """Put a ``sharded_train_state`` (as ``restore_sharded_checkpoint`` fills
    it) into the model and the optimizer; returns the step to go on from."""
    from torch.distributed.checkpoint.state_dict import set_state_dict

    set_state_dict(model, optimizer, model_state_dict=state["state_dict"],
                   optim_state_dict=state["optimizer"])
    return int(state["step"])


_CKPT_GROUP: Dict[str, Any] = {}
# (future, tmp, path, meta, rotation, start time) of the sharded save in flight
_PENDING_SHARDED: Optional[tuple] = None


def checkpoint_group():
    """The group the sharded saves coordinate on: the default group under
    gloo, a gloo group of every rank beside NCCL (the background write runs
    its collectives from a thread, on CPU tensors). Made once a default group,
    on the first save every rank enters."""
    import torch.distributed as dist

    if _CKPT_GROUP.get("world") is not dist.group.WORLD:      # a new default group
        _CKPT_GROUP.update(world=dist.group.WORLD, group=(
            dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")))
    return _CKPT_GROUP["group"]


def _finalize_sharded(tmp: str, path: str, meta: Dict[str, Any], step_in_epoch: int,
                      rotate: Optional[tuple], ok: bool) -> None:
    """After every rank's write: rank 0 adds the meta file and the sidecar,
    renames ``tmp`` to ``path`` and rotates, when every rank's write
    succeeded; the ranks leave together."""
    import torch.distributed as dist

    group = checkpoint_group()
    flag = torch.tensor([0 if ok else 1])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if dist.get_rank() == 0 and not int(flag):
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        if step_in_epoch > 0:
            with open(os.path.join(tmp, SIDECAR), "w") as f:
                json.dump({"epoch": meta["epoch"], "step_in_epoch": int(step_in_epoch)}, f)
        _replace_dir(tmp, path)
        if rotate is not None:
            rotate_checkpoints(*rotate)
    dist.barrier(group=group)


def _finish_sharded_save() -> None:
    global _PENDING_SHARDED, _SAVE_ERROR
    future, tmp, path, meta, rotate, t0 = _PENDING_SHARDED
    _PENDING_SHARDED = None
    ok = True
    try:
        future.result()
    except Exception as e:  # noqa: BLE001 - re-raised by wait_for_saves
        logger.exception("sharded background save of %s failed", path)
        _SAVE_ERROR, ok = e, False
    _finalize_sharded(tmp, path, meta, 0, rotate, ok)
    ASYNC_SECONDS["write"] = time.perf_counter() - t0


def save_checkpoint_sharded(checkpoint_dir: str, state: Mapping[str, Any], *, epoch: int,
                            name: str = "", most_recent: bool = False,
                            step_in_epoch: int = 0, background: bool = False,
                            rotate_keep_epoch: Optional[int] = None) -> str:
    """Every rank writes only its shards of ``state`` (``sharded_train_state``,
    or any nested dict of tensors, DTensors and plain values) through
    ``torch.distributed.checkpoint`` into ``epoch_<N>`` / ``epoch_latest``;
    every rank must call it. Rank 0 writes ``meta.json`` (epoch, name) and,
    for ``step_in_epoch > 0``, ``preempt.json``, and renames ``<tag>.tmp``
    once every write is done. ``background=True`` is ``async_save``: the call
    returns once the shards are copied to the host, one save is in flight at
    a time, and ``wait_for_saves`` (on every rank) finishes it, runs the
    rotation the save supersedes (``rotate_keep_epoch``) and re-raises a
    failure. Mid-epoch saves are always synchronous. The directory must be on
    a file system every rank sees."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    global _PENDING_SHARDED
    wait_for_saves()
    group = checkpoint_group()
    tag = "epoch_latest" if most_recent else f"epoch_{epoch}"
    path = os.path.join(os.path.abspath(checkpoint_dir), tag)
    tmp = path + ".tmp"
    if dist.get_rank() == 0:
        os.makedirs(checkpoint_dir, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    dist.barrier(group=group)
    meta = {"epoch": int(epoch), "name": name}
    rotate = (checkpoint_dir, rotate_keep_epoch) if rotate_keep_epoch is not None else None
    t0 = time.perf_counter()
    if background and step_in_epoch == 0:
        future = dcp.async_save(dict(state), checkpoint_id=tmp, process_group=group)
        ASYNC_SECONDS.update(snapshot=time.perf_counter() - t0, write=None)
        _PENDING_SHARDED = (future, tmp, path, meta, rotate, t0)
        return path
    ok = False
    try:
        dcp.save(dict(state), checkpoint_id=tmp, process_group=group)
        ok = True
    finally:
        _finalize_sharded(tmp, path, meta, step_in_epoch, rotate, ok)
    return path


def restore_sharded_checkpoint(path: str, template: Mapping[str, Any]) -> Dict[str, Any]:
    """Read a ``save_checkpoint_sharded`` directory into ``template`` (the
    same structure; its DTensors say which shards this rank reads), in
    place: returns {'epoch', 'name', 'state': template}. Every rank must
    call it."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    state = dict(template)
    dcp.load(state, checkpoint_id=path, process_group=checkpoint_group())
    return {**_read_meta(path), "state": state}


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
    """The payload of a checkpoint directory written by ``save_checkpoint``,
    or one written by ``save_checkpoint_sharded`` read whole in this process
    (full tensors, the optimizer in ``optimizer.state_dict()``'s layout)."""
    path = os.path.abspath(path)
    state_file = os.path.join(path, STATE_FILE)
    if is_sharded_checkpoint(path):
        state = _read_sharded_whole(path)
        state["optimizer"] = optimizer_state_by_id(state["optimizer"])
        if map_location is not None and torch.device(map_location).type != "cpu":
            state = _map_tensors(state, lambda t: t.to(map_location))
        return {**_read_meta(path), "state": state}
    if not os.path.isfile(state_file):
        raise FileNotFoundError(
            f"{path}: no {STATE_FILE} (a checkpoint of this package is a directory "
            "holding one; orbax directories of the JAX package are not read)")
    return torch.load(state_file, map_location=map_location, weights_only=True)


def is_sharded_checkpoint(path: str) -> bool:
    """Whether ``path`` was written by ``save_checkpoint_sharded``."""
    return os.path.isfile(os.path.join(path, SHARDED_MARK))


def _read_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    return {"epoch": int(meta["epoch"]), "name": meta["name"]}


def _map_tensors(x: Any, fn) -> Any:
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, Mapping):
        return type(x)((k, _map_tensors(v, fn)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(_map_tensors(v, fn) for v in x)
    return x


def _read_sharded_whole(path: str) -> Dict[str, Any]:
    """Every entry of a ``torch.distributed.checkpoint`` directory, whole,
    in this process alone: a template of full CPU tensors from the
    directory's metadata, loaded without a process group, then nested back
    as it was saved."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata()
    flat = {}
    for key, item in meta.state_dict_metadata.items():
        flat[key] = (torch.empty(item.size, dtype=item.properties.dtype)
                     if isinstance(item, TensorStorageMetadata) else None)
    dcp.load(flat, storage_reader=reader, no_dist=True)
    nested: Dict[Any, Any] = {}
    for key, value in flat.items():
        *parents, leaf = meta.planner_data.get(key, (key,))
        node = nested
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return _as_lists(nested)


def _as_lists(x: Any) -> Any:
    """Dicts keyed 0..n-1 (a saved list's items, ``param_groups``) back to
    lists, all the way down."""
    if not isinstance(x, dict):
        return x
    x = {k: _as_lists(v) for k, v in x.items()}
    if x and all(isinstance(k, int) for k in x):
        return [x[i] for i in range(len(x))]
    return x


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


def get_latest_checkpoint_remote(remote_dir: str) -> Optional[str]:
    """The newest ``epoch_<N>`` checkpoint under an s3 prefix (``--resume
    latest`` with ``--remote-sync``: the remote directory is authoritative,
    a fresh machine's local one may be empty), listed by ``aws s3 ls``; its
    full s3 path, or None (none there, or the listing failed)."""
    import subprocess

    try:
        proc = subprocess.run(["aws", "s3", "ls", remote_dir.rstrip("/") + "/"],
                              capture_output=True, text=True, timeout=120, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        logger.error("remote checkpoint listing failed: %s", e)
        return None
    names = []
    for line in proc.stdout.splitlines():
        # a directory entry reads "                           PRE epoch_3/"
        part = line.split()[-1].rstrip("/") if line.split() else ""
        if re.fullmatch(r"epoch_\d+", part):
            names.append(part)
    if not names:
        return None
    names.sort(key=_natural_key)
    return remote_dir.rstrip("/") + "/" + names[-1]


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
