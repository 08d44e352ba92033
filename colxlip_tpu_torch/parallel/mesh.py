"""The data-parallel process group: port of ``colxlip_tpu/parallel/mesh.py``.

In the JAX package one process may hold several devices and a
``jax.sharding.Mesh`` spans them; collectives name the mesh axis ``'data'``.
Here one process holds one device (a GPU, or the CPU under ``--device
cpu``), so a rank is one device of the JAX data axis and the axis becomes a
``torch.distributed`` process group: NCCL for CUDA tensors, gloo for CPU
tensors. Functions that take ``axis_name`` accept None (one device), the
name ``DATA_AXIS`` (the group ``initialize_multihost`` created) or a
process group itself.

NCCL refuses two ranks on one GPU, so one card runs a group of one. Tensor
and sequence sharding (the JAX ``'model'`` axis) is not ported:
``create_mesh(model_parallel > 1)`` raises.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"

AxisName = Union[None, str, dist.ProcessGroup]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: str = "nccl") -> bool:
    """Create the data-parallel group (``torch.distributed`` rendezvous over
    ``tcp://<coordinator_address>``), the counterpart of
    ``jax.distributed.initialize``. A no-op at one process, as in JAX. With
    no flags at all and torchrun's ``WORLD_SIZE`` > 1 in the environment the
    rendezvous is ``env://``, as ``jax.distributed.initialize()`` finds its
    cluster. Under NCCL the process first takes ``cuda:<local rank>``.
    Returns True when this call created the group (the caller destroys it)."""
    if dist.is_initialized():
        return False
    if coordinator_address is None and num_processes is None and process_id is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return False
        if backend == "nccl":
            torch.cuda.set_device(local_rank(int(os.environ["RANK"])))
        dist.init_process_group(backend, init_method="env://")
        return True
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("multi-process training needs --dist-coordinator host:port and "
                         "--dist-process-id beside --dist-num-processes")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--dist-process-id {process_id} not in [0, {num_processes})")
    if backend == "nccl":
        torch.cuda.set_device(local_rank(process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def local_rank(process_id: int) -> int:
    """This process's GPU index: torchrun's ``LOCAL_RANK`` when set, else
    ``process_id % torch.cuda.device_count()``."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % torch.cuda.device_count()


def data_group() -> Optional[dist.ProcessGroup]:
    """The group of the data axis (the default group), or None before
    ``initialize_multihost`` created one."""
    return dist.group.WORLD if dist.is_initialized() else None


def resolve_group(axis_name: AxisName) -> Optional[dist.ProcessGroup]:
    """None -> None (one device); ``DATA_AXIS`` -> ``data_group()``; a
    process group -> itself."""
    if axis_name is None or isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    if axis_name != DATA_AXIS:
        raise ValueError(f"unknown axis {axis_name!r}: the port has the {DATA_AXIS!r} "
                         "axis only")
    group = data_group()
    if group is None:
        raise RuntimeError(f"axis {DATA_AXIS!r}: no process group; call "
                           "initialize_multihost (or torch.distributed.init_process_group) "
                           "first")
    return group


def rank() -> int:
    """This process's rank in the data group; 0 with no group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The number of ranks in the data group; 1 with no group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_nccl(group: Optional[dist.ProcessGroup]) -> bool:
    return dist.get_backend(group) == "nccl"


def collective_device(group: Optional[dist.ProcessGroup] = None) -> torch.device:
    """Where a tensor for a collective on ``group`` lives: this process's GPU
    under NCCL, the CPU under gloo."""
    if is_nccl(group):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(model_parallel: int = 1) -> dist.ProcessGroup:
    """The data-parallel group over every rank (the JAX 1-D ``('data',)``
    mesh). ``model_parallel > 1`` raises: tensor parallelism and sharded state
    (``parallel/gspmd.py``) wait for their DTensor / FSDP2 port."""
    if model_parallel > 1:
        raise NotImplementedError(
            f"create_mesh(model_parallel={model_parallel}): the 'model' axis "
            "(parallel/gspmd.py onto DTensor / FSDP2) is not yet ported")
    return resolve_group(DATA_AXIS)


def broadcast_str(value: str, group: Optional[dist.ProcessGroup] = None,
                  max_len: int = 512) -> str:
    """Rank 0's ``value`` on every rank of ``group`` (``value`` itself with
    no group): at most ``max_len`` UTF-8 bytes as one uint8 broadcast."""
    if group is None:
        return value
    buf = torch.zeros(max_len, dtype=torch.uint8)
    raw = value.encode()[:max_len]
    buf[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    buf = buf.to(collective_device(group))
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return bytes(buf.cpu().tolist()).rstrip(b"\x00").decode()
