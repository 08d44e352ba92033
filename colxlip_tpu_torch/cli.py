"""What the command-line scripts of the port share (``scripts/torch_*.py``,
``examples/torch_minimal_example.py``): the ``--device`` rule and loading a
model from a checkpoint of either kind.

Every script runs on ``cuda:0`` unless it is told ``--device cpu``, and
raises when it is given a CUDA device and none is available: the plain
versions of the kernels run only where the caller asks for the CPU.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

from .factory import (compute_dtype, create_model, init_weights, load_weights, model_config,
                      param_dtype)
from .models import ColXLIP
from .training.checkpoint import load_native_checkpoint

logger = logging.getLogger(__name__)


def resolve_device(name: str) -> torch.device:
    """``--device``: the device, or a RuntimeError for a CUDA device on a
    machine without one."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run the plain versions on the CPU)")
    return device


def load_model(model_name: str, checkpoint: Optional[str], device: torch.device, *,
               precision: str = "bf16", seed: int = 0) -> Tuple[torch.nn.Module, object]:
    """(model in eval mode on ``device``, cfg). ``checkpoint`` is a checkpoint
    directory of the port (whole or sharded, read whole) or an
    OpenCLIP-layout ``.pt``; None keeps the seeded random init, with a
    warning."""
    model, cfg = create_model(model_name, device, compute_dtype(precision), seed=seed,
                              param_dtype=param_dtype(precision))
    if checkpoint is None:
        logger.warning("random-init weights (no --checkpoint)")
    elif os.path.isdir(checkpoint):
        state = load_native_checkpoint(checkpoint)["state"]["state_dict"]
        model.load_state_dict(state, strict=True)
    else:
        load_weights(model, checkpoint)
    return model.eval(), cfg


def colxlip_model(model_name: str, device: torch.device, *, precision: str = "bf16",
                  seed: int = 0, checkpoint: Optional[str] = None) -> ColXLIP:
    """A ColXLIP model (the token heads) on any registered config, as the
    JAX drives build one (``ColXLIP(CLIPCfg.from_dict(get_model_config(
    name)))``), in train mode on ``device`` with fp32 parameters and
    ``precision``'s compute dtype: the seeded random init, or the weights of
    an OpenCLIP-layout ``checkpoint``."""
    model = ColXLIP(model_config(model_name), dtype=compute_dtype(precision))
    with torch.no_grad():
        init_weights(model, torch.Generator(device="cpu").manual_seed(seed))
    model = model.to(device)
    if checkpoint is not None:
        load_weights(model, checkpoint)
    return model.train()
