"""Optimizer construction: port of ``colxlip_tpu/training/optim.py``.

``create_optimizer`` returns a ``torch.optim.AdamW`` (beta2 = 0.98 and
eps = 1e-6 by default, the ViT defaults) with two parameter groups from the
JAX decay rule: parameters with ndim < 2, or whose name holds 'bn', 'ln_',
'ln1', 'ln2', 'bias', 'logit_scale' or 'norm', get no weight decay.
torch's AdamW and optax's ``adamw`` make the same update (eps outside the
sqrt of the bias-corrected second moment, decay multiplied by the learning
rate); ``tests/test_torch_train.py`` holds them to it.

``grad_clip_norm`` clips the global norm of the optimizer's gradients before
the update, as ``optax.clip_by_global_norm`` does (scale by max / norm when
norm > max). ``lock_image`` / ``lock_text`` leave the tower's parameters out
of the optimizer: no state, no update, and no share of the clip norm (the
JAX chain's ``optax.masked``). Their gradients are still computed, as in the
JAX step, and still count in the step's ``grad_norm`` metric.

Over sharded state (``parallel/gspmd.py``: DTensor gradients) ``global_norm``
is the norm of the global gradient: each rank sums the squares of its local
shards, a shard replicated over a mesh axis counts once (on the rank at
index 0 of that axis), a plain tensor counts on rank 0 only, and one
all-reduce adds the ranks' sums. The clip scales the local shards.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

_NO_DECAY_TOKENS = ("bn", "ln_", "ln1", "ln2", "bias", "logit_scale", "norm")
# OpenCLIP names of the text tower's parameters (flat on the model)
_TEXT_PREFIXES = ("token_embedding.", "positional_embedding", "transformer.",
                  "ln_final.", "text_projection")


def is_no_decay(name: str, param: torch.Tensor) -> bool:
    """colxlip_tpu/training/optim.py ``_is_no_decay`` on the port's names."""
    return param.ndim < 2 or any(t in name.lower() for t in _NO_DECAY_TOKENS)


def is_frozen(name: str, lock_image: bool, lock_text: bool) -> bool:
    """Under a locked tower: ``visual.*`` for lock_image, the text tower's
    parameters for lock_text (the token heads and logit_scale never)."""
    return ((lock_image and name.startswith("visual."))
            or (lock_text and name.startswith(_TEXT_PREFIXES)))


def param_groups(named_params: Iterable[Tuple[str, nn.Parameter]], weight_decay: float,
                 lock_image: bool = False, lock_text: bool = False) -> List[dict]:
    decay, no_decay = [], []
    for name, p in named_params:
        if is_frozen(name, lock_image, lock_text):
            continue
        (no_decay if is_no_decay(name, p) else decay).append(p)
    groups = [{"params": no_decay, "weight_decay": 0.0},
              {"params": decay, "weight_decay": weight_decay}]
    return [g for g in groups if g["params"]]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """fp32 sqrt of the sum of squares (optax.global_norm on fp32 leaves); of
    the global tensors where some are DTensors."""
    tensors = list(tensors)
    if any(isinstance(t, DTensor) for t in tensors):
        return _sharded_global_norm(tensors)
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def _counted_here(t: DTensor) -> bool:
    """Whether this rank's shard of ``t`` counts: it is at index 0 of every
    mesh axis that replicates ``t``."""
    coord = t.device_mesh.get_coordinate()
    return all(isinstance(pl, Shard) or c == 0 for pl, c in zip(t.placements, coord))


def _sharded_global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    rank_zero = dist.get_rank() == 0
    device = (tensors[0].to_local() if isinstance(tensors[0], DTensor) else tensors[0]).device
    squares = [torch.zeros((), dtype=torch.float32, device=device)]
    for t in tensors:
        if isinstance(t, DTensor):
            if _counted_here(t):
                squares.append(t.to_local().float().square().sum())
        elif rank_zero:
            squares.append(t.float().square().sum())
    total = torch.stack(squares).sum()
    dist.all_reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g * max / norm where norm > max
    (the norm of the global gradient; DTensors scale their local shards)."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([g.to_local() if isinstance(g, DTensor) else g for g in grads], scale)


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` preceded by optax's global-norm clip."""

    def __init__(self, groups, *, grad_clip_norm: Optional[float] = None, **kwargs):
        super().__init__(groups, **kwargs)
        self.grad_clip_norm = grad_clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_clip_norm is not None:
            clip_by_global_norm_([p.grad for g in self.param_groups for p in g["params"]
                                  if p.grad is not None], self.grad_clip_norm)
        return super().step(closure)


def create_optimizer(model: nn.Module, learning_rate: Union[float, Callable[[int], float]],
                     *, beta1: float = 0.9, beta2: float = 0.98, eps: float = 1e-6,
                     weight_decay: float = 0.2, grad_clip_norm: Optional[float] = None,
                     lock_image: bool = False, lock_text: bool = False) -> AdamW:
    """AdamW over ``model``'s trainable parameters. A callable
    ``learning_rate`` (a schedule) sets the initial rate to its value at
    step 0; the train step sets each step's rate from the schedule."""
    lr = learning_rate(0) if callable(learning_rate) else learning_rate
    groups = param_groups(model.named_parameters(), weight_decay, lock_image, lock_text)
    return AdamW(groups, lr=lr, betas=(beta1, beta2), eps=eps,
                 grad_clip_norm=grad_clip_norm)
