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
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple, Union

import torch
from torch import nn

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
    """fp32 sqrt of the sum of squares (optax.global_norm on fp32 leaves)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` preceded by optax's global-norm clip."""

    def __init__(self, groups, *, grad_clip_norm: Optional[float] = None, **kwargs):
        super().__init__(groups, **kwargs)
        self.grad_clip_norm = grad_clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_clip_norm is not None:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            norm = global_norm(grads)
            # optax.clip_by_global_norm: g * max / norm where norm > max
            scale = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            torch._foreach_mul_(grads, scale)
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
