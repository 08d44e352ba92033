"""One optimizer step of the dual-tower model: port of
``colxlip_tpu/parallel/train_step.py`` on one device.

``make_train_step(model, optimizer, schedule, cfg)`` returns
``step(images, texts) -> metrics``: forward through both towers (the
attention and MaxSim kernels on the card), the loss, the backward (the
kernels' backward halves), an AdamW update at ``schedule(step)``, and the
logit-scale clamp to [0, ln 100]. The metrics are the JAX step's: the
losses, ``logit_scale`` (the exp'd scale the forward used) and the fp32
global ``grad_norm`` of the gradients before clipping.

Precision follows the JAX policy without autocast or a GradScaler: fp32
parameters and optimizer state, bf16 compute where the model's ``dtype``
says so. ``accum_freq > 1`` is gradient accumulation with cached-negative
splicing (the JAX ``microbatched_loss_fn``): pass 1 encodes every
microbatch under ``no_grad``; pass 2 re-encodes each microbatch with
gradients, splices it into the cached bank, takes the loss over the whole
accumulation and adds its gradients. A device mesh, the packed feed and
distillation teachers are not ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..losses import clip_loss, colclip_loss
from ..training.optim import global_norm

MAX_LOGIT_SCALE = math.log(100.0)
# model outputs that are parameters or scalars, never per-sample rows: the
# accumulation splice does not cache them
_NON_BATCH_OUTPUTS = frozenset({"logit_scale", "logit_bias"})


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    loss_type: str = "colclip"            # 'clip' | 'colclip' (others: not ported)
    alpha: float = 0.5
    local_loss: bool = False
    gather_with_grad: bool = False
    accum_freq: int = 1
    maxsim_impl: str = "auto"
    ce_impl: str = "dense"
    token_dist: str = "gather"
    token_neighborhood: int = 0
    mask_mode: str = "nonzero"
    dist_impl: str = "bidir"
    clamp_logit_scale: bool = True
    coca_caption_loss_weight: float = 2.0
    coca_contrastive_loss_weight: float = 1.0


Metrics = Dict[str, torch.Tensor]


def compute_loss(out: Dict[str, torch.Tensor], cfg: TrainStepConfig) -> Metrics:
    """Dispatch on the loss type (``colclip`` and ``clip`` are ported)."""
    if cfg.loss_type == "colclip":
        return colclip_loss(
            out["image_features"], out["text_features"],
            out["token_image_features"], out["token_text_features"],
            out["logit_scale"], alpha=cfg.alpha, local_loss=cfg.local_loss,
            gather_with_grad=cfg.gather_with_grad, logit_bias=out.get("logit_bias"),
            maxsim_impl=cfg.maxsim_impl, mask_mode=cfg.mask_mode,
            token_dist=cfg.token_dist, token_neighborhood=cfg.token_neighborhood,
            text_mask=out.get("text_mask"), output_dict=True)
    if cfg.loss_type == "clip":
        total = clip_loss(
            out["image_features"], out["text_features"], out["logit_scale"],
            local_loss=cfg.local_loss, gather_with_grad=cfg.gather_with_grad,
            logit_bias=out.get("logit_bias"), ce_impl=cfg.ce_impl)
        return {"total_loss": total}
    if cfg.loss_type in ("siglip", "coca", "distill"):
        raise NotImplementedError(f"loss_type={cfg.loss_type!r} is not yet ported")
    raise ValueError(f"unknown loss_type: {cfg.loss_type!r}")


def build_forward(model: nn.Module, cfg: TrainStepConfig) -> Callable:
    """forward(images, texts) -> the model's output dict, plus the 'valid'
    text mask (positions strictly before the EOT argmax) for that mask mode."""
    def forward(images: torch.Tensor, texts: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = model(images, texts)
        if cfg.mask_mode == "valid" and "token_text_features" in out:
            eot = texts.argmax(dim=-1)
            positions = torch.arange(texts.shape[1], device=texts.device)
            out["text_mask"] = (positions[None, :] < eot[:, None]).float()
        return out
    return forward


@torch.no_grad()
def clamp_logit_scale(model: nn.Module) -> None:
    """Clamp the logit_scale parameter to [0, ln 100] after the update."""
    model.logit_scale.clamp_(0.0, MAX_LOGIT_SCALE)


class TrainStep:
    """``step(images, texts) -> metrics``; ``step.step`` counts the updates
    made, and ``schedule(step.step)`` is the next update's learning rate."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]], cfg: TrainStepConfig):
        if cfg.accum_freq < 1:
            raise ValueError(f"accum_freq must be >= 1; got {cfg.accum_freq}")
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.cfg = cfg
        self.forward = build_forward(model, cfg)
        self.step = 0

    def _loss_and_grads(self, images, texts):
        out = self.forward(images, texts)
        losses = compute_loss(out, self.cfg)
        losses["total_loss"].backward()
        return losses, out["logit_scale"]

    def _accumulated_loss_and_grads(self, images, texts):
        n = self.cfg.accum_freq
        if images.shape[0] % n or texts.shape[0] != images.shape[0]:
            raise ValueError(f"batch {images.shape[0]} does not split into "
                             f"accum_freq={n} microbatches")
        ims, txs = images.chunk(n), texts.chunk(n)
        with torch.no_grad():
            cached = [self.forward(im, tx) for im, tx in zip(ims, txs)]
        batched = [k for k, v in cached[0].items()
                   if k not in _NON_BATCH_OUTPUTS and v.ndim >= 1]
        per_micro = []
        for j in range(n):
            out_j = self.forward(ims[j], txs[j])
            spliced = dict(out_j)
            for k in batched:
                spliced[k] = torch.cat([out_j[k] if i == j else c[k]
                                        for i, c in enumerate(cached)])
            losses = compute_loss(spliced, self.cfg)
            losses["total_loss"].backward()  # grads add up over microbatches
            per_micro.append({k: v.detach() for k, v in losses.items()})
        losses = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        return losses, cached[0]["logit_scale"]

    def __call__(self, images: torch.Tensor, texts: torch.Tensor) -> Metrics:
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        if self.cfg.accum_freq > 1:
            losses, logit_scale = self._accumulated_loss_and_grads(images, texts)
        else:
            losses, logit_scale = self._loss_and_grads(images, texts)
        for p in params:
            # the JAX step updates every parameter: one the loss does not
            # reach gets a zero gradient, so AdamW still decays it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["logit_scale"] = logit_scale.detach()
        metrics["grad_norm"] = global_norm(p.grad for p in params)
        if self.schedule is not None:
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        if self.cfg.clamp_logit_scale:
            clamp_logit_scale(self.model)
        self.step += 1
        return metrics


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    schedule: Optional[Callable[[int], float]], cfg: TrainStepConfig,
                    *, mesh=None, packed_feed=None, teacher=None) -> TrainStep:
    """The one-device train step. ``schedule`` (step -> lr) sets each
    update's learning rate; None keeps the optimizer's."""
    for name, value in (("mesh", mesh), ("packed_feed", packed_feed), ("teacher", teacher)):
        if value is not None:
            raise NotImplementedError(f"make_train_step: {name} is not yet ported")
    return TrainStep(model, optimizer, schedule, cfg)
