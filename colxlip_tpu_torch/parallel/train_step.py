"""One optimizer step of the dual-tower model: port of
``colxlip_tpu/parallel/train_step.py``.

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
accumulation and adds its gradients. The bank holds the outputs whose
leading dimension is the microbatch, never the weights and scalars of
``_NON_BATCH_OUTPUTS`` (``caption_head_kernel`` is [D, V], whatever D is).
With ``packed_feed=(img_shape, ctx)`` the step takes ``(buf, None)``, one
``data_feed.pack_batch`` buffer, and unpacks it on the device first. A model
with ``patch_dropout > 0`` raises ``NotImplementedError`` (the JAX step
cannot run one).

``mesh`` (the data-parallel group of ``parallel/mesh.py``, or its name
``'data'``) is the JAX ``shard_map`` over the data axis, one rank a
device: each rank feeds its own rows of the global batch, the loss gathers
across the group, and after the backward (after the last microbatch) the
gradients and then the losses are averaged over the group (the JAX
``pmean``: one coalesced all-reduce a dtype) before the global-norm clip,
``grad_norm`` and AdamW. At construction the parameters are broadcast from
rank 0 (the JAX ``replicate_state``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..losses import clip_loss, coca_loss, colclip_loss, distill_clip_loss, siglip_loss
from ..models.layers import PatchDropout
from .data_feed import unpack_batch
from ..training.optim import global_norm
from .mesh import AxisName, resolve_group

MAX_LOGIT_SCALE = math.log(100.0)
# model outputs that are parameters or scalars, never per-sample rows: the
# accumulation splice does not cache them, even where a leading dimension
# equals the microbatch
_NON_BATCH_OUTPUTS = frozenset(
    {"logit_scale", "logit_bias", "dist_logit_scale", "caption_head_kernel"})


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    loss_type: str = "colclip"            # 'clip' | 'colclip' | 'siglip' | 'coca' | 'distill'
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


def compute_loss(out: Dict[str, torch.Tensor], cfg: TrainStepConfig,
                 axis_name: AxisName = None) -> Metrics:
    """Dispatch on the loss type."""
    if cfg.loss_type == "colclip":
        return colclip_loss(
            out["image_features"], out["text_features"],
            out["token_image_features"], out["token_text_features"],
            out["logit_scale"], alpha=cfg.alpha, axis_name=axis_name,
            local_loss=cfg.local_loss, gather_with_grad=cfg.gather_with_grad,
            logit_bias=out.get("logit_bias"),
            maxsim_impl=cfg.maxsim_impl, mask_mode=cfg.mask_mode,
            token_dist=cfg.token_dist, token_neighborhood=cfg.token_neighborhood,
            text_mask=out.get("text_mask"), output_dict=True)
    if cfg.loss_type == "clip":
        total = clip_loss(
            out["image_features"], out["text_features"], out["logit_scale"],
            axis_name=axis_name, local_loss=cfg.local_loss,
            gather_with_grad=cfg.gather_with_grad, logit_bias=out.get("logit_bias"),
            ce_impl=cfg.ce_impl)
        return {"total_loss": total}
    if cfg.loss_type == "coca":
        d = coca_loss(
            out["image_features"], out["text_features"], out.get("logits"), out["labels"],
            out["logit_scale"], caption_loss_weight=cfg.coca_caption_loss_weight,
            clip_loss_weight=cfg.coca_contrastive_loss_weight, axis_name=axis_name,
            local_loss=cfg.local_loss, gather_with_grad=cfg.gather_with_grad,
            output_dict=True, ce_impl=cfg.ce_impl, caption_hidden=out.get("caption_hidden"),
            caption_head_kernel=out.get("caption_head_kernel"))
        return {"contrastive_loss": d["contrastive_loss"], "caption_loss": d["caption_loss"],
                "total_loss": d["contrastive_loss"] + d["caption_loss"]}
    if cfg.loss_type == "distill":
        contrastive, distill = distill_clip_loss(
            out["image_features"], out["text_features"], out["logit_scale"],
            out["dist_image_features"], out["dist_text_features"], out["dist_logit_scale"],
            axis_name=axis_name, local_loss=cfg.local_loss,
            gather_with_grad=cfg.gather_with_grad)
        return {"contrastive_loss": contrastive, "distill_loss": distill,
                "total_loss": contrastive + distill}
    if cfg.loss_type == "siglip":
        total = siglip_loss(out["image_features"], out["text_features"], out["logit_scale"],
                            out.get("logit_bias"), axis_name=axis_name,
                            dist_impl=cfg.dist_impl)
        return {"total_loss": total}
    raise ValueError(f"unknown loss_type: {cfg.loss_type!r}")


def build_forward(model: nn.Module, cfg: TrainStepConfig,
                  teacher: Optional[nn.Module] = None) -> Callable:
    """forward(images, texts) -> the model's output dict, plus the teacher's
    detached features for distillation and the 'valid' text mask (positions
    strictly before the EOT argmax) for that mask mode. A CoCa model under
    ``ce_impl='fused'`` is asked for no dense caption logits."""
    kw = {"logits": False} if cfg.loss_type == "coca" and cfg.ce_impl == "fused" else {}

    def forward(images: torch.Tensor, texts: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = model(images, texts, **kw)
        if teacher is not None:
            with torch.no_grad():
                t_out = teacher(images, texts)
            out["dist_image_features"] = t_out["image_features"]
            out["dist_text_features"] = t_out["text_features"]
            out["dist_logit_scale"] = t_out["logit_scale"]
        if cfg.mask_mode == "valid" and "token_text_features" in out:
            eot = texts.argmax(dim=-1)
            positions = torch.arange(texts.shape[1], device=texts.device)
            out["text_mask"] = (positions[None, :] < eot[:, None]).float()
        return out
    return forward


def _coalesced(tensors: List[torch.Tensor], collective: Callable[[torch.Tensor], None]
               ) -> None:
    """Run ``collective`` in place once a dtype, on the tensors flattened into
    one buffer, and copy the result back."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        collective(flat)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def all_reduce_mean_(tensors: List[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Average ``tensors`` over ``group`` in place: the sum (gloo has no
    AVG), divided by the group size as a tensor. The divisor is filled on
    the device: ``torch.tensor(n, device='cuda')`` is a host-to-device copy
    that waits for the device, so the host would stop queueing the rest of
    the step."""
    def mean(flat: torch.Tensor) -> None:
        dist.all_reduce(flat, group=group)
        flat.div_(torch.full((), dist.get_world_size(group), dtype=flat.dtype,
                             device=flat.device))
    _coalesced(tensors, mean)


@torch.no_grad()
def broadcast_parameters(model: nn.Module, group: dist.ProcessGroup) -> None:
    """Every rank takes rank 0's parameters (the JAX ``replicate_state``)."""
    src = dist.get_global_rank(group, 0)
    _coalesced(list(model.parameters()),
               lambda flat: dist.broadcast(flat, src=src, group=group))


@torch.no_grad()
def clamp_logit_scale(model: nn.Module) -> None:
    """Clamp the logit_scale parameter to [0, ln 100] after the update."""
    model.logit_scale.clamp_(0.0, MAX_LOGIT_SCALE)


class TrainStep:
    """``step(images, texts) -> metrics``; ``step.step`` counts the updates
    made, and ``schedule(step.step)`` is the next update's learning rate."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]], cfg: TrainStepConfig,
                 packed_feed: Optional[Tuple[Tuple[int, ...], int]] = None,
                 group: Optional[dist.ProcessGroup] = None,
                 teacher: Optional[nn.Module] = None):
        if cfg.accum_freq < 1:
            raise ValueError(f"accum_freq must be >= 1; got {cfg.accum_freq}")
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.cfg = cfg
        self.packed_feed = packed_feed
        self.teacher = teacher if teacher is None else teacher.eval()
        self.forward = build_forward(model, cfg, teacher)
        self.group = group
        self.step = 0
        if group is not None:
            broadcast_parameters(model, group)

    def _loss_and_grads(self, images, texts):
        out = self.forward(images, texts)
        losses = compute_loss(out, self.cfg, self.group)
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
        b = ims[0].shape[0]
        batched = [k for k, v in cached[0].items()
                   if k not in _NON_BATCH_OUTPUTS and isinstance(v, torch.Tensor)
                   and v.ndim >= 1 and v.shape[0] == b]
        per_micro = []
        for j in range(n):
            out_j = self.forward(ims[j], txs[j])
            spliced = dict(out_j)
            for k in batched:
                spliced[k] = torch.cat([out_j[k] if i == j else c[k]
                                        for i, c in enumerate(cached)])
            losses = compute_loss(spliced, self.cfg, self.group)
            losses["total_loss"].backward()  # grads add up over microbatches
            per_micro.append({k: v.detach() for k, v in losses.items()})
        losses = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        return losses, cached[0]["logit_scale"]

    def __call__(self, images: torch.Tensor, texts: Optional[torch.Tensor]) -> Metrics:
        if self.packed_feed is not None:
            if texts is not None:
                raise ValueError("a packed_feed step takes (buf, None)")
            images, texts = unpack_batch(images, *self.packed_feed)
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
        if self.group is not None:
            all_reduce_mean_([p.grad for p in params], self.group)
            names = list(metrics)
            stacked = torch.stack([metrics[k].float() for k in names])
            all_reduce_mean_([stacked], self.group)
            metrics = dict(zip(names, stacked.unbind()))
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
                    *, mesh: AxisName = None, packed_feed=None, teacher=None) -> TrainStep:
    """The train step. ``schedule`` (step -> lr) sets each update's learning
    rate; None keeps the optimizer's. ``mesh``: None (one device) or the
    data-parallel group (or its name ``'data'``). ``packed_feed``:
    (per-sample image shape, ctx) of the packed buffers the step takes.
    ``teacher``: the distillation teacher (``loss_type='distill'``), a model
    whose forward returns ``image_features``, ``text_features`` and
    ``logit_scale``."""
    if any(isinstance(m, PatchDropout) and m.prob > 0 for m in model.modules()):
        # the JAX step applies the model with train=True and no rngs, so its
        # PatchDropout raises flax InvalidRngError: the step has no draw to port
        raise NotImplementedError(
            "make_train_step: vision_cfg.patch_dropout > 0 is refused: the JAX train step "
            "passes no 'patch_dropout' rng and raises InvalidRngError, so there is no "
            "seeded draw to reproduce (PatchDropout itself is ported: models/layers.py)")
    return TrainStep(model, optimizer, schedule, cfg, packed_feed=packed_feed,
                     group=resolve_group(mesh), teacher=teacher)
