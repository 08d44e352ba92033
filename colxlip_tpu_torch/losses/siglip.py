"""SigLIP pairwise sigmoid loss with exchanged negatives: port of
``colxlip_tpu/losses/siglip.py``.

    loss = -sum(logsigmoid(labels * (scale * I T^T + bias))) / b

with labels +1 on the diagonal and -1 elsewhere. ``axis_name`` is None (one
device) or the data-parallel group (``parallel/mesh.py``); across ranks each
rank adds the negative-only term of every other rank's text block, which
reaches it by one of four exchanges (``dist_impl``), as in JAX:

- 'bidir': both ring directions a round, (W - 1) // 2 rounds, the +1
  direction's block added before the -1 one's; an odd W - 1 shifts the +1
  side once more;
- 'shift': one direction, W - 1 shifts;
- 'reduce': rank i's text broadcast by an all-reduce of the masked copies;
- 'gather': one stacked all-gather of every rank's text.

'reduce' and 'gather' compute this rank's own block too and multiply it by
0, as the JAX function does. Every exchange is differentiable: the ring
shifts send their gradients back, the all-reduce all-reduces its
cotangent (psum's transpose) and the all-gather sum-scatters it. The logits
are fp32 whatever the feature dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_gather_stacked, all_reduce_sum, axis_rank, ring_shift
from ..parallel.mesh import AxisName, resolve_group
from .clip import matmul_t

DIST_IMPLS = ("bidir", "shift", "reduce", "gather")


def _pairwise_sigmoid_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                           logit_scale: torch.Tensor, logit_bias: Optional[torch.Tensor],
                           *, negative_only: bool = False) -> torch.Tensor:
    """-sum(logsigmoid(labels * logits)) / b, labels -1 off the diagonal and
    +1 on it (-1 everywhere with ``negative_only``)."""
    logits = logit_scale * matmul_t(image_features, text_features)
    if logit_bias is not None:
        logits = logits + logit_bias
    b = image_features.shape[0]
    labels = -torch.ones((b, b), dtype=logits.dtype, device=logits.device)
    if not negative_only:
        labels = labels + 2 * torch.eye(b, dtype=logits.dtype, device=logits.device)
    return -F.logsigmoid(labels * logits).sum() / b


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: Optional[torch.Tensor] = None, *,
                axis_name: AxisName = None, dist_impl: str = "bidir",
                output_dict: bool = False) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    loss = _pairwise_sigmoid_loss(image_features, text_features, logit_scale, logit_bias)
    group = resolve_group(axis_name)
    world = 1 if group is None else torch.distributed.get_world_size(group)

    def negatives(t: torch.Tensor) -> torch.Tensor:
        return _pairwise_sigmoid_loss(image_features, t, logit_scale, logit_bias,
                                      negative_only=True)

    if world > 1:
        if dist_impl == "bidir":
            t_left = t_right = text_features
            num_bidir, remainder = divmod(world - 1, 2)
            for _ in range(num_bidir):
                t_left = ring_shift(t_left, group, -1)
                t_right = ring_shift(t_right, group, +1)
                for f in (t_right, t_left):
                    loss = loss + negatives(f)
            if remainder:
                loss = loss + negatives(ring_shift(t_right, group, +1))
        elif dist_impl == "shift":
            t = text_features
            for _ in range(world - 1):
                t = ring_shift(t, group, +1)
                loss = loss + negatives(t)
        elif dist_impl == "reduce":
            rank = axis_rank(group)
            for i in range(world):
                t_from_i = all_reduce_sum(text_features * float(rank == i), group)
                loss = loss + float(i != rank) * negatives(t_from_i)
        elif dist_impl == "gather":
            rank = axis_rank(group)
            all_text = all_gather_stacked(text_features, group)
            for i in range(world):
                loss = loss + float(i != rank) * negatives(all_text[i])
        else:
            raise ValueError(f"unknown dist_impl: {dist_impl!r}")
    return {"contrastive_loss": loss} if output_dict else loss
