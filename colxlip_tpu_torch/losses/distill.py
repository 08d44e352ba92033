"""Distillation loss: port of ``colxlip_tpu/losses/distill.py``.

    contrastive = (CE(logits_per_image) + CE(logits_per_text)) / 2
    distill = (soft_CE(teacher rows, student rows), both directions) / 2

where soft_CE(t, s) = -(softmax(t) * log_softmax(s)).sum(1).mean(0) in fp32.
The teacher's logits come from its features under the same gathering as
the student's (``clip_logits``: ``axis_name``, ``local_loss``,
``gather_with_grad``), detached: no gradient reaches the teacher.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from ..parallel.mesh import AxisName
from .clip import clip_logits, contrastive_labels, cross_entropy_with_integer_labels


def _soft_ce(teacher_logits: torch.Tensor, student_logits: torch.Tensor) -> torch.Tensor:
    t = torch.softmax(teacher_logits.float(), dim=1)
    s = torch.log_softmax(student_logits.float(), dim=1)
    return -(t * s).sum(dim=1).mean()


def distill_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                      logit_scale: torch.Tensor, dist_image_features: torch.Tensor,
                      dist_text_features: torch.Tensor, dist_logit_scale: torch.Tensor, *,
                      axis_name: AxisName = None, local_loss: bool = False,
                      gather_with_grad: bool = False, output_dict: bool = False
                      ) -> Union[Tuple[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    kw = dict(axis_name=axis_name, local_loss=local_loss, gather_with_grad=gather_with_grad)
    logits_per_image, logits_per_text = clip_logits(
        image_features, text_features, logit_scale, **kw)
    dist_logits_per_image, dist_logits_per_text = clip_logits(
        dist_image_features.detach(), dist_text_features.detach(),
        dist_logit_scale.detach(), **kw)
    labels = contrastive_labels(logits_per_image.shape[0], device=logits_per_image.device,
                                axis_name=axis_name, local_loss=local_loss)
    contrastive_loss = (cross_entropy_with_integer_labels(logits_per_image, labels)
                        + cross_entropy_with_integer_labels(logits_per_text, labels)) / 2
    distill_loss = (_soft_ce(dist_logits_per_image, logits_per_image)
                    + _soft_ce(dist_logits_per_text, logits_per_text)) / 2
    if output_dict:
        return {"contrastive_loss": contrastive_loss, "distill_loss": distill_loss}
    return contrastive_loss, distill_loss
