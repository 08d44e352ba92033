"""CoCa loss: port of ``colxlip_tpu/losses/coca.py``.

    contrastive = clip_loss_weight * clip_loss(image, text)
    caption = caption_loss_weight * CE(caption logits, labels), pad ignored

``ce_impl='fused'`` with the decoder's hidden states and the vocab head's
kernel streams the caption term through ``ops/vocab_ce.py`` (the [B, L, V]
logits are never held); otherwise it is the masked mean over the dense
``logits``. ``ce_impl`` reaches only the caption term: the contrastive term
is the dense ``clip_loss``, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..ops.vocab_ce import streaming_vocab_ce
from ..parallel.mesh import AxisName
from .clip import clip_loss


def caption_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          ignore_index: int = 0) -> torch.Tensor:
    """Token-level CE over [B, L, V] logits in fp32, the mean over the
    positions whose label is not ``ignore_index``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels[..., None])[..., 0]
    valid = (labels != ignore_index).float()
    return ((lse - true_logit) * valid).sum() / valid.sum().clamp_min(1.0)


def coca_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logits: Optional[torch.Tensor], labels: torch.Tensor,
              logit_scale: torch.Tensor, *, caption_loss_weight: float = 2.0,
              clip_loss_weight: float = 1.0, pad_id: int = 0, axis_name: AxisName = None,
              local_loss: bool = False, gather_with_grad: bool = False,
              output_dict: bool = False, ce_impl: str = "dense",
              caption_hidden: Optional[torch.Tensor] = None,
              caption_head_kernel: Optional[torch.Tensor] = None
              ) -> Union[Tuple[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    if clip_loss_weight:
        contrastive = clip_loss_weight * clip_loss(
            image_features, text_features, logit_scale, axis_name=axis_name,
            local_loss=local_loss, gather_with_grad=gather_with_grad)
    else:
        contrastive = torch.zeros((), dtype=torch.float32, device=image_features.device)
    if ce_impl == "fused" and caption_hidden is not None and caption_head_kernel is not None:
        caption = caption_loss_weight * streaming_vocab_ce(
            caption_hidden, caption_head_kernel, labels, pad_id)
    else:
        caption = caption_loss_weight * caption_cross_entropy(logits, labels,
                                                              ignore_index=pad_id)
    if output_dict:
        return {"contrastive_loss": contrastive, "caption_loss": caption}
    return contrastive, caption
