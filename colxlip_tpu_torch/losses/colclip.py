"""ColXLIP loss: port of ``colxlip_tpu/losses/colclip.py``, single device.

    total = alpha * CE(global logits) + (1 - alpha) * CE(token MaxSim logits)

The token logits are ``logit_scale * maxsim(T, I)`` through ``ops.maxsim``
(the MaxSim kernels on the card, forward and backward; ``maxsim_impl``
'streaming_int8' takes the int8 forward with the same backward); ``logit_bias``
applies to the global logits only. The distributed branches of the JAX
function (full gather, local loss, the token ring and its neighbourhood cap)
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..ops.maxsim import maxsim
from .clip import contrastive_labels, cross_entropy_with_integer_labels, matmul_t


def colclip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                 token_image_features: torch.Tensor,
                 token_text_features: torch.Tensor, logit_scale: torch.Tensor, *,
                 alpha: float = 0.5, axis_name: Optional[str] = None,
                 local_loss: bool = False, gather_with_grad: bool = False,
                 logit_bias: Optional[torch.Tensor] = None,
                 maxsim_impl: str = "auto", mask_mode: str = "nonzero",
                 token_dist: str = "gather", token_neighborhood: int = 0,
                 text_mask: Optional[torch.Tensor] = None, output_dict: bool = True
                 ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    if axis_name is not None or local_loss or token_dist != "gather" or token_neighborhood:
        raise NotImplementedError(
            "colclip_loss: the distributed branches (axis_name, local_loss, "
            "token_dist='ring', token_neighborhood) are not yet ported")
    logits_per_image = logit_scale * matmul_t(image_features, text_features)
    logits_per_text = logits_per_image.T
    s = maxsim(token_text_features, token_image_features, mask_mode=mask_mode,
               text_mask=text_mask, impl=maxsim_impl)
    logits_per_text_token = logit_scale * s
    logits_per_image_token = logits_per_text_token.T
    if logit_bias is not None:
        logits_per_image = logits_per_image + logit_bias
        logits_per_text = logits_per_text + logit_bias

    labels = contrastive_labels(logits_per_image.shape[0],
                                device=logits_per_image.device)
    global_contrastive_loss = (
        cross_entropy_with_integer_labels(logits_per_image, labels)
        + cross_entropy_with_integer_labels(logits_per_text, labels)) / 2
    token_contrastive_loss = (
        cross_entropy_with_integer_labels(logits_per_image_token, labels)
        + cross_entropy_with_integer_labels(logits_per_text_token, labels)) / 2
    total = alpha * global_contrastive_loss + (1 - alpha) * token_contrastive_loss
    if output_dict:
        return {"global_contrastive_loss": global_contrastive_loss,
                "token_contrastive_loss": token_contrastive_loss,
                "total_loss": total}
    return total
