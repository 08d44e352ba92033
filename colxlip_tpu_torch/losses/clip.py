"""Global-batch InfoNCE (CLIP) loss: port of ``colxlip_tpu/losses/clip.py``.

Single device only: every ``axis_name`` (the JAX package's gather over the
data mesh axis) raises ``NotImplementedError``. The cross-entropy runs in
fp32 via logsumexp whatever the feature dtype. ``ce_impl='fused'`` streams
both directions through ``ops/fused_ce.py`` (the CUDA kernels on the card),
so no [N, N] logit matrix is ever held.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..ops.fused_ce import fused_contrastive_ce


def _single_device(axis_name: Optional[str], what: str) -> None:
    if axis_name is not None:
        raise NotImplementedError(f"{what}: axis_name={axis_name!r} (the "
                                  "distributed gather) is not yet ported")


def cross_entropy_with_integer_labels(logits: torch.Tensor,
                                      labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over rows in fp32 (torch F.cross_entropy semantics)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - true_logit).mean()


def contrastive_labels(num_logits: int, *, device: Union[str, torch.device],
                       axis_name: Optional[str] = None,
                       local_loss: bool = False) -> torch.Tensor:
    """arange labels on ``device``, which the caller names (the logits'
    device; there is no default). The rank offset of local-loss mode is not
    ported."""
    _single_device(axis_name, "contrastive_labels")
    return torch.arange(num_logits, device=device)


def matmul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T in fp32, as the JAX einsum with preferred_element_type=fp32."""
    return torch.matmul(a.float(), b.float().T)


def clip_logits(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, *, axis_name: Optional[str] = None,
                local_loss: bool = False, gather_with_grad: bool = False,
                logit_bias: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits_per_image, logits_per_text), fp32."""
    _single_device(axis_name, "clip_logits")
    logits_per_image = logit_scale * matmul_t(image_features, text_features)
    logits_per_text = logits_per_image.T
    if logit_bias is not None:
        logits_per_image = logits_per_image + logit_bias
        logits_per_text = logits_per_text + logit_bias
    return logits_per_image, logits_per_text


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, *, axis_name: Optional[str] = None,
              local_loss: bool = False, gather_with_grad: bool = False,
              logit_bias: Optional[torch.Tensor] = None, ce_impl: str = "dense",
              output_dict: bool = False
              ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE: over the dense logit matrix, or with
    ``ce_impl='fused'`` as two streaming passes (rows image / columns text,
    and the reverse) that never hold it. The fused path takes no
    ``logit_bias``."""
    if ce_impl == "fused":
        if logit_bias is not None:
            raise ValueError("fused CE path does not support logit_bias; "
                             "use the dense path for biased logits")
        _single_device(axis_name, "clip_loss")
        labels = contrastive_labels(image_features.shape[0],
                                    device=image_features.device)
        total = (fused_contrastive_ce(image_features, text_features, labels, logit_scale)
                 + fused_contrastive_ce(text_features, image_features, labels, logit_scale)) / 2
        return {"total_loss": total} if output_dict else total
    if ce_impl != "dense":
        raise ValueError(f"unknown ce_impl: {ce_impl!r}")
    logits_per_image, logits_per_text = clip_logits(
        image_features, text_features, logit_scale, axis_name=axis_name,
        local_loss=local_loss, gather_with_grad=gather_with_grad,
        logit_bias=logit_bias)
    labels = contrastive_labels(logits_per_image.shape[0],
                                device=logits_per_image.device)
    total = (cross_entropy_with_integer_labels(logits_per_image, labels)
             + cross_entropy_with_integer_labels(logits_per_text, labels)) / 2
    return {"total_loss": total} if output_dict else total
