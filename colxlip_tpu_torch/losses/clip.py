"""Global-batch InfoNCE (CLIP) loss: port of ``colxlip_tpu/losses/clip.py``.

Single device only: every ``axis_name`` (the JAX package's gather over the
data mesh axis) and ``ce_impl='fused'`` (the Pallas streaming-logsumexp
kernels #11-13, ``ops/fused_ce.py``) raise ``NotImplementedError``. The
cross-entropy runs in fp32 via logsumexp whatever the feature dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch


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


def contrastive_labels(num_logits: int, *, axis_name: Optional[str] = None,
                       local_loss: bool = False,
                       device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """arange labels (the rank offset of local-loss mode is not ported)."""
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
    """Symmetric InfoNCE over the dense logit matrix."""
    if ce_impl == "fused":
        raise NotImplementedError("clip_loss: ce_impl='fused' (the streaming "
                                  "CE kernels) is not yet ported")
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
