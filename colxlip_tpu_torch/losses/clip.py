"""Global-batch InfoNCE (CLIP) loss: port of ``colxlip_tpu/losses/clip.py``.

``axis_name`` is None (one device) or the data-parallel group
(``parallel/mesh.py``; the name ``'data'`` or a process group):

- full-logits mode: every rank computes the identical [N, N] logit matrix
  from the gathered features; gradients reach only the local shard unless
  ``gather_with_grad``;
- ``local_loss``: each rank keeps its own [b, N] logit rows, labels offset
  by ``rank * b``. At one device ``local_loss`` changes nothing, as in JAX.

The cross-entropy runs in fp32 via logsumexp whatever the feature dtype.
``ce_impl='fused'`` streams both directions through ``ops/fused_ce.py``
(the CUDA kernels on the card) with the same rows, columns and labels, so
no [rows, N] logit matrix is ever held.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..ops.fused_ce import fused_contrastive_ce
from ..parallel.collectives import gather_pair, rank_offset
from ..parallel.mesh import AxisName


def cross_entropy_with_integer_labels(logits: torch.Tensor,
                                      labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over rows in fp32 (torch F.cross_entropy semantics)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - true_logit).mean()


def contrastive_labels(num_logits: int, *, device: Union[str, torch.device],
                       axis_name: AxisName = None,
                       local_loss: bool = False) -> torch.Tensor:
    """arange labels on ``device``, which the caller names (the logits'
    device; there is no default), offset by ``rank * num_logits`` in
    local-loss mode."""
    labels = torch.arange(num_logits, device=device)
    if axis_name is not None and local_loss:
        labels = labels + rank_offset(num_logits, axis_name)
    return labels


def matmul_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T in fp32, as the JAX einsum with preferred_element_type=fp32."""
    return torch.matmul(a.float(), b.float().T)


def contrastive_operands(image_features: torch.Tensor, text_features: torch.Tensor, *,
                         axis_name: AxisName, local_loss: bool, gather_with_grad: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(image rows, text columns, text rows, image columns) of the two
    directions: local rows against gathered columns in local-loss mode, the
    gathered batch both ways in full mode, the local batch at one device."""
    if axis_name is None:
        return image_features, text_features, text_features, image_features
    all_image, all_text = gather_pair(image_features, text_features, axis_name=axis_name,
                                      gather_with_grad=gather_with_grad,
                                      local_loss=local_loss)
    if local_loss:
        return image_features, all_text, text_features, all_image
    return all_image, all_text, all_text, all_image


def clip_logits(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, *, axis_name: AxisName = None,
                local_loss: bool = False, gather_with_grad: bool = False,
                logit_bias: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits_per_image, logits_per_text), fp32."""
    rows_i, cols_t, rows_t, cols_i = contrastive_operands(
        image_features, text_features, axis_name=axis_name, local_loss=local_loss,
        gather_with_grad=gather_with_grad)
    logits_per_image = logit_scale * matmul_t(rows_i, cols_t)
    if axis_name is not None and local_loss:
        logits_per_text = logit_scale * matmul_t(rows_t, cols_i)
    else:
        logits_per_text = logits_per_image.T
    if logit_bias is not None:
        logits_per_image = logits_per_image + logit_bias
        logits_per_text = logits_per_text + logit_bias
    return logits_per_image, logits_per_text


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, *, axis_name: AxisName = None,
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
        rows_i, cols_t, rows_t, cols_i = contrastive_operands(
            image_features, text_features, axis_name=axis_name, local_loss=local_loss,
            gather_with_grad=gather_with_grad)
        labels = contrastive_labels(rows_i.shape[0], device=rows_i.device,
                                    axis_name=axis_name, local_loss=local_loss)
        total = (fused_contrastive_ce(rows_i, cols_t, labels, logit_scale)
                 + fused_contrastive_ce(rows_t, cols_i, labels, logit_scale)) / 2
        return {"total_loss": total} if output_dict else total
    if ce_impl != "dense":
        raise ValueError(f"unknown ce_impl: {ce_impl!r}")
    logits_per_image, logits_per_text = clip_logits(
        image_features, text_features, logit_scale, axis_name=axis_name,
        local_loss=local_loss, gather_with_grad=gather_with_grad,
        logit_bias=logit_bias)
    labels = contrastive_labels(logits_per_image.shape[0], device=logits_per_image.device,
                                axis_name=axis_name, local_loss=local_loss)
    total = (cross_entropy_with_integer_labels(logits_per_image, labels)
             + cross_entropy_with_integer_labels(logits_per_text, labels)) / 2
    return {"total_loss": total} if output_dict else total
