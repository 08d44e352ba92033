"""ColXLIP loss: port of ``colxlip_tpu/losses/colclip.py``.

    total = alpha * CE(global logits) + (1 - alpha) * CE(token MaxSim logits)

The token logits are ``logit_scale * maxsim(T, I)`` through ``ops.maxsim``
(the MaxSim kernels on the card, forward and backward; ``maxsim_impl``
'streaming_int8' takes the int8 forward with the same backward);
``logit_bias`` applies to the global logits only.

``axis_name`` is None (one device) or the data-parallel group
(``parallel/mesh.py``). Three distributed branches, as in JAX:

- full mode: gather pooled and token features (and the 'valid' text mask)
  and compute the whole [N, N] matrices on every rank;
- ``local_loss`` with ``token_dist='gather'``: this rank's [b, N] rows of
  both directions, ``maxsim(T_local, I_global)`` and
  ``maxsim(T_global, I_local).T``, labels offset by ``rank * b``;
- ``local_loss`` with ``token_dist='ring'``: the same rows computed block by
  block while the other side's token blocks rotate around the ranks
  (``_ring_maxsim_rows``); ``token_neighborhood`` K caps the rotation to K
  blocks, and the token labels become the slot-0 diagonal.

At one device ``local_loss`` and ``token_dist='ring'`` change nothing, as in
JAX; ``token_neighborhood`` without ``token_dist='ring'`` raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from ..ops import maxsim as maxsim_ops
from ..ops.maxsim import maxsim
from ..parallel.collectives import gather_features, gather_pair, shift_rows
from ..parallel.mesh import AxisName, resolve_group
from .clip import contrastive_labels, cross_entropy_with_integer_labels, matmul_t


class _RingMaxSimRows(torch.autograd.Function):
    """The [b_rows, steps * b_block] MaxSim rows of one direction of the ring,
    forward and backward in one function, so that the backward's reverse
    ring runs its shifts in one fixed order on every rank.

    Forward: the s = 0 block from the local tensors, then steps - 1 shifts of
    the rotating side (and of its text mask), one block after each. Every
    received block is kept for the backward, as the JAX scan keeps its
    residuals. Backward: the blocks' MaxSim backward from the last to the
    first; the rotating side's gradient is accumulated and shifted back once
    between blocks (steps - 1 reverse shifts), so it lands on the rank that
    sent it. Without ``rot_grad`` (``gather_with_grad=False``) the rotating
    side gets no gradient and the backward sends nothing."""

    @staticmethod
    def forward(ctx, local, rotating, text_mask, group, transpose, steps, capped, shift,
                mask_mode, impl, rot_grad):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        b_block = rotating.shape[0]
        local_mask = None if transpose else text_mask
        rot, rot_mask = rotating, (text_mask if transpose else None)
        cols = torch.zeros((local.shape[0], steps * b_block), dtype=torch.float32,
                           device=local.device)
        blocks, slots = [], []
        for s in range(steps):
            if s:
                rot = shift_rows(rot, group, shift)
                if rot_mask is not None:
                    rot_mask = shift_rows(rot_mask, group, shift)
            # capped layout: slot s; full ring: the owner's global column block
            slot = s if capped else (r - s * shift) % n
            if transpose:
                block = maxsim_ops._forward(rot, local, mask_mode, rot_mask, impl).T
            else:
                block = maxsim_ops._forward(local, rot, mask_mode, local_mask, impl)
            cols[:, slot * b_block:(slot + 1) * b_block] = block
            blocks.append((rot, rot_mask))
            slots.append(slot)
        ctx.save_for_backward(local)
        ctx.blocks, ctx.slots, ctx.local_mask = blocks, slots, local_mask
        ctx.group, ctx.transpose, ctx.shift = group, transpose, shift
        ctx.mask_mode, ctx.rot_grad, ctx.b_block = mask_mode, rot_grad, b_block
        return cols

    @staticmethod
    def backward(ctx, dcols):
        (local,) = ctx.saved_tensors
        b = ctx.b_block
        d_local = torch.zeros(local.shape, dtype=torch.float32, device=local.device)
        d_rot = None
        for s in reversed(range(len(ctx.blocks))):
            rot, rot_mask = ctx.blocks[s]
            g = dcols[:, ctx.slots[s] * b:(ctx.slots[s] + 1) * b]
            if ctx.transpose:
                dr, dl = maxsim_ops._backward(rot, local, g.T.contiguous(), ctx.mask_mode,
                                              rot_mask)
            else:
                dl, dr = maxsim_ops._backward(local, rot, g.contiguous(), ctx.mask_mode,
                                              ctx.local_mask)
            d_local += dl.float()
            if ctx.rot_grad:
                d_rot = dr.float() if d_rot is None else d_rot + dr.float()
                if s:
                    d_rot = shift_rows(d_rot, ctx.group, -ctx.shift)
        ctx.blocks = None
        d_rot = None if d_rot is None else d_rot.to(local.dtype)
        return (d_local.to(local.dtype), d_rot) + (None,) * 9


def _ring_maxsim_rows(token_q: torch.Tensor, token_k_local: torch.Tensor,
                      axis_name: AxisName, *, transpose: bool, maxsim_impl: str,
                      mask_mode: str, gather_with_grad: bool = True,
                      text_mask: Optional[torch.Tensor] = None,
                      ring_steps: Optional[int] = None) -> torch.Tensor:
    """[b_q, N_global] MaxSim rows computed blockwise over a ring of ranks:
    key blocks rotate and each rank holds one remote block at a time (and,
    for the backward, every block it received), never the gathered token
    tensors.

    transpose=False: rows = maxsim(local queries, rotating key blocks).
    transpose=True : rows = maxsim(rotating query blocks, local keys).T, the
    image-row direction, where the texts (and their 'valid' mask) rotate.

    ``ring_steps`` K below the group size caps the rotation: the rows cover
    the K-rank neighbourhood, the local block at column slot 0 and ring
    neighbour s's block at slot s. The capped transposed direction rotates
    the other way (shift -1), so both directions score the same pair set
    {(t_r, i_{r-s}) : s < K} with the positive at slot 0."""
    group = resolve_group(axis_name)
    n = dist.get_world_size(group)
    steps = n if ring_steps is None else min(ring_steps, n)
    capped = steps < n
    shift = -1 if (capped and transpose) else 1
    local, rotating = (token_k_local, token_q) if transpose else (token_q, token_k_local)
    if maxsim_impl not in maxsim_ops.MAXSIM_IMPLS:
        raise ValueError(f"unknown impl: {maxsim_impl!r} (one of {maxsim_ops.MAXSIM_IMPLS})")
    maxsim_ops._check_args(token_q, token_k_local, mask_mode, text_mask)
    if mask_mode != "valid":
        text_mask = None
    return _RingMaxSimRows.apply(local, rotating, text_mask, group, transpose, steps, capped,
                                 shift, mask_mode, maxsim_impl, gather_with_grad)


def colclip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                 token_image_features: torch.Tensor,
                 token_text_features: torch.Tensor, logit_scale: torch.Tensor, *,
                 alpha: float = 0.5, axis_name: AxisName = None,
                 local_loss: bool = False, gather_with_grad: bool = False,
                 logit_bias: Optional[torch.Tensor] = None,
                 maxsim_impl: str = "auto", mask_mode: str = "nonzero",
                 token_dist: str = "gather", token_neighborhood: int = 0,
                 text_mask: Optional[torch.Tensor] = None, output_dict: bool = True
                 ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    gkw = dict(axis_name=axis_name, gather_with_grad=gather_with_grad, local_loss=local_loss)
    if token_neighborhood and token_dist != "ring":
        raise ValueError(
            "token_neighborhood requires token_dist='ring' (the cap is a "
            "bounded ring rotation; gather mode always pays the full "
            "global-batch MaxSim)")
    token_labels = None
    mkw = dict(mask_mode=mask_mode, impl=maxsim_impl)

    if axis_name is not None and local_loss:
        all_image, all_text = gather_pair(image_features, text_features, **gkw)
        logits_per_image = logit_scale * matmul_t(image_features, all_text)
        logits_per_text = logit_scale * matmul_t(text_features, all_image)
        if token_dist == "ring":
            # blockwise ring: never gathers the token tensors
            steps = token_neighborhood or None
            rkw = dict(maxsim_impl=maxsim_impl, mask_mode=mask_mode,
                       gather_with_grad=gather_with_grad, text_mask=text_mask,
                       ring_steps=steps)
            s_text = _ring_maxsim_rows(token_text_features, token_image_features, axis_name,
                                       transpose=False, **rkw)
            s_image = _ring_maxsim_rows(token_text_features, token_image_features, axis_name,
                                        transpose=True, **rkw)
            if steps is not None and s_text.shape[1] < logits_per_text.shape[1]:
                # capped layout: the positive sits on the slot-0 diagonal
                token_labels = torch.arange(s_text.shape[0], device=s_text.device)
        else:
            all_tok_image = gather_features(token_image_features, **gkw)
            all_tok_text = gather_features(token_text_features, **gkw)
            all_text_mask = (gather_features(text_mask, **gkw)
                             if text_mask is not None else None)
            # rows for the local texts over all images, and columns for the
            # local images over all texts, transposed into rows
            s_text = maxsim(token_text_features, all_tok_image, text_mask=text_mask, **mkw)
            s_image = maxsim(all_tok_text, token_image_features, text_mask=all_text_mask,
                             **mkw).T
        logits_per_text_token = logit_scale * s_text
        logits_per_image_token = logit_scale * s_image
    else:
        if axis_name is not None:
            image_features, text_features = gather_pair(image_features, text_features, **gkw)
            token_image_features = gather_features(token_image_features, **gkw)
            token_text_features = gather_features(token_text_features, **gkw)
            text_mask = (gather_features(text_mask, **gkw)
                         if text_mask is not None else None)
        logits_per_image = logit_scale * matmul_t(image_features, text_features)
        logits_per_text = logits_per_image.T
        s = maxsim(token_text_features, token_image_features, text_mask=text_mask, **mkw)
        logits_per_text_token = logit_scale * s
        logits_per_image_token = logits_per_text_token.T

    if logit_bias is not None:
        logits_per_image = logits_per_image + logit_bias
        logits_per_text = logits_per_text + logit_bias

    labels = contrastive_labels(logits_per_image.shape[0], device=logits_per_image.device,
                                axis_name=axis_name, local_loss=local_loss)
    if token_labels is None:
        token_labels = labels
    global_contrastive_loss = (
        cross_entropy_with_integer_labels(logits_per_image, labels)
        + cross_entropy_with_integer_labels(logits_per_text, labels)) / 2
    token_contrastive_loss = (
        cross_entropy_with_integer_labels(logits_per_image_token, token_labels)
        + cross_entropy_with_integer_labels(logits_per_text_token, token_labels)) / 2
    total = alpha * global_contrastive_loss + (1 - alpha) * token_contrastive_loss
    if output_dict:
        return {"global_contrastive_loss": global_contrastive_loss,
                "token_contrastive_loss": token_contrastive_loss,
                "total_loss": total}
    return total
