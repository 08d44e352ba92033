"""Retrieval scoring: port of ``score_similarity`` from
``colxlip_tpu/training/evaluate.py``.

Takes the features where they are: on the card, the token features go
straight from the towers to the MaxSim kernel (``ops.maxsim``) without a trip
through host memory. The rest of the eval harness (R@k, zero-shot) is not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.maxsim import maxsim


def score_similarity(img_feats: torch.Tensor, txt_feats: torch.Tensor,
                     img_tokens: Optional[torch.Tensor],
                     txt_tokens: Optional[torch.Tensor], logit_scale: float,
                     scoring: str = "global", alpha: float = 0.5,
                     mask_mode: str = "nonzero",
                     text_mask: Optional[torch.Tensor] = None,
                     maxsim_impl: str = "auto") -> torch.Tensor:
    """[num_images, num_texts] float32 similarity: 'global' (scaled cosine of
    the pooled features), 'maxsim' (scaled MaxSim of the token features,
    through ``maxsim_impl``) or 'mixed' (alpha * global + (1 - alpha) *
    maxsim)."""
    if scoring not in ("global", "maxsim", "mixed"):
        raise ValueError(f"unknown scoring: {scoring!r}")
    if scoring in ("global", "mixed"):
        global_sim = logit_scale * (img_feats.float() @ txt_feats.float().T)
        if scoring == "global":
            return global_sim
    if img_tokens is None or txt_tokens is None:
        raise ValueError(f"scoring={scoring!r} needs token features")
    s_t2i = maxsim(txt_tokens.float().contiguous(), img_tokens.float().contiguous(),
                   mask_mode=mask_mode, text_mask=text_mask,
                   impl=maxsim_impl)  # [n_txt, n_img]
    token_sim = logit_scale * s_t2i.T
    if scoring == "maxsim":
        return token_sim
    return alpha * global_sim + (1 - alpha) * token_sim
