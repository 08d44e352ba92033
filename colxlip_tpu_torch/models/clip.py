"""CLIP and ColXLIP dual-tower models: port of ``colxlip_tpu/models/clip.py``.

``CLIP``: vision tower + text tower + ``logit_scale`` (+ optional
``logit_bias``). ``ColXLIP`` adds the LN -> Linear -> GELU -> LN token heads
(``vision_token_layer``, ``text_token_layer``); its ``encode_text`` zeroes the
ln_final token features at and after the EOT position BEFORE the token head,
and both encoders return (pooled, token features).

``forward(image, text)`` returns the dict of the JAX ``__call__``:
``logit_scale`` (= exp of the parameter), the l2-normalised pooled features
(and, for ColXLIP, the normalised token features), and ``logit_bias`` when
the model has one. It is what the train step and the losses read.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from .configs import CLIPCfg
from .layers import GELU, LayerNorm, Linear, gelu, gelu_tanh, quick_gelu
from .text import add_text_tower, encode_text_tower
from .vision import VisionTransformer


def _select_act(cfg: CLIPCfg) -> Callable:
    if cfg.quick_gelu:
        return quick_gelu
    return gelu_tanh if cfg.gelu_approximate else gelu


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize in fp32, cast back. The clamp sits INSIDE the sqrt (as in
    the JAX package, where it keeps the gradient finite at zero rows)."""
    x32 = x.float()
    sumsq = x32.square().sum(dim=dim, keepdim=True)
    return (x32 / torch.sqrt(sumsq.clamp_min(eps * eps))).to(x.dtype)


def token_projection_head(width: int, embed_dim: int, *,
                          dtype: torch.dtype) -> nn.Sequential:
    """LN -> Linear -> GELU -> LN, as the Sequential the .pt layout indexes
    (``0`` / ``1`` / ``3``)."""
    return nn.Sequential(LayerNorm(width), Linear(width, embed_dim, dtype=dtype),
                         GELU(), LayerNorm(embed_dim))


class CLIP(nn.Module):
    """Dual-tower contrastive model; ``dtype`` is the compute dtype
    (parameters stay fp32)."""

    def __init__(self, cfg: CLIPCfg, *, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        act = _select_act(cfg)
        self.visual = VisionTransformer(cfg.vision_cfg, cfg.embed_dim, act,
                                        dtype=dtype)
        add_text_tower(self, cfg.text_cfg, cfg.embed_dim, act, dtype=dtype)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.init_logit_scale))
        if cfg.init_logit_bias is not None:
            self.logit_bias = nn.Parameter(torch.tensor(float(cfg.init_logit_bias)))

    def encode_image(self, image: torch.Tensor, normalize: bool = False):
        pooled, _ = self.visual(image)
        return l2_normalize(pooled) if normalize else pooled

    def encode_text(self, text: torch.Tensor, normalize: bool = False):
        pooled, _ = encode_text_tower(self, text, self.dtype)
        return l2_normalize(pooled) if normalize else pooled

    def _scalars(self) -> Dict[str, torch.Tensor]:
        out = {"logit_scale": self.logit_scale.exp()}
        if hasattr(self, "logit_bias"):
            out["logit_bias"] = self.logit_bias
        return out

    def forward(self, image: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """colxlip_tpu/models/clip.py ``CLIP.__call__``: normalised pooled
        features of the towers given, plus ``logit_scale`` / ``logit_bias``."""
        out = self._scalars()
        if image is not None:
            out["image_features"] = self.encode_image(image, normalize=True)
        if text is not None:
            out["text_features"] = self.encode_text(text, normalize=True)
        return out


class ColXLIP(CLIP):
    """CLIP + ColBERT-style token heads."""

    def __init__(self, cfg: CLIPCfg, *, dtype: torch.dtype = torch.bfloat16):
        super().__init__(cfg, dtype=dtype)
        self.vision_token_layer = token_projection_head(
            cfg.vision_cfg.width, cfg.embed_dim, dtype=dtype)
        self.text_token_layer = token_projection_head(
            cfg.text_cfg.width, cfg.embed_dim, dtype=dtype)

    def encode_image(self, image: torch.Tensor, normalize: bool = False):
        """(pooled [B, E], projected patch tokens [B, P, E])."""
        pooled, tokens = self.visual(image)
        tokens = self.vision_token_layer(tokens)
        if normalize:
            pooled, tokens = l2_normalize(pooled), l2_normalize(tokens)
        return pooled, tokens

    def encode_text(self, text: torch.Tensor, normalize: bool = False):
        """(pooled [B, E], projected tokens [B, n, E]); token features at and
        after EOT (argmax id) are zeroed before the token head."""
        pooled, tokens = encode_text_tower(self, text, self.dtype)
        eot = text.argmax(dim=-1)
        positions = torch.arange(text.shape[1], device=text.device)
        keep = positions[None, :] < eot[:, None]
        tokens = tokens.masked_fill(~keep[:, :, None], 0.0)
        tokens = self.text_token_layer(tokens)
        if normalize:
            pooled, tokens = l2_normalize(pooled), l2_normalize(tokens)
        return pooled, tokens

    def forward(self, image: Optional[torch.Tensor] = None,
                text: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """colxlip_tpu/models/clip.py ``ColXLIP.__call__``: the four
        normalised feature tensors plus ``logit_scale`` / ``logit_bias``."""
        out = self._scalars()
        if image is not None:
            out["image_features"], out["token_image_features"] = (
                self.encode_image(image, normalize=True))
        if text is not None:
            out["text_features"], out["token_text_features"] = (
                self.encode_text(text, normalize=True))
        return out
