"""Vision transformer tower: port of ``colxlip_tpu/models/vision.py``.

patchify-as-matmul (``conv1``) -> + class token and positional embedding in
the compute dtype -> ln_pre -> blocks -> ln_post on all tokens -> pooled =
token 0 @ proj, tokens = x[:, 1:]. Takes NHWC float images [B, H, W, 3], the
JAX layout. The uint8 and YUV420 feeds (normalize on device) are not ported.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from .configs import CLIPVisionCfg
from .layers import LayerNorm, Transformer


def check_supported(cfg: CLIPVisionCfg) -> None:
    unported = {
        "attentional_pool": cfg.attentional_pool,
        "final_ln_after_pool": cfg.final_ln_after_pool,
        "no_ln_pre": cfg.no_ln_pre,
        "ls_init_value": cfg.ls_init_value is not None,
        "pos_embed_type": cfg.pos_embed_type != "learnable",
        "pool_type": cfg.pool_type != "tok",
        # PatchDropout: the JAX tower drops patch tokens when training
        # (colxlip_tpu/models/vision.py:112-115); a train step here would
        # silently differ, so the option is refused until it is ported
        "patch_dropout (PatchDropout)": cfg.patch_dropout > 0,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"vision_cfg options {bad} are not yet ported in colxlip_tpu_torch")


class PatchEmbed(nn.Module):
    """The stride-p convolution written as one matmul, in the exact reshape
    order of the JAX tower: [B, gh, p, gw, p, 3] -> [B, gh*gw, (p p 3)].
    ``weight`` keeps the OpenCLIP conv layout [width, 3, p, p] (the JAX
    kernel [(p p 3), width] transposed by ``export_pt_state_dict``)."""

    def __init__(self, width: int, patch_size: int, *, dtype: torch.dtype):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(width, 3, patch_size, patch_size))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = image.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = image.to(self.dtype).reshape(b, gh, p, gw, p, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
        kernel = self.weight.permute(2, 3, 1, 0).reshape(p * p * 3, -1)
        return torch.matmul(x, kernel.to(self.dtype))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionCfg, embed_dim: int, act: Callable, *,
                 dtype: torch.dtype):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        width = cfg.width
        self.conv1 = PatchEmbed(width, cfg.patch_size, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.num_patches + 1, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, cfg.layers, cfg.heads,
                                       cfg.mlp_ratio, act, dtype=dtype)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image [B, H, W, 3] float (NHWC) -> (pooled [B, E], tokens [B, P, W])."""
        if image.ndim != 4 or image.shape[-1] != 3 or not image.is_floating_point():
            raise ValueError("encode_image takes normalized float NHWC images "
                             f"[B, H, W, 3]; got {image.dtype} "
                             f"{tuple(image.shape)} (uint8/YUV420 feeds are "
                             "not yet ported in colxlip_tpu_torch)")
        x = self.conv1(image)
        cls = self.class_embedding.to(self.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(self.dtype)
        x = self.ln_pre(x)
        x = self.transformer(x)
        x = self.ln_post(x)
        pooled, tokens = x[:, 0], x[:, 1:]
        return torch.matmul(pooled, self.proj.to(pooled.dtype)), tokens
