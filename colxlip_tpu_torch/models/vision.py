"""Vision transformer tower: port of ``colxlip_tpu/models/vision.py``.

patchify-as-matmul (``conv1``) -> + class token and positional embedding
(learned, or the fixed 2-D sin-cos table as its initial value) in the compute
dtype -> PatchDropout when training -> ln_pre (unless ``no_ln_pre``) -> blocks
-> ln_post on all tokens then pooling, or pooling then ln_post on the pooled
vector (``final_ln_after_pool``), or with ``attentional_pool`` the learned
queries' cross-attention (``attn_pool``), ln_post on its output, then
pooling -> pooled @ proj. ``pool_type``: 'tok' (the
class token), 'avg' (the mean of the patch tokens), anything else no pooling.

Takes NHWC images [B, H, W, 3], the JAX layout: floats already normalised, or
integers (the uint8 feed), which are normalised here, on the tensor's device,
in fp32 with the config's mean and std; or the planar YUV420 feed, integers
[B, H*3//2, W], which ``ops.yuv420.decode_yuv420`` turns into normalised fp32
RGB on the device.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from ..ops.yuv420 import decode_yuv420
from .configs import CLIPVisionCfg
from .layers import AttentionalPooler, LayerNorm, PatchDropout, Transformer

POS_EMBED_TYPES = ("learnable", "sin_cos_2d")


def check_supported(cfg: CLIPVisionCfg) -> None:
    if cfg.pos_embed_type not in POS_EMBED_TYPES:
        raise ValueError(f"pos_embed_type {cfg.pos_embed_type!r}: expected one of "
                         f"{POS_EMBED_TYPES}")
    if cfg.pos_embed_type == "sin_cos_2d" and cfg.grid_size[0] != cfg.grid_size[1]:
        # the table is built over a square grid: fail when the tower is built
        raise ValueError("pos_embed_type='sin_cos_2d' needs a square patch grid; "
                         f"got {cfg.grid_size}")


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


def global_pool(x: torch.Tensor, pool_type: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, tokens) of x [B, 1 + P, W]."""
    if pool_type == "avg":
        return x[:, 1:].mean(dim=1), x[:, 1:]
    if pool_type == "tok":
        return x[:, 0], x[:, 1:]
    return x, x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionCfg, embed_dim: int, act: Callable, *,
                 dtype: torch.dtype, grad_checkpointing: bool = False):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        width = cfg.width
        self.conv1 = PatchEmbed(width, cfg.patch_size, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.num_patches + 1, width))
        if cfg.patch_dropout > 0.0:
            self.patch_dropout = PatchDropout(cfg.patch_dropout)
        if not cfg.no_ln_pre:
            self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, cfg.layers, cfg.heads, cfg.mlp_ratio, act,
                                       dtype=dtype, grad_checkpointing=grad_checkpointing,
                                       ls_init_value=cfg.ls_init_value)
        if cfg.attentional_pool:
            self.attn_pool = AttentionalPooler(width, width, cfg.attn_pooler_heads,
                                               cfg.attn_pooler_queries, dtype=dtype)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))
        # for the integer feed; not part of the state dict
        self.register_buffer("image_mean", torch.tensor(cfg.image_mean), persistent=False)
        self.register_buffer("image_std", torch.tensor(cfg.image_std), persistent=False)

    def forward(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image [B, H, W, 3] (NHWC; float, or integer 0..255) or planar
        YUV420 [B, H*3//2, W] (integer) -> (pooled [B, E], tokens [B, P, W])."""
        if image.ndim == 3:
            if image.is_floating_point():
                raise ValueError("3-D image batches must be planar uint8 YUV420 "
                                 f"[B, H*3//2, W]; got {image.dtype} {tuple(image.shape)}")
            image = decode_yuv420(image, self.cfg.image_mean, self.cfg.image_std)
        if image.ndim != 4 or image.shape[-1] != 3:
            raise ValueError("encode_image takes NHWC images [B, H, W, 3], float "
                             f"(normalized) or integer; got {image.dtype} {tuple(image.shape)}")
        if not image.is_floating_point():
            # the host ships raw RGB bytes and the device normalises in fp32:
            # the same numbers as the host float32 transform
            image = (image.float() / 255.0 - self.image_mean) / self.image_std
        cfg = self.cfg
        x = self.conv1(image)
        cls = self.class_embedding.to(self.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(self.dtype)
        if cfg.patch_dropout > 0.0:
            x = self.patch_dropout(x)
        if not cfg.no_ln_pre:
            x = self.ln_pre(x)
        x = self.transformer(x)
        if cfg.attentional_pool:
            pooled, tokens = global_pool(self.ln_post(self.attn_pool(x)), cfg.pool_type)
        elif cfg.final_ln_after_pool:
            pooled, tokens = global_pool(x, cfg.pool_type)
            pooled = self.ln_post(pooled)
        else:
            pooled, tokens = global_pool(self.ln_post(x), cfg.pool_type)
        return torch.matmul(pooled, self.proj.to(pooled.dtype)), tokens
