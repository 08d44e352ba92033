"""CoCa: port of ``colxlip_tpu/models/coca.py``.

Contrastive towers plus a caption decoder:

- the vision tower (``visual``, its own ``attentional_pool`` as the config
  says), then ``attn_pool``, an ``AttentionalPooler`` from the vision width
  to the decoder's, whose output is the image token set the decoder reads;
- the CoCa text tower, flat on the model as OpenCLIP keeps it
  (``token_embedding``, ``cls_emb``, ``positional_embedding`` of
  context + 1 rows, ``transformer``, ``ln_final``, ``text_projection``):
  a CLS embedding appended at the END of the text, causal attention for the
  text rows and, for the CLS row alone, pad keys hidden (``cls_mask``);
  ``ln_final`` and the projection apply to the CLS only, and the token
  features are the text rows BEFORE ``ln_final``;
- ``text_decoder``, the ``MultimodalTransformer``: per layer one causal
  self-attention block (``resblocks.{i}``) then one cross-attention block
  into the image tokens (``cross_attn.{i}``: ``ln_1_kv`` on the image side,
  a packed ``in_proj`` split into q / k / v, its own MLP), then
  ``ln_final``; ``text_decoder.text_projection`` [width, vocab] is the vocab
  head (the JAX ``to_logits`` kernel; OpenCLIP's key).

``forward(image, text)`` returns the dict ``coca_loss`` reads: the
normalised pooled features, ``logits`` [B, L-1, vocab] of the decoder fed
the text tokens but the last, ``caption_hidden`` (the decoder's output),
``caption_head_kernel`` (the head's weight), ``labels`` (the text shifted
left) and ``logit_scale``. ``logits=False`` leaves out the dense logits
(the streaming caption CE reads the hidden states and the kernel instead).

Attention follows the JAX dispatch: the vision tower's and the decoder's
self-attention (no mask) run kernels #1 / #2; the CoCa text tower (an
additive mask) and every cross-attention take the library path ('xla').
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops import attention as attention_ops
from ..parallel import tensor_parallel as tp
from .clip import l2_normalize
from .configs import CLIPCfg, MultimodalCfg
from .layers import (MLP, AttentionalPooler, LayerNorm, Linear, ResidualAttentionBlock,
                     Transformer, dense, gelu, quick_gelu, row_parallel_out)
from .vision import VisionTransformer


def cls_mask(text: torch.Tensor, pad_id: int) -> torch.Tensor:
    """The CoCa text tower's additive mask [B, 1, n + 1, n + 1] (fp32) for
    text [B, n] with the CLS appended: causal for every row; the CLS row
    also hides the keys of pad tokens, with the reference's one-position
    shift (its key mask is [True, text != pad])."""
    b, n = text.shape
    seq = n + 1
    inf = float("-inf")
    causal = torch.full((seq, seq), inf, device=text.device).triu(1)
    cls_key_ok = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=text.device),
                            text != pad_id], dim=1)
    cls_row = torch.zeros((b, seq), device=text.device).masked_fill(~cls_key_ok, inf)
    rows = torch.cat([torch.zeros((b, n, seq), device=text.device), cls_row[:, None]], dim=1)
    return causal[None, None] + rows[:, None]


class CrossAttention(nn.Module):
    """Multi-head cross-attention with OpenCLIP's packed ``in_proj`` [3 D,
    D]: q from ``x``, k and v from ``kv`` (both of width D). Given a
    ``model_axis`` (``parallel/gspmd.py``), the packed rows are regrouped to
    this rank's H / P heads as the self-attention's are, and ``out_proj`` is
    a row-parallel product (``parallel/tensor_parallel.py``)."""

    def __init__(self, dim: int, heads: int, *, dtype: torch.dtype, attn_impl: str = "auto"):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.attn_impl = attention_ops.check_impl(attn_impl)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim, dtype=dtype)
        self.model_axis: Optional[tp.ModelAxis] = None

    def forward(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        axis = self.model_axis
        w, bias, h = self.in_proj_weight, self.in_proj_bias, self.heads
        if axis is not None:
            x, kv = tp.enter(x, axis), tp.enter(kv, axis)
            w, bias, h = tp.regroup_qkv(w, axis), tp.take_rows(bias, axis, 3), h // axis.size
        d = w.shape[0] // 3
        q = dense(x, w[:d], bias[:d], self.dtype)
        k = dense(kv, w[d:2 * d], bias[d:2 * d], self.dtype)
        v = dense(kv, w[2 * d:], bias[2 * d:], self.dtype)
        q, k, v = (t.reshape(b, t.shape[1], h, d // h) for t in (q, k, v))
        out = attention_ops.multi_head_attention(q, k, v, impl=self.attn_impl).reshape(b, n, d)
        if axis is not None:
            return row_parallel_out(out, self.out_proj, axis, self.dtype)
        return self.out_proj(out)


class CrossResidualBlock(nn.Module):
    """x + attn(ln_1(x), ln_1_kv(image)), then x + mlp(ln_2(x))."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, act: Callable, *,
                 dtype: torch.dtype):
        super().__init__()
        self.ln_1_kv = LayerNorm(dim)
        self.ln_1 = LayerNorm(dim)
        self.attn = CrossAttention(dim, heads, dtype=dtype)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MLP(dim, mlp_ratio, act, dtype=dtype)

    def forward(self, x: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), self.ln_1_kv(image))
        return x + self.mlp(self.ln_2(x))


class MultimodalTransformer(nn.Module):
    """The caption decoder: (causal self block, cross block) per layer, then
    ``ln_final``; ``text_projection`` is the vocab head's [width, vocab]
    weight, applied by the model. ``grad_checkpointing`` recomputes each
    (self, cross) pair in the backward."""

    def __init__(self, cfg: MultimodalCfg, vocab_size: int, act: Callable, *,
                 dtype: torch.dtype, grad_checkpointing: bool = False):
        super().__init__()
        self.grad_checkpointing = grad_checkpointing
        self.resblocks = nn.ModuleList([
            ResidualAttentionBlock(cfg.width, cfg.heads, cfg.mlp_ratio, act, dtype=dtype,
                                   ls_init_value=cfg.ls_init_value)
            for _ in range(cfg.layers)])
        self.cross_attn = nn.ModuleList([
            CrossResidualBlock(cfg.width, cfg.heads, cfg.mlp_ratio, act, dtype=dtype)
            for _ in range(cfg.layers)])
        self.ln_final = LayerNorm(cfg.width)
        self.text_projection = nn.Parameter(torch.empty(cfg.width, vocab_size))

    @staticmethod
    def _pair(block, cross, x, image):
        return cross(block(x, True), image)

    def forward(self, text_embs: torch.Tensor, image_embs: torch.Tensor) -> torch.Tensor:
        remat = self.grad_checkpointing and torch.is_grad_enabled()
        for block, cross in zip(self.resblocks, self.cross_attn):
            if remat:
                text_embs = torch.utils.checkpoint.checkpoint(
                    self._pair, block, cross, text_embs, image_embs, use_reentrant=False)
            else:
                text_embs = self._pair(block, cross, text_embs, image_embs)
        return self.ln_final(text_embs)


class CoCa(nn.Module):
    """Contrastive + captioning model; ``dtype`` is the compute dtype
    (parameters stay fp32)."""

    def __init__(self, cfg: CLIPCfg, multimodal_cfg: MultimodalCfg, *,
                 dtype: torch.dtype = torch.bfloat16, grad_checkpointing: bool = False):
        super().__init__()
        tcfg, vcfg, mcfg = cfg.text_cfg, cfg.vision_cfg, multimodal_cfg
        if tcfg.width != mcfg.width:
            raise ValueError(f"CoCa: the decoder reads the text tokens as they are, so "
                             f"text_cfg.width ({tcfg.width}) must equal multimodal_cfg.width "
                             f"({mcfg.width})")
        self.cfg = cfg
        self.multimodal_cfg = mcfg
        self.dtype = dtype
        act = quick_gelu if cfg.quick_gelu else gelu
        self.visual = VisionTransformer(vcfg, cfg.embed_dim, act, dtype=dtype,
                                        grad_checkpointing=grad_checkpointing)
        self.attn_pool = AttentionalPooler(mcfg.width, vcfg.width, vcfg.attn_pooler_heads,
                                           vcfg.attn_pooler_queries, dtype=dtype)
        self.token_embedding = nn.Embedding(tcfg.vocab_size, tcfg.width)
        self.cls_emb = nn.Parameter(torch.empty(tcfg.width))
        self.positional_embedding = nn.Parameter(
            torch.empty(tcfg.context_length + 1, tcfg.width))
        self.transformer = Transformer(tcfg.width, tcfg.layers, tcfg.heads, tcfg.mlp_ratio,
                                       act, dtype=dtype, grad_checkpointing=grad_checkpointing,
                                       ls_init_value=tcfg.ls_init_value)
        self.ln_final = LayerNorm(tcfg.width)
        self.text_projection = (nn.Parameter(torch.empty(tcfg.width, cfg.embed_dim))
                                if tcfg.proj_type != "none" and cfg.embed_dim else None)
        self.text_decoder = MultimodalTransformer(mcfg, tcfg.vocab_size, act, dtype=dtype,
                                                  grad_checkpointing=grad_checkpointing)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.init_logit_scale))

    def encode_image(self, image: torch.Tensor, normalize: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pooled [B, E], the vision tower's tokens [B, P, W])."""
        pooled, tokens = self.visual(image)
        return (l2_normalize(pooled) if normalize else pooled), tokens

    def encode_text(self, text: torch.Tensor, normalize: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pooled CLS [B, E], token features [B, n, W] before ``ln_final``)."""
        b, n = text.shape
        x = F.embedding(text, self.token_embedding.weight).to(self.dtype)
        x = torch.cat([x, self.cls_emb.to(self.dtype).expand(b, 1, -1)], dim=1)
        x = x + self.positional_embedding[:n + 1].to(self.dtype)
        x = self.transformer(x, mask=cls_mask(text, self.cfg.text_cfg.pad_id))
        pooled = self.ln_final(x[:, -1])
        if self.text_projection is not None:
            pooled = torch.matmul(pooled, self.text_projection.to(pooled.dtype))
        return (l2_normalize(pooled) if normalize else pooled), x[:, :-1]

    def embed_images(self, image: torch.Tensor) -> torch.Tensor:
        """The pooled image token set [B, Q, W_dec] the decoder reads,
        computed once an image for captioning (``serving/generate.py``)."""
        return self.attn_pool(self.encode_image(image)[1])

    def vocab_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.matmul(hidden, self.text_decoder.text_projection.to(self.dtype))

    def caption_logits(self, text: torch.Tensor, image_embs: torch.Tensor) -> torch.Tensor:
        """[B, n - 1, vocab] next-token logits of a (padded) prefix: row t
        predicts token t + 1, and causality keeps each row independent of
        the later (pad) positions."""
        tokens = self.encode_text(text)[1]
        return self.vocab_logits(self.text_decoder(tokens[:, :-1], image_embs))

    def forward(self, image: torch.Tensor, text: torch.Tensor, *,
                logits: bool = True) -> Dict[str, Optional[torch.Tensor]]:
        image_features, image_tokens = self.encode_image(image, normalize=True)
        image_embs = self.attn_pool(image_tokens)
        text_features, text_tokens = self.encode_text(text, normalize=True)
        hidden = self.text_decoder(text_tokens[:, :-1], image_embs)
        return {
            "image_features": image_features,
            "text_features": text_features,
            "logits": self.vocab_logits(hidden) if logits else None,
            "caption_hidden": hidden,
            "caption_head_kernel": self.text_decoder.text_projection,
            "labels": text[:, 1:],
            "logit_scale": self.logit_scale.exp(),
        }
