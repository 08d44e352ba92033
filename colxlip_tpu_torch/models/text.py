"""Causal text transformer tower: port of ``colxlip_tpu/models/text.py``.

token embedding + positional_embedding[:n] (so a shorter input runs a
shorter context: the serving ``--text-buckets`` lever) -> blocks (causal
unless ``no_causal_mask``) -> ln_final -> pooling (``pool_type``: 'argmax',
the EOT position; 'first'; 'last'; anything else none) -> @ text_projection.
``embed_cls``, ``proj_type`` other than 'linear' and ``proj_bias`` are not
ported and raise ``NotImplementedError``.

OpenCLIP keeps the text tower's parameters flat on the CLIP module
(``token_embedding.weight``, ``positional_embedding``, ``transformer.*``,
``ln_final.*``, ``text_projection``), and so does ``export_pt_state_dict``.
``add_text_tower`` therefore registers them on the model itself, and
``encode_text_tower`` runs them.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .configs import CLIPTextCfg
from .layers import LayerNorm, Transformer


def check_supported(cfg: CLIPTextCfg) -> None:
    unported = {
        "embed_cls": cfg.embed_cls,
        "proj_type": cfg.proj_type != "linear",
        "proj_bias": cfg.proj_bias,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"text_cfg options {bad} are not yet ported in colxlip_tpu_torch")


def add_text_tower(model: nn.Module, cfg: CLIPTextCfg, embed_dim: int,
                   act: Callable, *, dtype: torch.dtype,
                   grad_checkpointing: bool = False) -> None:
    """Register the text tower's modules and parameters on ``model``."""
    check_supported(cfg)
    model.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
    model.positional_embedding = nn.Parameter(
        torch.empty(cfg.context_length, cfg.width))
    model.transformer = Transformer(cfg.width, cfg.layers, cfg.heads, cfg.mlp_ratio, act,
                                    dtype=dtype, grad_checkpointing=grad_checkpointing,
                                    ls_init_value=cfg.ls_init_value)
    model.ln_final = LayerNorm(cfg.width)
    model.text_projection = nn.Parameter(torch.empty(cfg.width, embed_dim))


def text_global_pool(x: torch.Tensor, text: torch.Tensor,
                     pool_type: str = "argmax") -> torch.Tensor:
    """'argmax': the feature at the highest token id (EOT, 49407) of each
    row; 'first' / 'last': that position; anything else: no pooling."""
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        return x[:, -1]
    if pool_type == "argmax":
        return x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
    return x


def encode_text_tower(model: nn.Module, text: torch.Tensor,
                      dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """text [B, n] int token ids, n <= context_length -> (pooled [B, E],
    ln_final'd tokens [B, n, W])."""
    n = text.shape[1]
    x = F.embedding(text, model.token_embedding.weight).to(dtype)
    x = x + model.positional_embedding[:n].to(dtype)
    cfg = model.cfg.text_cfg
    x = model.transformer(x, is_causal=not cfg.no_causal_mask)
    x = model.ln_final(x)
    pooled = text_global_pool(x, text, cfg.pool_type)
    return torch.matmul(pooled, model.text_projection.to(pooled.dtype)), x
