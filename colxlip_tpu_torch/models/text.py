"""Causal text transformer tower: port of ``colxlip_tpu/models/text.py``.

token embedding + positional_embedding[:n] (so a shorter input runs a
shorter context: the serving ``--text-buckets`` lever) -> blocks (causal
unless ``no_causal_mask``) -> ln_final -> pooling (``pool_type``: 'argmax',
the EOT position; 'first'; 'last'; anything else none) -> the projection:
none with ``proj_type='none'`` (or ``embed_dim`` 0), a ``Linear`` with bias
named ``text_projection`` with ``proj_bias``, else the bare [width,
embed_dim] matrix ``text_projection`` (any other ``proj_type`` is linear,
as in the JAX tower). ``embed_cls`` belongs to the CoCa text tower
(``models/coca.py``); this tower refuses it.

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
from .layers import LayerNorm, Linear, Transformer


def check_supported(cfg: CLIPTextCfg) -> None:
    if cfg.embed_cls:
        raise NotImplementedError(
            "text_cfg option 'embed_cls' is the CoCa text tower's (models/coca.py "
            "CoCaTextTower); the CLIP text tower does not take it")


def add_projection(model: nn.Module, cfg: CLIPTextCfg, embed_dim: int, *,
                   dtype: torch.dtype) -> None:
    """``model.text_projection``: None, a ``Linear`` (``proj_bias``) or the
    bare [width, embed_dim] matrix, by the config."""
    if cfg.proj_type == "none" or not embed_dim:
        model.text_projection = None
    elif cfg.proj_bias:
        model.text_projection = Linear(cfg.width, embed_dim, dtype=dtype)
    else:
        model.text_projection = nn.Parameter(torch.empty(cfg.width, embed_dim))


def project(model: nn.Module, pooled: torch.Tensor) -> torch.Tensor:
    proj = model.text_projection
    if proj is None:
        return pooled
    if isinstance(proj, Linear):
        return proj(pooled)
    return torch.matmul(pooled, proj.to(pooled.dtype))


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
    add_projection(model, cfg, embed_dim, dtype=dtype)


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
    return project(model, pooled), x
