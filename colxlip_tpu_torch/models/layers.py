"""Transformer layers: port of ``colxlip_tpu/models/layers.py``.

Precision follows the JAX service's policy without autocast: parameters are
fp32, each module casts its own inputs and weights to the compute dtype
(``dtype``) the way a flax ``Dense(dtype=bf16)`` does, and returns the
compute dtype. LayerNorm statistics always run in fp32 and cast back to the
input's dtype.

Parameter names follow the OpenCLIP state-dict keys that
``colxlip_tpu/training/checkpoint.py`` ``export_pt_state_dict`` emits
(``ln_1``, ``attn.in_proj_weight``, ``attn.out_proj``, ``ln_2``, ``mlp.c_fc``,
``mlp.c_proj``), so ``load_state_dict(strict=True)`` proves the layout.

Not ported (no shipped config uses them): LayerScale, PatchDropout (the
vision tower refuses it), cross-attention and the attentional pooler.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops import attention as attention_ops


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=...) numerics: input, kernel and bias cast to the
    compute dtype; ``weight`` is [out, in] (the torch layout)."""
    return torch.matmul(x.to(dtype), weight.to(dtype).t()) + bias.to(dtype)


class Linear(nn.Module):
    """[out, in] weight + bias, applied in the compute dtype."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32, output cast back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU. The JAX default is a degree-9 tanh-structured erf
    (colxlip_tpu/models/layers.py ``gelu``), 3.4e-6 from erf in fp32."""
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class GELU(nn.Module):
    """Module form of ``gelu`` (slot 2 of the token heads' Sequential)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class MLP(nn.Module):
    """c_fc -> act -> c_proj, both matmuls in the compute dtype."""

    def __init__(self, dim: int, mlp_ratio: float, act: Callable, *,
                 dtype: torch.dtype):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.act = act
        self.c_fc = Linear(dim, hidden, dtype=dtype)
        self.c_proj = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(self.act(self.c_fc(x)))


class MultiHeadAttention(nn.Module):
    """Self-attention with a packed [3D, D] in_proj.

    The packed projection's [B, N, 3D] output goes straight into
    ``ops.attention.fused_mha_packed`` (the CUDA kernel on the card), whose
    [B, N, D] output goes straight into out_proj: no split, no transpose."""

    def __init__(self, dim: int, heads: int, *, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, is_causal: bool = False) -> torch.Tensor:
        qkv = dense(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
        out = attention_ops.fused_mha_packed(qkv, self.heads, is_causal)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + mlp(ln_2(x))."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, act: Callable,
                 *, dtype: torch.dtype):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, heads, dtype=dtype)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MLP(dim, mlp_ratio, act, dtype=dtype)

    def forward(self, x: torch.Tensor, is_causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), is_causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """Stack of residual blocks (``resblocks.{i}``). ``grad_checkpointing``
    is the JAX package's remat knob: when gradients are on, each block keeps
    only its input and is recomputed in the backward
    (``torch.utils.checkpoint``), for the same loss and gradients."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float,
                 act: Callable, *, dtype: torch.dtype, grad_checkpointing: bool = False):
        super().__init__()
        self.grad_checkpointing = grad_checkpointing
        self.resblocks = nn.ModuleList([
            ResidualAttentionBlock(width, heads, mlp_ratio, act, dtype=dtype)
            for _ in range(layers)])

    def forward(self, x: torch.Tensor, is_causal: bool = False) -> torch.Tensor:
        remat = self.grad_checkpointing and torch.is_grad_enabled()
        for block in self.resblocks:
            if remat:
                x = torch.utils.checkpoint.checkpoint(block, x, is_causal,
                                                      use_reentrant=False)
            else:
                x = block(x, is_causal)
        return x
