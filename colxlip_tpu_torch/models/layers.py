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

``LayerNorm`` and ``MLP`` have two paths each, as in the JAX package: the
library path (``F.layer_norm``; two ``Linear``s around the activation) and
the hand-written kernels (``ops/fused_ln.py``, ``ops/fused_mlp.py``). The
environment variables ``COLXLIP_LN_IMPL`` and ``COLXLIP_MLP_IMPL`` choose
(``fused`` or ``xla``, the JAX spelling of "the library path"; default
``xla``; anything else raises). They are read once, when the module is
built, not on every call; an explicit ``impl`` argument beats them. The
parameters are the same under either setting, so checkpoints load under both.
``COLXLIP_MLP_INT8=fwd``, read at the same moment, sends both matmuls of
every ``MLP`` through ``ops.quantization.int8_st_linear`` (int8 forward,
straight-through backward) on the same parameters; it takes precedence over
``COLXLIP_MLP_IMPL``, as in the JAX package.

``MultiHeadAttention`` takes its attention path from ``attn_impl`` (or
``COLXLIP_ATTN_IMPL``, read when the module is built; ``ops.attention``
``resolve_impl``): 'fused', the default, hands the packed projection to the
attention kernels; every other name goes through
``ops.attention.multi_head_attention``. Built with ``kv_dim`` it is
cross-attention, with ``q_proj`` / ``k_proj`` / ``v_proj``.

``gelu`` reads ``COLXLIP_GELU_IMPL`` on every call, as the JAX function
does: 'stock' (exact erf, ``F.gelu``), 'aspoly' (the Abramowitz-Stegun erf
polynomial), 'fast' and 'fast9' (erf as the tanh of an odd polynomial of
degree 13 or 9); each of the last three has the JAX custom VJP's gradient.
Unset, the port keeps 'stock', where the JAX default is 'fast9' (a TPU
speed knob, 3.4e-6 from erf). Any other name raises. ``gelu_tanh`` takes
the library's tanh GELU under 'stock' and the closed form with its custom
gradient under the others.

``AttentionalPooler`` is learned-query cross-attention pooling (``query``,
``ln_q``, ``ln_k``, ``attn`` built with ``kv_dim``); ``Transformer`` and its
blocks take an additive attention ``mask`` (the CoCa text tower's), which
sends self-attention to the library path ('xla'), as in JAX.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops import attention as attention_ops
from ..ops.fused_ln import fused_layernorm, resolve_ln_impl
from ..ops.fused_mlp import (_SQRT1_2, erf_poly, fused_mlp, kernel_gelu_and_grad,
                             resolve_mlp_impl)
from ..ops.quantization import int8_st_linear

logger = logging.getLogger(__name__)


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
    """LayerNorm computed in fp32, output cast back to the input's dtype.
    ``impl``: 'fused' takes ``ops/fused_ln.py`` for every input (its kernels
    on the card, which raise on a shape or dtype outside their range; its
    plain version on the CPU), 'xla' ``F.layer_norm``, 'auto'
    ``COLXLIP_LN_IMPL`` as it is when the module is built. The JAX module
    gives way to the library for an unsupported shape; this one does not,
    so a run that asked for the kernels is never timed on the library."""

    def __init__(self, dim: int, eps: float = 1e-5, impl: str = "auto"):
        super().__init__()
        self.eps = eps
        self.impl = resolve_ln_impl(impl)
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "fused":
            return fused_layernorm(x, self.weight, self.bias, self.eps)
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


GELU_IMPLS = ("stock", "aspoly", "fast", "fast9")
# erf(x / sqrt 2) = tanh(p(x)), p odd: the coefficients of x, x^3, ... of the
# JAX package's fits (colxlip_tpu/ops/fused_mlp.py _TANH_ERF_C, _TANH_ERF_C9):
# degree 13, 1.24e-7 from GELU over [-8, 8]; degree 9, 3.4e-6
TANH_ERF_C = (7.978849415003e-01, 3.633308435436e-02, -3.259467502166e-05,
              -5.530634998354e-05, 3.964779949953e-06, -1.322668724700e-07,
              1.756295264109e-09)
TANH_ERF_C9 = (7.978279664811e-01, 3.646912955145e-02, -1.250404030320e-04,
               -3.054860572436e-05, 1.117285474498e-06)


def resolve_gelu_impl() -> str:
    """``COLXLIP_GELU_IMPL`` (unset: 'stock'); an unknown name raises."""
    impl = os.environ.get("COLXLIP_GELU_IMPL") or "stock"
    if impl not in GELU_IMPLS:
        raise ValueError(f"COLXLIP_GELU_IMPL={impl!r}: expected one of {GELU_IMPLS} "
                         "(unset: 'stock')")
    return impl


def _tanh_erf_gelu_and_grad(x32: torch.Tensor, coeffs) -> tuple:
    """(GELU, d/dx) in fp32 with erf(x / sqrt 2) = tanh(x p(x^2)), Horner in
    x^2 as in the JAX package."""
    u = x32 * x32
    p = torch.full_like(x32, coeffs[-1])
    for c in coeffs[-2::-1]:
        p = p * u + c
    n = len(coeffs)
    dp = torch.full_like(x32, (2 * n - 1) * coeffs[-1])
    for i in range(n - 2, -1, -1):
        dp = dp * u + (2 * i + 1) * coeffs[i]
    t = torch.tanh(x32 * p)
    return 0.5 * x32 * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * x32 * (1.0 - t * t) * dp


def _gelu_and_grad(x32: torch.Tensor, impl: str) -> tuple:
    if impl == "aspoly":
        return (0.5 * x32 * (1.0 + erf_poly(x32 * _SQRT1_2)),
                kernel_gelu_and_grad(x32, approximate=False)[1])
    if impl == "tanh":
        return kernel_gelu_and_grad(x32, approximate=True)
    return _tanh_erf_gelu_and_grad(x32, TANH_ERF_C if impl == "fast" else TANH_ERF_C9)


class _FormulaGELU(torch.autograd.Function):
    """A GELU formula in fp32, cast to the input's dtype; the backward keeps
    only x and recomputes the derivative (the JAX custom VJPs)."""

    @staticmethod
    def forward(ctx, x, impl):
        ctx.save_for_backward(x)
        ctx.impl = impl
        return _gelu_and_grad(x.float(), impl)[0].to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        grad = _gelu_and_grad(x.float(), ctx.impl)[1]
        return (g.float() * grad).to(x.dtype), None


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU by ``COLXLIP_GELU_IMPL`` (module docstring)."""
    impl = resolve_gelu_impl()
    if impl == "stock":
        return F.gelu(x, approximate="none")
    return _FormulaGELU.apply(x, impl)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU: the library's under 'stock', else the closed
    form with the JAX custom VJP's gradient."""
    if resolve_gelu_impl() == "stock":
        return F.gelu(x, approximate="tanh")
    return _FormulaGELU.apply(x, "tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class GELU(nn.Module):
    """Module form of ``gelu`` (slot 2 of the token heads' Sequential)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class MLP(nn.Module):
    """c_fc -> act -> c_proj, both matmuls in the compute dtype. ``impl``:
    'fused' sends a 3-D input through the one kernel of ``ops/fused_mlp.py``
    when ``act`` is ``gelu`` or ``gelu_tanh``, 'xla' never, 'auto'
    ``COLXLIP_MLP_IMPL`` as it is when the module is built. Under 'fused',
    ``quick_gelu`` (every OpenAI / laion400m checkpoint) and 2-D inputs keep
    the two ``Linear``s, as the JAX module does; a module built so logs one
    warning naming its activation, so that such a run is not timed as the
    kernel's by accident. The kernel's exact GELU is the
    Abramowitz-Stegun erf polynomial, 1.5e-7 from ``gelu``'s erf.
    ``COLXLIP_MLP_INT8=fwd`` in the environment when the module is built
    beats ``impl``: both matmuls run int8 x int8 -> int32 with a
    straight-through backward (``int8_st_linear``), any ``act``, any rank."""

    def __init__(self, dim: int, mlp_ratio: float, act: Callable, *,
                 dtype: torch.dtype, impl: str = "auto"):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.act = act
        self.dtype = dtype
        self.approximate = {gelu: False, gelu_tanh: True}.get(act)
        wants_kernel = resolve_mlp_impl(impl) == "fused"
        self.fused = wants_kernel and self.approximate is not None
        if wants_kernel and not self.fused:
            logger.warning("MLP(%d, %d): activation %s has no fused kernel (gelu, gelu_tanh); "
                           "this module keeps the two Linears under COLXLIP_MLP_IMPL=fused",
                           dim, hidden, getattr(act, "__name__", act))
        self.int8_fwd = os.environ.get("COLXLIP_MLP_INT8", "") == "fwd"
        self.c_fc = Linear(dim, hidden, dtype=dtype)
        self.c_proj = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8_fwd:
            h = int8_st_linear(x.to(self.dtype), self.c_fc.weight, self.c_fc.bias)
            return int8_st_linear(self.act(h), self.c_proj.weight, self.c_proj.bias)
        if self.fused and x.ndim == 3:
            dt = self.dtype
            # the casts and the one transpose (c_proj.weight [D, H] -> the
            # kernel's hidden-major [H, D]) stay outside the kernel's
            # autograd.Function, so the gradients pass back through them
            return fused_mlp(x.to(dt), self.c_fc.weight.to(dt), self.c_fc.bias.to(dt),
                             self.c_proj.weight.to(dt).t().contiguous(),
                             self.c_proj.bias.to(dt), self.approximate)
        return self.c_proj(self.act(self.c_fc(x)))


class LayerScale(nn.Module):
    """Per-channel learnable scaling of a residual branch (``gamma``)."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


def patch_dropout_select(x: torch.Tensor, scores: torch.Tensor, prob: float,
                         exclude_first_token: bool = True) -> torch.Tensor:
    """Keep ``max(1, int(n * (1 - prob)))`` of each sample's n patch tokens:
    those with the highest ``scores`` [B, n], in descending order of score
    (a per-sample top-k), after the class token when it is excluded from the
    draw. Pure: the same scores select the same tokens."""
    first = 1 if exclude_first_token else 0
    cls_tok, tokens = x[:, :first], x[:, first:]
    n = tokens.shape[1]
    if scores.shape != tokens.shape[:2]:
        raise ValueError(f"patch_dropout_select: scores {tuple(scores.shape)} for tokens "
                         f"{tuple(tokens.shape[:2])}")
    num_keep = max(1, int(n * (1.0 - prob)))
    keep_idx = scores.topk(num_keep, dim=1).indices
    kept = tokens.gather(1, keep_idx[:, :, None].expand(-1, -1, tokens.shape[2]))
    return torch.cat([cls_tok, kept], dim=1)


class PatchDropout(nn.Module):
    """Randomly keep a subset of patch tokens while training; the identity
    in eval mode or at ``prob`` 0. The normal scores are drawn from
    ``generator`` (a ``torch.Generator``, on its own device, so a seed gives
    the same tokens on the CPU and on the card); training without one
    raises, as the JAX module does without its 'patch_dropout' rng."""

    def __init__(self, prob: float = 0.5, exclude_first_token: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= prob < 1.0:
            raise ValueError(f"PatchDropout prob must be in [0, 1); got {prob}")
        self.prob = prob
        self.exclude_first_token = exclude_first_token
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.prob == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("PatchDropout in training mode needs a torch.Generator "
                               "(set module.generator): its draw is never implicit")
        n = x.shape[1] - (1 if self.exclude_first_token else 0)
        scores = torch.randn((x.shape[0], n), generator=self.generator,
                             device=self.generator.device)
        return patch_dropout_select(x, scores.to(x.device), self.prob,
                                    self.exclude_first_token)


class MultiHeadAttention(nn.Module):
    """Multi-head attention. Self-attention has a packed [3D, D] in_proj:
    its [B, N, 3D] output goes to ``ops.attention.packed_attention``, which
    under 'fused' hands it to the CUDA kernel on the card with no split and
    no transpose, and otherwise splits it for
    ``ops.attention.multi_head_attention``. Built with ``kv_dim``,
    the module is cross-attention: ``q_proj`` [D, D], ``k_proj`` / ``v_proj``
    [D, kv_dim], called with ``kv`` [B, M, kv_dim]. ``attn_impl`` 'auto'
    reads ``COLXLIP_ATTN_IMPL`` once, here; an unknown name raises here."""

    def __init__(self, dim: int, heads: int, *, dtype: torch.dtype, attn_impl: str = "auto",
                 kv_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.attn_impl = attention_ops.check_impl(attn_impl)
        self.cross = kv_dim is not None
        if self.cross:
            self.q_proj = Linear(dim, dim, dtype=dtype)
            self.k_proj = Linear(kv_dim, dim, dtype=dtype)
            self.v_proj = Linear(kv_dim, dim, dtype=dtype)
        else:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
            self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, is_causal: bool = False, *,
                kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, d = x.shape
        if self.cross != (kv is not None):
            raise ValueError("MultiHeadAttention: kv= goes with a module built with kv_dim, "
                             "and only with one")
        if not self.cross:
            qkv = dense(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
            return self.out_proj(attention_ops.packed_attention(
                qkv, self.heads, is_causal, self.attn_impl, mask=mask))
        q, k, v = self.q_proj(x), self.k_proj(kv), self.v_proj(kv)
        h = self.heads
        q, k, v = (t.reshape(b, t.shape[1], h, d // h) for t in (q, k, v))
        out = attention_ops.multi_head_attention(q, k, v, mask=mask, causal=is_causal,
                                                 impl=self.attn_impl)
        return self.out_proj(out.reshape(b, n, d))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + ls_1(attn(ln_1(x))), then x + ls_2(mlp(ln_2(x)));
    the LayerScales exist only when ``ls_init_value`` is given."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, act: Callable,
                 *, dtype: torch.dtype, ls_init_value: Optional[float] = None):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, heads, dtype=dtype)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MLP(dim, mlp_ratio, act, dtype=dtype)
        if ls_init_value is not None:
            self.ls_1 = LayerScale(dim, ls_init_value)
            self.ls_2 = LayerScale(dim, ls_init_value)
        self.scaled = ls_init_value is not None

    def forward(self, x: torch.Tensor, is_causal: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        attn_out = self.attn(self.ln_1(x), is_causal, mask=mask)
        x = x + (self.ls_1(attn_out) if self.scaled else attn_out)
        mlp_out = self.mlp(self.ln_2(x))
        return x + (self.ls_2(mlp_out) if self.scaled else mlp_out)


class Transformer(nn.Module):
    """Stack of residual blocks (``resblocks.{i}``). ``grad_checkpointing``
    is the JAX package's remat knob: when gradients are on, each block keeps
    only its input and is recomputed in the backward
    (``torch.utils.checkpoint``), for the same loss and gradients."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float,
                 act: Callable, *, dtype: torch.dtype, grad_checkpointing: bool = False,
                 ls_init_value: Optional[float] = None):
        super().__init__()
        self.grad_checkpointing = grad_checkpointing
        self.resblocks = nn.ModuleList([
            ResidualAttentionBlock(width, heads, mlp_ratio, act, dtype=dtype,
                                   ls_init_value=ls_init_value)
            for _ in range(layers)])

    def forward(self, x: torch.Tensor, is_causal: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: an additive attention bias that broadcasts to [B, H, N, N]."""
        remat = self.grad_checkpointing and torch.is_grad_enabled()
        for block in self.resblocks:
            if remat:
                x = torch.utils.checkpoint.checkpoint(block, x, is_causal, mask,
                                                      use_reentrant=False)
            else:
                x = block(x, is_causal, mask)
        return x


class AttentionalPooler(nn.Module):
    """``n_queries`` learned queries cross-attend into a sequence [B, M,
    kv_dim] -> [B, n_queries, d_model]: the keys and values are ``ln_k(x)``,
    the queries ``ln_q(query)`` in the compute dtype."""

    def __init__(self, d_model: int, kv_dim: int, n_head: int = 8, n_queries: int = 256, *,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.query = nn.Parameter(torch.empty(n_queries, d_model))
        self.ln_k = LayerNorm(kv_dim)
        self.ln_q = LayerNorm(d_model)
        self.attn = MultiHeadAttention(d_model, n_head, dtype=dtype, kv_dim=kv_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.ln_q(self.query.to(self.dtype)[None])
        return self.attn(q.expand(x.shape[0], -1, -1), kv=self.ln_k(x))
