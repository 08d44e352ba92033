"""Fused LayerNorm: fp32 statistics over a float32 or bfloat16 stream, one
read of x per direction, nothing saved for the backward but x.

Port of ``colxlip_tpu/ops/fused_ln.py`` (``fused_layernorm``; the TPU kernels
are ``_fwd_call`` and ``_bwd_call``):

    y      = (x - mean) * rsqrt(var + eps) * scale + bias     (in x's dtype)
    dx     = rstd * (g - mean(g) - xhat * mean(g * xhat)),  g = dy * scale
    dscale = sum over rows of dy * xhat,  dbias = sum over rows of dy  (fp32)

The statistics are always fp32 and the variance is two-pass (the mean of the
squared deviations). Two kernels (``csrc/fused_ln.cu``), each beside a plain
PyTorch version with the same arithmetic. CPU tensors take the plain
versions; CUDA tensors launch the kernels or raise. There is no fallback.

``COLXLIP_LN_IMPL`` (``fused`` or ``xla``, the JAX package's spelling of "the
library path"; default ``xla``) chooses the path in ``models.layers.LayerNorm``
through ``resolve_ln_impl``.
"""
from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import torch

from .build import LaunchCounter, load_kernels

# kernel launches (plain-version calls do not count), one count per kernel
FWD_LAUNCHES = LaunchCounter()
BWD_LAUNCHES = LaunchCounter()
MAX_FEATURES = 1024              # a warp holds one row in registers
_BWD_BLOCKS = 264                # two blocks a multiprocessor write partial sums
_BWD_ROWS_PER_BLOCK = 8          # one warp a row (csrc/fused_ln.cu kWarps)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = ("fused", "xla")


def resolve_impl(impl: str, env_name: str) -> str:
    """``impl`` if it names a path; 'auto' reads the environment variable
    ``env_name`` and falls to 'xla' (the library path). An unknown value
    raises: a mistyped variable must not time the wrong path."""
    if impl == "auto":
        impl = os.environ.get(env_name) or "xla"
    if impl not in _IMPLS:
        raise ValueError(f"{env_name}={impl!r}: expected one of {_IMPLS}")
    return impl


def resolve_ln_impl(impl: str = "auto") -> str:
    """'auto' -> ``COLXLIP_LN_IMPL`` or 'xla'; an explicit 'fused' / 'xla'
    beats the environment."""
    return resolve_impl(impl, "COLXLIP_LN_IMPL")


def fused_ln_supported(x_shape: Sequence[int], dtype: torch.dtype) -> bool:
    """What the kernels take, as a function of shape and dtype only: float32
    or bfloat16, at least one row, 1 <= D <= 1024."""
    return (dtype in _DTYPE_CODES and len(x_shape) >= 1
            and 1 <= x_shape[-1] <= MAX_FEATURES and math.prod(x_shape[:-1]) >= 1)


def _stats(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x - mean, variance): two passes, the mean of the squared deviations."""
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    return xc, xc.square().mean(dim=-1, keepdim=True)


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch forward with the kernel's arithmetic: fp32 statistics,
    output in x's dtype."""
    xc, var = _stats(x.float())
    y = xc * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def layernorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                        eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward: (dx in x's dtype, dscale fp32 [D], dbias fp32
    [D]), mean and rstd recomputed from x."""
    d = x.shape[-1]
    xc, var = _stats(x.float())
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    do = dy.float()
    gdo = do * scale.float()
    m1 = gdo.sum(dim=-1, keepdim=True) / d
    m2 = (gdo * xhat).sum(dim=-1, keepdim=True) / d
    dx = (rstd * (gdo - m1 - xhat * m2)).to(x.dtype)
    return dx, (do * xhat).reshape(-1, d).sum(dim=0), do.reshape(-1, d).sum(dim=0)


def _check_cuda(name: str, x: torch.Tensor, *params: torch.Tensor) -> Tuple[int, int]:
    """(rows, D) of a CUDA call; raises on what the kernels do not take.
    ``params`` (scale, and bias forward) must be contiguous float32 [D] on
    x's device. Written for the host's time: at ViT-L's 4,112 rows the
    forward kernel's device time is shorter than its call's host side
    (scripts/torch_ln_bench.py), so each check reads each attribute once."""
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPE_CODES or not 1 <= d <= MAX_FEATURES or x.numel() == 0:
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} outside the kernels' range "
                         f"(float32 or bfloat16, 1 <= D <= {MAX_FEATURES}, at least one row)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    device = x.device
    for p in params:
        if (p.dtype is not torch.float32 or p.shape != (d,) or p.device != device
                or not p.is_contiguous()):
            raise ValueError(f"{name}: scale and bias must be contiguous float32 [{d}] on "
                             f"{device}; got {p.dtype} {tuple(p.shape)} on {p.device}")
    return x.numel() // d, d


def _stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as the integer the C entry
    points take (the raw handle: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """The forward kernel on CUDA tensors (checks, never falls back)."""
    rows, d = _check_cuda("fused_layernorm", x, scale, bias)
    kernels = load_kernels()
    y = torch.empty_like(x)
    err = kernels.colxlip_fused_ln_fwd(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                       y.data_ptr(), rows, d, eps, _DTYPE_CODES[x.dtype],
                                       _stream(x.device))
    kernels.check(err, "colxlip_fused_ln_fwd")
    FWD_LAUNCHES.add()
    return y


def _launch_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on CUDA tensors: (dx, dscale fp32, dbias fp32)."""
    rows, d = _check_cuda("fused_layernorm backward", x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"fused_layernorm backward: dy must be {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}; got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous()
    kernels = load_kernels()
    dx = torch.empty_like(x)
    blocks = min(-(-rows // _BWD_ROWS_PER_BLOCK), _BWD_BLOCKS)
    partials = torch.empty((blocks, 2, d), dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, d), dtype=torch.float32, device=x.device)
    err = kernels.colxlip_fused_ln_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), partials.data_ptr(),
        dgb.data_ptr(), rows, d, eps, blocks, _DTYPE_CODES[x.dtype], _stream(x.device))
    kernels.check(err, "colxlip_fused_ln_bwd")
    BWD_LAUNCHES.add()
    return dx, dgb[0], dgb[1]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda") or any(t.device != tensors[0].device for t in tensors):
        raise ValueError("fused_layernorm: unsupported devices "
                         f"{[str(t.device) for t in tensors]} (the CPU or one CUDA device)")
    return kind == "cpu"


def _forward(x, scale, bias, eps):
    if _on_cpu(x, scale, bias):
        return layernorm_plain(x, scale, bias, eps)
    return _launch_fwd(x, scale, bias, eps)


class _FusedLayerNorm(torch.autograd.Function):
    """Saves x and scale only; the backward recomputes mean and rstd."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        if _on_cpu(x, scale, dy):
            dx, dscale, dbias = layernorm_bwd_plain(x, scale, dy, ctx.eps)
        else:
            dx, dscale, dbias = _launch_bwd(x, scale, dy, ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x [..., D]; scale and bias are [D]
    fp32. fp32 statistics whatever x's dtype, output in x's dtype,
    differentiable in x, scale and bias.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (float32 or bfloat16, contiguous, D <= 1024) or raise."""
    x = x.contiguous()   # a view (tokens = x[:, 1:]) is copied here, under autograd
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _FusedLayerNorm.apply(x, scale, bias, eps)
    return _forward(x, scale, bias, eps)
