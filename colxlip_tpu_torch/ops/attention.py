"""Packed-QKV multi-head self-attention, forward.

Port of ``colxlip_tpu/ops/fused_attention.py`` ``fused_mha_packed`` (the TPU
default for every self-attention layer of both towers). ``fused_mha_packed``
dispatches on the tensor's device:

  - CPU tensor: ``fused_mha_plain``, the same function in plain PyTorch.
  - CUDA tensor: the hand-written kernel ``csrc/fused_attention.cu``, or an
    exception. There is no fallback to the plain version.

Forward only: the backward (TPU kernel ``_bwd_kernel``) and its
``autograd.Function`` come with the training port, so the CUDA path refuses a
``qkv`` that requires grad.
"""
from __future__ import annotations

import math

import torch

from .build import LaunchCounter, load_kernels

# kernel launches made by fused_mha_packed (plain-version calls do not count)
LAUNCHES = LaunchCounter()
HEAD_DIMS = (32, 64)
MAX_SEQ = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _split_dims(qkv: torch.Tensor, heads: int):
    if qkv.ndim != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"qkv must be [B, N, 3*H*D] with H={heads}; got "
                         f"{tuple(qkv.shape)}")
    b, n, three_hd = qkv.shape
    hd = three_hd // 3
    return b, n, hd, hd // heads


def fused_mha_plain(qkv: torch.Tensor, heads: int,
                    causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version, with the TPU kernel's numerics: fp32 scores
    scaled by 1/sqrt(D), causal mask col <= row, e = exp(s - rowmax) cast to
    the input dtype for PV, fp32 PV divided by the fp32 row sum of e.

    Holds the [B, H, N, N] fp32 scores, which the kernel never does."""
    b, n, hd, d = _split_dims(qkv, heads)
    x = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).float()
    q, k, v = x[0], x[1], x[2]                                   # [B, H, N, D]
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones(n, n, dtype=torch.bool, device=qkv.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    pv = torch.matmul(e.to(qkv.dtype).float(), v)
    out = (pv / denom).to(qkv.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, n, hd)


def fused_mha_packed(qkv: torch.Tensor, heads: int,
                     causal: bool = False) -> torch.Tensor:
    """[B, N, 3*H*D] packed QKV -> [B, N, H*D] attention output.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (D in {32, 64}, N <= 256, float32 or bfloat16, contiguous) or raise."""
    if qkv.device.type == "cpu":
        return fused_mha_plain(qkv, heads, causal)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_mha_packed: unsupported device {qkv.device}")
    b, n, hd, d = _split_dims(qkv, heads)
    if qkv.requires_grad:
        raise RuntimeError("fused_mha_packed: the CUDA kernel is forward-only; "
                           "run under torch.inference_mode() or no_grad()")
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_mha_packed: dtype {qkv.dtype} not supported "
                         "(float32, bfloat16)")
    if d not in HEAD_DIMS or n > MAX_SEQ:
        raise ValueError(f"fused_mha_packed: head_dim {d} / seq {n} outside "
                         f"the kernel's range (head_dim in {HEAD_DIMS}, "
                         f"seq <= {MAX_SEQ})")
    if not qkv.is_contiguous():
        raise ValueError("fused_mha_packed: qkv must be contiguous")
    kernels = load_kernels()
    out = torch.empty((b, n, hd), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = kernels.colxlip_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), b, n, heads, d, int(causal),
        _DTYPE_CODES[qkv.dtype], 1.0 / math.sqrt(d), stream)
    kernels.check(err, "colxlip_attention_fwd")
    LAUNCHES.add()
    return out
