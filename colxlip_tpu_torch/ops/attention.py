"""Packed-QKV multi-head self-attention, forward and backward.

Port of ``colxlip_tpu/ops/fused_attention.py`` ``fused_mha_packed`` (the TPU
default for every self-attention layer of both towers) and its custom VJP.
``fused_mha_packed`` is differentiable: an ``autograd.Function`` whose only
residual is ``qkv``, as in the JAX custom VJP (``_vjp_fwd`` / ``_vjp_bwd``).
Forward and backward each dispatch on the tensor's device:

  - CPU tensor: ``fused_mha_plain`` / ``fused_mha_bwd_plain``, the same
    functions in plain PyTorch.
  - CUDA tensor: the hand-written kernels ``csrc/fused_attention.cu`` and
    ``csrc/fused_attention_bwd.cu``, or an exception. There is no fallback
    to the plain versions.
"""
from __future__ import annotations

import math

import torch

from .build import LaunchCounter, load_kernels

# kernel launches (plain-version calls do not count): forward, backward
LAUNCHES = LaunchCounter()
BWD_LAUNCHES = LaunchCounter()
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


def _heads_view(x: torch.Tensor, parts: int, heads: int) -> torch.Tensor:
    """[B, N, parts*H*D] -> [parts, B, H, N, D] in fp32."""
    b, n, _ = x.shape
    return x.reshape(b, n, parts, heads, -1).permute(2, 0, 3, 1, 4).float()


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 Q.K^T / sqrt(D) with the causal mask (col <= row) as -inf."""
    n, d = q.shape[-2], q.shape[-1]
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def fused_mha_plain(qkv: torch.Tensor, heads: int,
                    causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version, with the TPU kernel's numerics: fp32 scores
    scaled by 1/sqrt(D), causal mask col <= row, e = exp(s - rowmax) cast to
    the input dtype for PV, fp32 PV divided by the fp32 row sum of e.

    Holds the [B, H, N, N] fp32 scores, which the kernel never does."""
    b, n, hd, _ = _split_dims(qkv, heads)
    q, k, v = _heads_view(qkv, 3, heads)                         # [B, H, N, D]
    s = _scores(q, k, causal)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    pv = torch.matmul(e.to(qkv.dtype).float(), v)
    out = (pv / denom).to(qkv.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, n, hd)


def fused_mha_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                        causal: bool = False) -> torch.Tensor:
    """Plain PyTorch backward, with the numerics of the TPU ``_bwd_kernel``:
    p = softmax(s) normalised in fp32, dp = dO.V^T in fp32,
    delta = rowsum(p * dp), dz = p * (dp - delta) * scale cast to the input
    dtype, dV = p(input dtype)^T.dO, dQ = dz.K, dK = dz^T.Q, each summed in
    fp32 and cast to the input dtype. Returns dqkv [B, N, 3*H*D] packed as
    qkv (dQ | dK | dV)."""
    b, n, hd, d = _split_dims(qkv, heads)
    dtype = qkv.dtype
    scale = 1.0 / math.sqrt(d)
    q, k, v = _heads_view(qkv, 3, heads)
    do = _heads_view(dout, 1, heads)[0]
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    dz = (p * (dp - delta) * scale).to(dtype).float()
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do)
    dq = torch.matmul(dz, k)
    dk = torch.matmul(dz.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv]).to(dtype)                   # [3, B, H, N, D]
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, 3 * hd)


def _check_cuda(qkv: torch.Tensor, heads: int, name: str):
    b, n, hd, d = _split_dims(qkv, heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {qkv.dtype} not supported "
                         "(float32, bfloat16)")
    if d not in HEAD_DIMS or n > MAX_SEQ:
        raise ValueError(f"{name}: head_dim {d} / seq {n} outside the "
                         f"kernel's range (head_dim in {HEAD_DIMS}, "
                         f"seq <= {MAX_SEQ})")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    return b, n, hd, d


def _launch_fwd(qkv: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    """The forward kernel on a CUDA tensor (checks shapes, never falls back)."""
    b, n, hd, d = _check_cuda(qkv, heads, "fused_mha_packed")
    kernels = load_kernels()
    out = torch.empty((b, n, hd), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = kernels.colxlip_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), b, n, heads, d, int(causal),
        _DTYPE_CODES[qkv.dtype], 1.0 / math.sqrt(d), stream)
    kernels.check(err, "colxlip_attention_fwd")
    LAUNCHES.add()
    return out


def _launch_bwd(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                causal: bool) -> torch.Tensor:
    """The backward kernels on CUDA tensors (checks shapes, never falls back)."""
    b, n, hd, d = _check_cuda(qkv, heads, "fused_mha_packed backward")
    if dout.shape != (b, n, hd) or dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise ValueError(f"fused_mha_packed backward: dout must be {qkv.dtype} "
                         f"{(b, n, hd)} on {qkv.device}; got {dout.dtype} "
                         f"{tuple(dout.shape)} on {dout.device}")
    dout = dout.contiguous()
    kernels = load_kernels()
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, b, heads, n), dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = kernels.colxlip_attention_bwd(
        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        b, n, heads, d, int(causal), _DTYPE_CODES[qkv.dtype],
        1.0 / math.sqrt(d), stream)
    kernels.check(err, "colxlip_attention_bwd")
    BWD_LAUNCHES.add()
    return dqkv


def _device_type(*tensors: torch.Tensor) -> str:
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda") or any(t.device != tensors[0].device for t in tensors):
        raise ValueError("fused_mha_packed: unsupported device "
                         f"{[str(t.device) for t in tensors]} (CPU or one CUDA device)")
    return kind


def _forward(qkv: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    if _device_type(qkv) == "cpu":
        return fused_mha_plain(qkv, heads, causal)
    return _launch_fwd(qkv, heads, causal)


def _backward(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
              causal: bool) -> torch.Tensor:
    if _device_type(qkv, dout) == "cpu":
        return fused_mha_bwd_plain(qkv, dout, heads, causal)
    return _launch_bwd(qkv, dout, heads, causal)


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, causal):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.causal = heads, causal
        return _forward(qkv, heads, causal)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return _backward(qkv, dout, ctx.heads, ctx.causal), None, None


def fused_mha_packed(qkv: torch.Tensor, heads: int,
                     causal: bool = False) -> torch.Tensor:
    """[B, N, 3*H*D] packed QKV -> [B, N, H*D] attention output, differentiable.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (D in {32, 64}, N <= 256, float32 or bfloat16, contiguous) or raise."""
    _split_dims(qkv, heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedMHA.apply(qkv, heads, causal)
    return _forward(qkv, heads, causal)
