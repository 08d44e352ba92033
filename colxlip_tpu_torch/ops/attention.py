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
    to the plain versions. Both dtypes stream key tiles of 64 past a block's
    64 rows, so both take any sequence length: bfloat16 on the tensor cores
    (``mma.sync`` tiles), float32 as register-blocked fp32 FMAs on the CUDA
    cores (``csrc/attention_tile.cuh`` ``attn32``).

The dispatch of ``colxlip_tpu/ops/attention.py`` sits beside the kernels:
``multi_head_attention`` on [B, N, H, D] tensors takes the path that
``resolve_impl`` names. 'fused' is the kernels above (self-attention
repacked to [B, N, 3 H D]); 'xla' is ``F.scaled_dot_product_attention``
(the library path); 'xla_bf16' the hand-written softmax with probabilities
stored in bfloat16; 'xla_remat' SDPA recomputed in the backward; 'flash'
SDPA pinned to its flash backend. An explicit additive mask always takes
'xla'.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .build import LaunchCounter, load_kernels

# kernel launches (plain-version calls do not count): forward, backward
LAUNCHES = LaunchCounter()
BWD_LAUNCHES = LaunchCounter()
HEAD_DIMS = (32, 64)
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


def _check_aligned(t: torch.Tensor, name: str, what: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must start at a 16-byte aligned "
                         "address (the kernels copy 16 bytes at a time)")


def _check_cuda(qkv: torch.Tensor, heads: int, name: str):
    b, n, hd, d = _split_dims(qkv, heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {qkv.dtype} not supported "
                         "(float32, bfloat16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} outside the kernel's range "
                         f"(head_dim in {HEAD_DIMS})")
    if n < 1 or b < 1:
        raise ValueError(f"{name}: empty qkv {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    _check_aligned(qkv, name, "qkv")
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
    _check_aligned(dout, "fused_mha_packed backward", "dout")
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
    (D in {32, 64}, contiguous, from a 16-byte aligned address; float32 and
    bfloat16 at any N) or raise."""
    _split_dims(qkv, heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedMHA.apply(qkv, heads, causal)
    return _forward(qkv, heads, causal)


def mma_tile_check(a: torch.Tensor, b: torch.Tensor, rows: int = 64):
    """The building blocks of csrc/mma_tile.cuh on one bare tile: from
    bfloat16 ``a`` and ``b`` [64, 64] on the card returns (a . b^T,
    bf16(a . b^T) . b, a^T . b) in float32, with the rows at and past
    ``rows`` of both read as zeros. For tests of the fragment layouts; no
    path calls it."""
    for t in (a, b):
        if t.shape != (64, 64) or t.dtype != torch.bfloat16 or not t.is_cuda \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("mma_tile_check: contiguous aligned bfloat16 [64, 64] "
                             "CUDA tensors")
    kernels = load_kernels()
    c_abt = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    c_pb, c_tn = torch.empty_like(c_abt), torch.empty_like(c_abt)
    err = kernels.colxlip_mma_tile_check(
        a.data_ptr(), b.data_ptr(), c_abt.data_ptr(), c_pb.data_ptr(), c_tn.data_ptr(), rows,
        torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check(err, "colxlip_mma_tile_check")
    return c_abt, c_pb, c_tn


# ---------------------------------------------------------------------------
# the dispatch (colxlip_tpu/ops/attention.py)
# ---------------------------------------------------------------------------

ATTN_IMPLS = ("fused", "flash", "xla", "xla_bf16", "xla_remat")


def resolve_impl(impl: str = "auto") -> str:
    """'auto' -> ``COLXLIP_ATTN_IMPL`` if set, else 'fused' on every device
    (on the CPU 'fused' is the plain version). Any other name is returned as
    it is; ``multi_head_attention`` refuses the unknown ones. The JAX
    function takes 'fused' on the TPU only and 'xla' elsewhere: here the
    kernels are the default on the card, and the CPU runs their plain
    version so that the CPU and the card take one path.

    While ``torch.export`` traces (``serving/aot.py``: a symbolic batch),
    'fused' resolves to 'xla', as the JAX dispatch leaves the Pallas kernel
    for the XLA path when a dim is symbolic (``colxlip_tpu/models/layers.py``
    ``MultiHeadAttention``): the bundle's attention is SDPA, with no launch
    of the kernels."""
    if impl == "auto":
        impl = os.environ.get("COLXLIP_ATTN_IMPL") or "fused"
    if impl == "fused" and torch.compiler.is_exporting():
        return "xla"
    return impl


def check_impl(impl: str) -> str:
    """``impl`` after ``resolve_impl``; an unknown name raises."""
    impl = resolve_impl(impl)
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (COLXLIP_ATTN_IMPL or attn_impl); "
                         f"one of {sorted(ATTN_IMPLS)}")
    return impl


def _bhnd(*tensors: torch.Tensor):
    return [t.transpose(1, 2) for t in tensors]


def _causal_keep(n: int, m: int, device) -> torch.Tensor:
    """[n, m] bool, True where key j may be seen from query i (j <= i)."""
    return torch.ones(n, m, dtype=torch.bool, device=device).tril()


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None, causal: bool = False) -> torch.Tensor:
    """The library path: ``F.scaled_dot_product_attention`` on q [B, N, H, D],
    k / v [B, M, H, D] -> [B, N, H, D]. ``mask`` is an additive bias that
    broadcasts to [B, H, N, M]; it and ``causal`` compose (SDPA refuses
    ``is_causal`` with a mask, so the two become one bias: the JAX docstring
    names the bug of dropping the causal mask when a bias is given). The
    scores are scaled as SDPA scales them, by multiplying with 1/sqrt(D), as
    ``jax.nn.dot_product_attention`` does, not by the kernels' plain
    versions' division."""
    qt, kt, vt = _bhnd(q, k, v)
    if mask is None:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    else:
        bias = mask.to(q.dtype)
        if causal:
            keep = _causal_keep(q.shape[1], k.shape[1], q.device)
            bias = bias + torch.zeros(keep.shape, dtype=q.dtype, device=q.device).masked_fill(
                ~keep, float("-inf"))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
    return out.transpose(1, 2)


def _manual_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      probs_dtype: torch.dtype) -> torch.Tensor:
    """Hand-written attention: fp32 scores scaled by 1/sqrt(D), softmax in
    fp32, the probabilities STORED in ``probs_dtype``, then PV summed in fp32
    and returned in the dtype that ``probs_dtype`` and v's promote to."""
    n, m, d = q.shape[1], k.shape[1], q.shape[-1]
    qt, kt, vt = _bhnd(q, k, v)
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        logits = logits.masked_fill(~_causal_keep(n, m, q.device), float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(probs_dtype)
    out = torch.matmul(probs.float(), vt.float()).to(torch.promote_types(probs_dtype, v.dtype))
    return out.transpose(1, 2)


def xla_bf16_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False) -> torch.Tensor:
    """``_manual_attention`` with bfloat16 probabilities (the JAX package's
    CPU numerics for attention rounded to bf16: normalised probabilities)."""
    return _manual_attention(q, k, v, causal=causal, probs_dtype=torch.bfloat16)


def xla_remat_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False) -> torch.Tensor:
    """SDPA under ``torch.utils.checkpoint``: nothing is saved between the
    forward and the backward but the inputs; the backward runs the forward
    again."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return xla_attention(q, k, v, causal=causal)
    return torch.utils.checkpoint.checkpoint(
        functools.partial(xla_attention, causal=causal), q, k, v, use_reentrant=False)


def flash_attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False) -> torch.Tensor:
    """SDPA pinned to its flash backend on [B, N, H, D] tensors. The JAX
    function wraps the TPU library's flash kernel; this one raises where
    torch has no flash backend for the device and dtype (on the card: not
    float32)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = _bhnd(q, k, v)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    return out.transpose(1, 2)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         mask: Optional[torch.Tensor] = None, causal: bool = False,
                         impl: str = "auto") -> torch.Tensor:
    """q [B, N, H, D], k / v [B, M, H, D] -> [B, N, H, D] through the path
    ``impl`` names (``resolve_impl``; unknown names raise). An explicit
    additive ``mask`` always takes 'xla'. 'fused' repacks self-attention
    (N == M) to [B, N, 3 H D] for ``fused_mha_packed``; cross-attention takes
    'xla'. The towers hand their packed projection to ``packed_attention``,
    which skips the repack."""
    impl = check_impl(impl)
    if mask is None:
        if impl == "fused" and q.shape[1] == k.shape[1] == v.shape[1]:
            b, n, h, d = q.shape
            qkv = torch.cat([t.reshape(b, n, h * d) for t in (q, k, v)], dim=-1)
            return fused_mha_packed(qkv, h, causal).reshape(b, n, h, d)
        if impl == "flash":
            return flash_attention_bnhd(q, k, v, causal=causal)
        if impl == "xla_bf16":
            return xla_bf16_attention(q, k, v, causal=causal)
        if impl == "xla_remat":
            return xla_remat_attention(q, k, v, causal=causal)
    return xla_attention(q, k, v, mask=mask, causal=causal)


def packed_attention(qkv: torch.Tensor, heads: int, causal: bool = False, impl: str = "auto",
                     *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention on a packed projection [B, N, 3 H D] -> [B, N, H D].
    'fused' without a mask hands it to ``fused_mha_packed`` as it is, with
    no split and no transpose; other names, and any ``mask``, split it and go
    through ``multi_head_attention``."""
    impl = check_impl(impl)
    if mask is None and impl == "fused":
        return fused_mha_packed(qkv, heads, causal)
    b, n, three_hd = qkv.shape
    q, k, v = (t.reshape(b, n, heads, -1) for t in qkv.chunk(3, dim=-1))
    out = multi_head_attention(q, k, v, mask=mask, causal=causal, impl=impl)
    return out.reshape(b, n, three_hd // 3)
