"""Int8 quantization: port of ``colxlip_tpu/ops/quantization.py``.

``quantize_int8`` is the stochastic-rounding quantizer of a [K, N] weight,
one scale a column (the TPU kernel ``quantize_int8_pallas``):

    scale[j]     = max(max_i |w[i, j]| / 127, 1e-8)
    values[i, j] = clip(floor(w[i, j] / scale[j] + u[i, j]), -127, 127)
    u[i, j]      = (bits >> 8) * 2^-24, uniform in [0, 1) from 24 random bits

``floor(x + u)`` is unbiased: its mean over the noise is x. A CPU tensor
takes ``quantize_int8_plain``; a CUDA tensor launches
``csrc/quantize_int8.cu`` (one launch of thread-block clusters along K, the
weight read once) or raises. There is no fallback, and in particular
never a silent one to round-to-nearest (which is what the JAX wrapper does
off the TPU).

The TPU's own generator cannot be reproduced, so the port agrees with the
JAX kernel in distribution, not in bits. Its bits are Philox4x32-10: key =
the 64-bit seed, counter = (row, column // 4, 0, 0), element (i, j) takes
word j % 4. ``philox4x32_10`` computes those words with int64 tensor
arithmetic, so the kernel and the plain version are equal bit for bit, and
the noise of an element depends on the seed and its position alone. One
property of the fp32 arithmetic, shared with the TPU kernel: ``x + u`` is
rounded to fp32 before the floor, so a value that is already an integer n
moves to n + 1 when u is within half an fp32 step of 1 (at most 2^-18 of
the draws for |n| < 128, and never for n = 0).

The rest of the JAX module is plain tensor code here too: ``quantize_int8_rtn``
(the JAX ``quantize_int8_xla``, round to nearest), ``dequantize_int8``,
``int8_matmul``, ``int8_st_linear`` (int8 forward, straight-through backward)
and ``quantize_params_int8``. The int8 x int8 -> int32 products go through
``int8_mm`` (``torch._int_mm``), as the JAX package leaves them to
``lax.dot_general`` outside any kernel.

Every division by 127 divides by a tensor, never by a Python number: PyTorch
turns a division by a host scalar on CUDA into a multiplication by the
reciprocal, which lands one step away from the IEEE quotient for some
inputs, and the scales must be the same on the CPU, on the card and in the
kernel.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .build import LaunchCounter, load_kernels

# kernel launches (plain-version calls do not count)
LAUNCHES = LaunchCounter()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
# torch._int_mm on CUDA: more than 16 rows, inner and outer sizes multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def absmax_scale(amax: torch.Tensor, floor: float) -> torch.Tensor:
    """max(amax / 127, floor) in fp32, by an IEEE division on every device."""
    amax = amax.float()
    return (amax / amax.new_tensor(127.0)).clamp_min(floor)


def quantize_int8_rtn(w: torch.Tensor, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 by round-to-nearest (half to even), the JAX
    ``quantize_int8_xla``: the absmax is taken over ``axis`` and kept, so for
    a [K, N] weight and axis 0 it returns values int8 [K, N] and scales fp32
    [1, N]."""
    w = w.float()
    scale = absmax_scale(w.abs().amax(dim=axis, keepdim=True), 1e-8)
    return torch.round(w / scale).clamp(-127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _mulhilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * c for a 32-bit constant m and int64
    tensor c in [0, 2^32), without ever exceeding 63 bits: c is split into
    16-bit halves, so each partial product stays below 2^48."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    low = ((b & 0xFFFF) << 16) + (a & _MASK32)
    return (b >> 16) + (a >> 32) + (low >> 32), low & _MASK32


def philox4x32_10(c0: torch.Tensor, c1: torch.Tensor, seed: int):
    """The four 32-bit words of Philox4x32-10 (Salmon et al., SC 2011) for
    the counters (c0, c1, 0, 0) under the key (seed & 2^32 - 1, seed >> 32),
    as int64 tensors of the broadcast shape of c0 and c1."""
    c0, c1 = torch.broadcast_tensors(c0.long(), c1.long())
    c2 = c3 = torch.zeros_like(c0)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def rounding_noise(k: int, n: int, seed: int, device) -> torch.Tensor:
    """u [K, N] fp32 in [0, 1): element (i, j) is the top 24 bits of word
    j % 4 of Philox4x32-10 at counter (i, j // 4, 0, 0), times 2^-24."""
    rows = torch.arange(k, device=device)[:, None]
    groups = torch.arange(-(-n // 4), device=device)[None, :]
    words = torch.stack(philox4x32_10(rows, groups, seed), dim=-1)     # [K, N/4, 4]
    return (words.reshape(k, -1)[:, :n] >> 8).float() * 2.0 ** -24


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"quantize_int8: seed {seed} outside [0, 2^64)")
    return seed


def quantize_int8_plain(w: torch.Tensor, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``quantize_int8`` with the kernel's
    arithmetic, on the tensor's device: values int8 [K, N], scales fp32
    [1, N]. Holds several [K, N] int64 temporaries."""
    if w.ndim != 2:
        raise ValueError(f"quantize_int8 takes a [K, N] weight; got {tuple(w.shape)}")
    seed = _check_seed(seed)
    x = w.float()
    scale = absmax_scale(x.abs().amax(dim=0, keepdim=True), 1e-8)
    u = rounding_noise(w.shape[0], w.shape[1], seed, w.device)
    return torch.floor(x / scale + u).clamp(-127, 127).to(torch.int8), scale


def _launch(w: torch.Tensor, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA tensor (checks, never falls back)."""
    if w.ndim != 2 or w.dtype not in _DTYPE_CODES or not w.is_contiguous() or w.numel() == 0:
        raise ValueError("quantize_int8: a CUDA weight must be a contiguous, non-empty [K, N] "
                         f"float32 or bfloat16 tensor; got {w.dtype} {tuple(w.shape)}"
                         f"{'' if w.is_contiguous() else ', not contiguous'}")
    k, n = w.shape
    kernels = load_kernels()
    values = torch.empty((k, n), dtype=torch.int8, device=w.device)
    scales = torch.empty((1, n), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = kernels.colxlip_quantize_int8(
        w.data_ptr(), values.data_ptr(), scales.data_ptr(), k, n, seed & _MASK32, seed >> 32,
        _DTYPE_CODES[w.dtype], stream)
    kernels.check(err, "colxlip_quantize_int8")
    LAUNCHES.add()
    return values, scales


def quantize_int8(w: torch.Tensor, seed: int = 0,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization of a [K, N] weight, one scale a
    column: values int8 [K, N] and scales fp32 [1, N], computed in fp32.

    ``seed`` (0 <= seed < 2^64) keys the noise: the same seed gives the same
    values, on the CPU and on the card. With a ``generator`` the seed is drawn
    from it instead (one 63-bit integer), so successive calls differ.

    A CPU tensor takes ``quantize_int8_plain``; a CUDA tensor launches the
    kernel (contiguous, 2-D, float32 or bfloat16) or raises."""
    if generator is not None:
        seed = int(torch.randint(0, (1 << 63) - 1, (1,), generator=generator,
                                 device=generator.device))
    seed = _check_seed(seed)
    if w.device.type == "cpu":
        return quantize_int8_plain(w, seed)
    if w.device.type != "cuda":
        raise ValueError(f"quantize_int8: unsupported device {w.device} (the CPU or CUDA)")
    return _launch(w, seed)


def pad_for_int_mm(a: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [R, K] and w [N, K] padded with zeros to what ``torch._int_mm`` takes
    on CUDA: more than 16 rows, K and N multiples of 8."""
    pad_k = -a.shape[1] % _INT_MM_MULTIPLE
    pad_r = max(_INT_MM_MIN_ROWS - a.shape[0], 0)
    pad_n = -w.shape[0] % _INT_MM_MULTIPLE
    if pad_k or pad_r:
        a = F.pad(a, (0, pad_k, 0, pad_r))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    return a, w


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [R, K] x int8 [N, K] -> int32 [R, N] = a @ w.T, exact.

    ``w`` holds one output channel a row (the torch ``Linear`` layout), so the
    product's second operand is a transposed view of a contiguous matrix, the
    operand layout the int8 tensor cores take. On CUDA ``torch._int_mm`` wants
    more than 16 rows and K and N in multiples of 8: smaller or ragged
    operands are padded with zeros, which add nothing to an integer sum, and
    the result is cut back. It never gives way to a float product."""
    if a.dtype != torch.int8 or w.dtype != torch.int8 or a.ndim != 2 or w.ndim != 2 \
            or a.shape[1] != w.shape[1]:
        raise ValueError(f"int8_mm takes int8 [R, K] and [N, K]; got {a.dtype} {tuple(a.shape)} "
                         f"and {w.dtype} {tuple(w.shape)}")
    r, n = a.shape[0], w.shape[0]
    if a.device.type == "cuda":
        a, w = pad_for_int_mm(a, w)
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:r, :n]


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ dequant(q): x [..., K] and the int8 values q [K, N] both rounded
    to bfloat16, the products summed in fp32 (a bf16 x bf16 product is exact
    in fp32), times ``scale``, plus ``bias``, in x's dtype."""
    out = torch.matmul(x.bfloat16().float(), q.bfloat16().float()) * scale
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def quantize_rows_int8(x: torch.Tensor, floor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 of x [R, K] fp32, one scale a row (round to
    nearest): values int8 [R, K], scales fp32 [R, 1] >= ``floor``."""
    scale = absmax_scale(x.abs().amax(dim=1, keepdim=True), floor)
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


def _int8_linear_forward(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y in x's dtype, the int32 sums) of the int8 forward of
    ``int8_st_linear``."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    xq, xs = quantize_rows_int8(x2, 1e-8)
    wq, ws = quantize_int8_rtn(weight, axis=1)                   # [out, in], [out, 1]
    acc = int8_mm(xq, wq)
    y = acc.float() * xs * ws.T + bias.float()
    return y.reshape(*x.shape[:-1], -1).to(x.dtype), acc


class _Int8STLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return _int8_linear_forward(x, weight, bias)[0]

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        dx = torch.matmul(g2, weight.to(g2.dtype)).reshape(x.shape).to(x.dtype)
        dw = torch.matmul(g2.float().T, x2.float()).to(weight.dtype)
        db = g2.float().sum(dim=0).to(ctx.bias_dtype)
        return dx, dw, db


def int8_st_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Linear layer with an int8 forward and a straight-through backward.

    ``weight`` is [out, in], the torch layout (the JAX ``kernel`` transposed):
    its channel axis is 0, one scale an output feature. Forward: dynamic
    per-row symmetric int8 of x, per-output-channel int8 of the weight (both
    round to nearest), int8 x int8 -> int32 product, fp32 rescale by the two
    scales, plus bias, in x's dtype. Backward: the exact gradients of
    ``x @ weight.T + bias`` from the saved full-precision inputs, so training
    sees the quantization as forward noise only: dx in the cotangent's dtype
    (cast to x's), dweight and dbias summed in fp32."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _Int8STLinear.apply(x, weight, bias)
    return _int8_linear_forward(x, weight, bias)[0]


Tree = Union[torch.Tensor, Mapping]


def quantize_params_int8(params: Mapping[str, Tree], *, min_size: int = 1 << 16,
                         axis: int = 0) -> Dict[str, Tree]:
    """Quantize every 2-D tensor of at least ``min_size`` elements in a state
    dict (or a nested mapping of tensors) to ``{'int8': values, 'scale':
    scales}`` by round-to-nearest; every other leaf is kept. ``axis`` is the
    one the absmax is taken over: 0 for a JAX-layout [in, out] kernel (the
    default, as in the JAX function), 1 for a torch-layout [out, in] weight."""
    out: Dict[str, Tree] = {}
    for name, leaf in params.items():
        if isinstance(leaf, Mapping):
            out[name] = quantize_params_int8(leaf, min_size=min_size, axis=axis)
        elif leaf.ndim == 2 and leaf.numel() >= min_size:
            values, scale = quantize_int8_rtn(leaf, axis=axis)
            out[name] = {"int8": values, "scale": scale}
        else:
            out[name] = leaf
    return out
