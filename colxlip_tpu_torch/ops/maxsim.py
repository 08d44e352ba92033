"""ColBERT MaxSim late-interaction score, forward and backward.

Port of the MaxSim forward (``colxlip_tpu/ops/maxsim.py`` semantics, TPU
kernel ``colxlip_tpu/ops/maxsim_pallas.py`` ``maxsim_pallas``):

    sim[m, k, n, q] = <text[m, n], image[k, q]>
    S[m, k]         = masked-mean over n of max over q of sim[m, k, n, q]

``mask_mode``: 'nonzero' (mean over n where the max is != 0), 'plain'
(unmasked mean) or 'valid' (weights ``text_mask [M, Lt]``), exactly as
``_masked_mean_from_maxsim`` in the JAX package.

``maxsim`` is differentiable through an ``autograd.Function``. Forward and
backward dispatch on the tensors' device: CPU tensors take ``maxsim_plain``
and ``maxsim_bwd_plain`` (chunked over M, so their temporaries stay
bounded); CUDA tensors launch ``csrc/maxsim.cu`` and ``csrc/maxsim_bwd.cu``
or raise. There is no fallback.

``impl='streaming_int8'`` (``maxsim_int8_forward``, the JAX
``_mknq_max_tiles_int8``) quantizes every token row to int8 with its own
scale, takes the similarities as int8 x int8 -> int32 products
(``ops.quantization.int8_mm``, a library product as in the JAX package,
tiled over 16 texts so no [M, K, Lt, Li] tensor exists) and rescales in
fp32: forward noise of about 1e-2 on unit-norm tokens. Its backward is
straight-through: the default backward on the full-precision inputs (the
backward kernel on the card). Every other name of ``MAXSIM_IMPLS`` computes
the same scores through the one default forward.

Gradient at ties: every image token that attains the max receives the full
cotangent, as in the streaming custom VJP the TPU main path runs
(``colxlip_tpu/ops/maxsim.py`` ``_maxsim_streaming_bwd``). The JAX package's
Pallas backward (``maxsim_pallas.py`` ``_argmax_onehot``) routes to the first
argmax only, and torch's ``amax`` backward splits it evenly; the port
follows the streaming path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .build import LaunchCounter, load_kernels
from .quantization import absmax_scale, int8_mm

# kernel launches (plain-version calls do not count): forward, backward
LAUNCHES = LaunchCounter()
BWD_LAUNCHES = LaunchCounter()
_EPS = 1e-8
MASK_MODES = {"nonzero": 0, "plain": 1, "valid": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the JAX package's implementations; all but 'streaming_int8' compute the same
# scores, and the port's one default implementation routes gradients at ties
# as 'streaming' does (every tied token), which the TPU main path runs
MAXSIM_IMPLS = ("auto", "xla", "streaming", "streaming_int8", "chunked", "pallas")


def _check_args(token_text, token_image, mask_mode, text_mask):
    if mask_mode not in MASK_MODES:
        raise ValueError(f"unknown mask_mode: {mask_mode!r}")
    if mask_mode == "valid" and text_mask is None:
        raise ValueError("mask_mode='valid' needs text_mask [M, Lt]")
    if (token_text.ndim != 3 or token_image.ndim != 3
            or token_text.shape[-1] != token_image.shape[-1]):
        raise ValueError("maxsim needs text [M, Lt, D] and image [K, Li, D]; "
                         f"got {tuple(token_text.shape)} and "
                         f"{tuple(token_image.shape)}")
    if text_mask is not None and mask_mode == "valid" and (
            tuple(text_mask.shape) != tuple(token_text.shape[:2])):
        raise ValueError(f"text_mask must be [M, Lt] = "
                         f"{tuple(token_text.shape[:2])}; got "
                         f"{tuple(text_mask.shape)}")


def masked_mean_from_maxsim(max_sim: torch.Tensor, mask_mode: str,
                            text_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[M, K, Lt] max-sims -> [M, K] mean under the selected masking rule."""
    if mask_mode == "nonzero":
        w = (max_sim != 0).float()
        return (max_sim * w).sum(-1) / (w.sum(-1) + _EPS)
    if mask_mode == "plain":
        return max_sim.mean(-1)
    w = text_mask.float()[:, None, :]
    return (max_sim * w).sum(-1) / (w.sum(-1) + _EPS)


def maxsim_plain(token_text: torch.Tensor, token_image: torch.Tensor, *,
                 mask_mode: str = "nonzero",
                 text_mask: Optional[torch.Tensor] = None,
                 m_chunk: int = 16) -> torch.Tensor:
    """Plain PyTorch version: fp32 similarities m_chunk text rows at a time,
    so the temporary is [m_chunk, Lt, K, Li] fp32, never [M, K, Lt, Li]."""
    _check_args(token_text, token_image, mask_mode, text_mask)
    m, lt, d = token_text.shape
    k, li, _ = token_image.shape
    image = token_image.float().reshape(k * li, d)
    rows = []
    for i in range(0, m, m_chunk):
        t = token_text[i:i + m_chunk].float()
        sim = torch.matmul(t.reshape(-1, d), image.T).reshape(-1, lt, k, li)
        max_sim = sim.amax(dim=-1).permute(0, 2, 1)              # [mc, K, Lt]
        mask = None if text_mask is None else text_mask[i:i + m_chunk]
        rows.append(masked_mean_from_maxsim(max_sim, mask_mode, mask))
    return torch.cat(rows)


def quant_tokens_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 over the feature axis (round to nearest):
    [..., L, D] -> (int8 values, fp32 scales [..., L]). A zero token row (the
    EOT-zeroed text tail the 'nonzero' mask keys on) quantizes to exact
    zeros, so its similarities stay exactly 0."""
    xf = x.float()
    scale = absmax_scale(xf.abs().amax(dim=-1, keepdim=True), 1e-12)
    return torch.round(xf / scale).to(torch.int8), scale[..., 0]


def maxsim_int8_forward(token_text: torch.Tensor, token_image: torch.Tensor, *,
                        mask_mode: str = "nonzero",
                        text_mask: Optional[torch.Tensor] = None,
                        m_chunk: int = 16) -> torch.Tensor:
    """The int8 forward: [M, Lt, D] x [K, Li, D] -> [M, K] fp32. The int32
    sums of a tile are [m_chunk * Lt, K * Li]: 247 MB for 16 texts against 256
    images of 196 tokens, where all 256 texts at once would be 3.9 GB.

    Under 'nonzero', as in the JAX function, a live text token whose largest
    int32 sum over an image's tokens is exactly 0 drops out of that score's
    mean beside the zero rows: an integer sum can be exactly 0, where a float
    one practically never is."""
    _check_args(token_text, token_image, mask_mode, text_mask)
    _device_type(token_text, token_image)
    m, lt, d = token_text.shape
    k, li, _ = token_image.shape
    tq, ts = quant_tokens_int8(token_text)
    iq, is_ = quant_tokens_int8(token_image)
    iq = iq.reshape(k * li, d)
    rows = []
    for i in range(0, m, m_chunk):
        acc = int8_mm(tq[i:i + m_chunk].reshape(-1, d), iq)          # [mc*Lt, K*Li] int32
        sim = acc.float().reshape(-1, lt, k, li) * ts[i:i + m_chunk, :, None, None] * is_
        max_sim = sim.amax(dim=-1).permute(0, 2, 1)                  # [mc, K, Lt]
        mask = None if text_mask is None else text_mask[i:i + m_chunk]
        rows.append(masked_mean_from_maxsim(max_sim, mask_mode, mask))
    return torch.cat(rows)


def maxsim_bwd_plain(token_text: torch.Tensor, token_image: torch.Tensor,
                     g: torch.Tensor, *, mask_mode: str = "nonzero",
                     text_mask: Optional[torch.Tensor] = None,
                     m_chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of ``maxsim``: (dT [M, Lt, D], dI [K, Li, D]) in
    the input dtypes, for the score cotangent ``g`` [M, K].

    The cotangent of max_sim[m, k, n] is g[m, k] * w[m, k, n] / (sum_n w +
    1e-8) ('plain': g[m, k] / Lt), and it reaches EVERY image token that
    attains the max, in full: the streaming custom VJP's convention
    (colxlip_tpu/ops/maxsim.py ``_maxsim_streaming_bwd``). Each chunk routes
    against its own recomputed max, never through ``amax``'s autograd, which
    would split the cotangent between tied tokens. Sums in fp32."""
    _check_args(token_text, token_image, mask_mode, text_mask)
    m, lt, d = token_text.shape
    k, li, _ = token_image.shape
    image = token_image.float().reshape(k * li, d)
    g = g.float()
    dt = torch.empty((m, lt, d), dtype=torch.float32, device=token_text.device)
    di = torch.zeros((k * li, d), dtype=torch.float32, device=token_image.device)
    for i in range(0, m, m_chunk):
        t = token_text[i:i + m_chunk].float().reshape(-1, d)      # [mc*Lt, D]
        sim = torch.matmul(t, image.T).reshape(-1, lt, k, li)     # [mc, Lt, K, Li]
        top = sim.amax(dim=-1, keepdim=True)
        max_sim = top[..., 0].permute(0, 2, 1)                    # [mc, K, Lt]
        if mask_mode == "plain":
            coef = g[i:i + m_chunk, :, None].expand_as(max_sim) / lt
        else:
            w = ((max_sim != 0).float() if mask_mode == "nonzero"
                 else text_mask[i:i + m_chunk].float()[:, None, :].expand_as(max_sim))
            coef = g[i:i + m_chunk, :, None] * w / (w.sum(-1, keepdim=True) + _EPS)
        route = torch.where(sim >= top, coef.permute(0, 2, 1)[..., None], 0.0)
        route = route.reshape(t.shape[0], k * li)
        dt[i:i + m_chunk] = torch.matmul(route, image).reshape(-1, lt, d)
        di += torch.matmul(route.T, t)
    return (dt.to(token_text.dtype),
            di.reshape(k, li, d).to(token_image.dtype))


def _launch_fwd(token_text, token_image, mask_mode, text_mask) -> torch.Tensor:
    """The forward kernel on CUDA tensors (checks shapes, never falls back)."""
    _check_cuda(token_text, token_image, mask_mode, text_mask)
    m, lt, d = token_text.shape
    k, li, _ = token_image.shape
    kernels = load_kernels()
    dev = token_text.device
    max_sim = torch.empty((m, k, lt), dtype=torch.float32, device=dev)
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.colxlip_maxsim_fwd(
        token_text.data_ptr(), token_image.data_ptr(), _mask_ptr(mask_mode, text_mask),
        max_sim.data_ptr(), out.data_ptr(), m, k, lt, li, d, MASK_MODES[mask_mode],
        _DTYPE_CODES[token_text.dtype], stream)
    kernels.check(err, "colxlip_maxsim_fwd")
    LAUNCHES.add()
    return out


def _launch_bwd(token_text, token_image, g, mask_mode, text_mask):
    """The backward kernels on CUDA tensors (checks shapes, never falls back)."""
    _check_cuda(token_text, token_image, mask_mode, text_mask)
    m, lt, d = token_text.shape
    k, li, _ = token_image.shape
    dev = token_text.device
    if g.shape != (m, k) or g.device != dev:
        raise ValueError(f"maxsim backward: g must be [{m}, {k}] on {dev}; got "
                         f"{tuple(g.shape)} on {g.device}")
    g = g.float().contiguous()
    kernels = load_kernels()
    # scratch between the passes: the route pass's max, tie words and single
    # tied token; the coefficients
    max_sim, coef = (torch.empty((m, k, lt), dtype=torch.float32, device=dev) for _ in range(2))
    ties = torch.empty((m, k, lt, -(-li // 32)), dtype=torch.int32, device=dev)
    route_q = torch.empty((m, k, lt), dtype=torch.int32, device=dev)
    dt = torch.empty_like(token_text)
    di = torch.empty_like(token_image)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.colxlip_maxsim_bwd(
        token_text.data_ptr(), token_image.data_ptr(), _mask_ptr(mask_mode, text_mask),
        g.data_ptr(), max_sim.data_ptr(), coef.data_ptr(), ties.data_ptr(),
        route_q.data_ptr(), dt.data_ptr(), di.data_ptr(),
        m, k, lt, li, d, MASK_MODES[mask_mode], _DTYPE_CODES[token_text.dtype], stream)
    kernels.check(err, "colxlip_maxsim_bwd")
    BWD_LAUNCHES.add()
    return dt, di


def _check_cuda(token_text, token_image, mask_mode, text_mask) -> None:
    dev = token_text.device
    if token_text.dtype != token_image.dtype or token_text.dtype not in _DTYPE_CODES:
        raise ValueError(f"maxsim: dtypes {token_text.dtype}/{token_image.dtype}"
                         " not supported (both float32 or both bfloat16)")
    if not (token_text.is_contiguous() and token_image.is_contiguous()):
        raise ValueError("maxsim: text and image tokens must be contiguous")
    if mask_mode == "valid" and (text_mask.device != dev
                                 or text_mask.dtype != torch.float32
                                 or not text_mask.is_contiguous()):
        raise ValueError("maxsim: text_mask must be a contiguous float32 "
                         f"tensor on {dev}")


def _mask_ptr(mask_mode, text_mask):
    return text_mask.data_ptr() if mask_mode == "valid" else None


def _device_type(token_text, token_image) -> str:
    if token_text.device.type == "cpu" and token_image.device.type == "cpu":
        return "cpu"
    dev = token_text.device
    if dev.type != "cuda" or token_image.device != dev:
        raise ValueError(f"maxsim: text on {dev}, image on "
                         f"{token_image.device}; both must be on one CUDA "
                         "device (or both on the CPU)")
    return "cuda"


def _forward(token_text, token_image, mask_mode, text_mask,
             impl: str = "auto") -> torch.Tensor:
    if impl == "streaming_int8":
        return maxsim_int8_forward(token_text, token_image, mask_mode=mask_mode,
                                   text_mask=text_mask)
    if _device_type(token_text, token_image) == "cpu":
        return maxsim_plain(token_text, token_image, mask_mode=mask_mode,
                            text_mask=text_mask)
    return _launch_fwd(token_text, token_image, mask_mode, text_mask)


def _backward(token_text, token_image, g, mask_mode, text_mask):
    if _device_type(token_text, token_image) == "cpu":
        return maxsim_bwd_plain(token_text, token_image, g, mask_mode=mask_mode,
                                text_mask=text_mask)
    return _launch_bwd(token_text, token_image, g, mask_mode, text_mask)


class _MaxSim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, token_text, token_image, text_mask, mask_mode, impl):
        ctx.save_for_backward(token_text, token_image, text_mask)
        ctx.mask_mode = mask_mode
        return _forward(token_text, token_image, mask_mode, text_mask, impl)

    @staticmethod
    def backward(ctx, g):
        token_text, token_image, text_mask = ctx.saved_tensors
        dt, di = _backward(token_text, token_image, g, ctx.mask_mode, text_mask)
        return dt, di, None, None, None


def maxsim(token_text: torch.Tensor, token_image: torch.Tensor, *,
           mask_mode: str = "nonzero",
           text_mask: Optional[torch.Tensor] = None,
           impl: str = "auto") -> torch.Tensor:
    """[M, Lt, D] x [K, Li, D] -> [M, K] float32 MaxSim scores, differentiable
    in both token tensors (never in ``text_mask``).

    ``impl``: a name of ``MAXSIM_IMPLS``. 'streaming_int8' takes the int8
    forward with the default backward (straight-through); every other name
    the default forward. CPU tensors take the plain versions; CUDA tensors
    launch the kernels (any Lt, Li and D, float32 or bfloat16, contiguous)
    or raise."""
    if impl not in MAXSIM_IMPLS:
        raise ValueError(f"unknown impl: {impl!r} (one of {MAXSIM_IMPLS})")
    _check_args(token_text, token_image, mask_mode, text_mask)
    if mask_mode != "valid":
        text_mask = None
    if torch.is_grad_enabled() and (token_text.requires_grad
                                    or token_image.requires_grad):
        return _MaxSim.apply(token_text, token_image, text_mask, mask_mode, impl)
    return _forward(token_text, token_image, mask_mode, text_mask, impl)
