"""ColBERT MaxSim late-interaction score, forward.

Port of the MaxSim forward (``colxlip_tpu/ops/maxsim.py`` semantics, TPU
kernel ``colxlip_tpu/ops/maxsim_pallas.py`` ``maxsim_pallas``):

    sim[m, k, n, q] = <text[m, n], image[k, q]>
    S[m, k]         = masked-mean over n of max over q of sim[m, k, n, q]

``mask_mode``: 'nonzero' (mean over n where the max is != 0), 'plain'
(unmasked mean) or 'valid' (weights ``text_mask [M, Lt]``), exactly as
``_masked_mean_from_maxsim`` in the JAX package.

``maxsim`` dispatches on the tensors' device: CPU tensors take
``maxsim_plain`` (chunked over M, so its temporary stays bounded); CUDA
tensors launch ``csrc/maxsim.cu`` or raise. There is no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from .build import LaunchCounter, load_kernels

# kernel launches made by maxsim (plain-version calls do not count)
LAUNCHES = LaunchCounter()
_EPS = 1e-8
MASK_MODES = {"nonzero": 0, "plain": 1, "valid": 2}
MAX_TEXT_TOKENS = 80
MAX_IMAGE_TOKENS = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def maxsim(token_text: torch.Tensor, token_image: torch.Tensor, *,
           mask_mode: str = "nonzero",
           text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[M, Lt, D] x [K, Li, D] -> [M, K] float32 MaxSim scores.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (Lt <= 80, Li <= 256, float32 or bfloat16, contiguous) or raise."""
    _check_args(token_text, token_image, mask_mode, text_mask)
    if token_text.device.type == "cpu" and token_image.device.type == "cpu":
        return maxsim_plain(token_text, token_image, mask_mode=mask_mode,
                            text_mask=text_mask)
    dev = token_text.device
    if dev.type != "cuda" or token_image.device != dev:
        raise ValueError(f"maxsim: text on {dev}, image on "
                         f"{token_image.device}; both must be on one CUDA "
                         "device (or both on the CPU)")
    if token_text.requires_grad or token_image.requires_grad:
        raise RuntimeError("maxsim: the CUDA kernel is forward-only; run "
                           "under torch.inference_mode() or no_grad()")
    if token_text.dtype != token_image.dtype or token_text.dtype not in _DTYPE_CODES:
        raise ValueError(f"maxsim: dtypes {token_text.dtype}/{token_image.dtype}"
                         " not supported (both float32 or both bfloat16)")
    m, lt, d = token_text.shape
    k, li, _ = token_image.shape
    if lt > MAX_TEXT_TOKENS or li > MAX_IMAGE_TOKENS:
        raise ValueError(f"maxsim: Lt={lt} / Li={li} outside the kernel's range "
                         f"(Lt <= {MAX_TEXT_TOKENS}, Li <= {MAX_IMAGE_TOKENS})")
    if not (token_text.is_contiguous() and token_image.is_contiguous()):
        raise ValueError("maxsim: text and image tokens must be contiguous")
    mask_ptr = None
    if mask_mode == "valid":
        if (text_mask.device != dev or text_mask.dtype != torch.float32
                or not text_mask.is_contiguous()):
            raise ValueError("maxsim: text_mask must be a contiguous float32 "
                             f"tensor on {dev}")
        mask_ptr = text_mask.data_ptr()
    kernels = load_kernels()
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.colxlip_maxsim_fwd(
        token_text.data_ptr(), token_image.data_ptr(), mask_ptr, out.data_ptr(),
        m, k, lt, li, d, MASK_MODES[mask_mode], _DTYPE_CODES[token_text.dtype],
        stream)
    kernels.check(err, "colxlip_maxsim_fwd")
    LAUNCHES.add()
    return out
