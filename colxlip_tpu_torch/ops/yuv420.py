"""Planar YUV 4:2:0 feed: port of ``colxlip_tpu/ops/yuv420.py``.

Half the host-to-device bytes of raw RGB (1.5 bytes a pixel, 12 for float32):

  host   : uint8 RGB [H, W, 3] -> planar uint8 [H*3//2, W] (rows 0..H-1 = Y;
           rows H.. = Cb | Cr side by side at H/2 x W/2), BT.601 full range
           (the JPEG matrix), 2x2 box chroma, integer arithmetic in numpy;
  device : ``decode_yuv420``, plain tensor code on the batch's device in
           fp32: the triangle (libjpeg "fancy") chroma upsample along each
           axis and one 3 x 3 affine that composes YUV -> RGB with the
           (x/255 - mean)/std normalisation.

The JAX package's device half is plain XLA code, not a Pallas kernel, so it
is plain PyTorch here. H and W must be even.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# BT.601 full-range RGB -> YCbCr in 16-bit fixed point (within 1 LSB of the
# float matrix)
_Y_R, _Y_G, _Y_B = 19595, 38470, 7471          # 0.299, 0.587, 0.114
_CB_R, _CB_G, _CB_B = -11059, -21709, 32768    # -0.168736, -0.331264, 0.5
_CR_R, _CR_G, _CR_B = 32768, -27439, -5329     # 0.5, -0.418688, -0.081312

# YCbCr -> RGB: R = Y + 1.402 Cr'; G = Y - 0.344136 Cb' - 0.714136 Cr';
# B = Y + 1.772 Cb' (Cb' = Cb - 128, Cr' = Cr - 128)
_INV = np.array([[1.0, 0.0, 1.402],
                 [1.0, -0.344136, -0.714136],
                 [1.0, 1.772, 0.0]], np.float32)


def yuv420_rows(h: int) -> int:
    """Planar row count for an image of height ``h``."""
    return h + h // 2


def rgb_to_yuv420(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., H, W, 3] -> planar uint8 [..., H*3//2, W]; leading
    dims pass through. Chroma is the matrix on the rounded 2x2 box mean of
    R, G and B (the matrix is linear)."""
    if rgb.dtype != np.uint8 or rgb.shape[-1] != 3:
        raise ValueError(f"expected uint8 [..., H, W, 3], got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[-3], rgb.shape[-2]
    if h % 2 or w % 2:
        raise ValueError(f"YUV420 needs even H, W; got {h}x{w}")
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    y = (_Y_R * r + _Y_G * g + _Y_B * b + 32768) >> 16

    def box(c):
        s = c[..., 0::2, 0::2] + c[..., 0::2, 1::2] + c[..., 1::2, 0::2] + c[..., 1::2, 1::2]
        return (s + 2) >> 2

    rs, gs, bs = box(r), box(g), box(b)
    cb = ((_CB_R * rs + _CB_G * gs + _CB_B * bs + 32768) >> 16) + 128
    cr = ((_CR_R * rs + _CR_G * gs + _CR_B * bs + 32768) >> 16) + 128
    out = np.empty(rgb.shape[:-3] + (yuv420_rows(h), w), np.uint8)
    out[..., :h, :] = np.clip(y, 0, 255)
    out[..., h:, : w // 2] = np.clip(cb, 0, 255)
    out[..., h:, w // 2:] = np.clip(cr, 0, 255)
    return out


def apply_ship_format(transform, imgs: np.ndarray, native: bool = False) -> np.ndarray:
    """The wire format of an assembled batch: with ``transform.ship ==
    'yuv420'`` a uint8 RGB [B, H, W, 3] batch leaves the host as planar
    YUV420 [B, H*3//2, W], through the native core when ``native`` (the
    caller has built it: ``--native-decode``; bit-equal to numpy)."""
    if getattr(transform, "ship", "rgb") == "yuv420" and imgs.dtype == np.uint8 \
            and imgs.ndim == 4:
        if native:
            from .. import native as native_core

            return native_core.rgb_to_yuv420(imgs)
        return rgb_to_yuv420(imgs)
    return imgs


def split_planes(yuv, h: int, w: int):
    """planar [..., H*3//2, W] -> (Y [..., H, W], Cb, Cr [..., H/2, W/2])."""
    return yuv[..., :h, :], yuv[..., h:, : w // 2], yuv[..., h:, w // 2:]


def _upsample2x_triangle_np(c: np.ndarray, axis: int) -> np.ndarray:
    """libjpeg 'fancy' 2x upsample along ``axis`` (float, no rounding):
    out[2i] = (3 c[i] + c[i-1]) / 4, out[2i+1] = (3 c[i] + c[i+1]) / 4, the
    edges clamped."""
    c = np.moveaxis(c, axis, -1)
    prev = np.concatenate([c[..., :1], c[..., :-1]], axis=-1)
    nxt = np.concatenate([c[..., 1:], c[..., -1:]], axis=-1)
    even = (3.0 * c + prev) * 0.25
    odd = (3.0 * c + nxt) * 0.25
    out = np.stack([even, odd], axis=-1).reshape(c.shape[:-1] + (2 * c.shape[-1],))
    return np.moveaxis(out, -1, axis)


def yuv420_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """Numpy reference decode: planar uint8 [..., H*3//2, W] -> float32 RGB
    [..., H, W, 3] in 0..255 (not normalized, not clipped); the oracle of
    ``decode_yuv420``."""
    rows, w = yuv.shape[-2], yuv.shape[-1]
    h = rows * 2 // 3
    y, cb, cr = split_planes(yuv, h, w)
    y = y.astype(np.float32)
    cbu = _upsample2x_triangle_np(_upsample2x_triangle_np(cb.astype(np.float32), -2), -1) - 128.0
    cru = _upsample2x_triangle_np(_upsample2x_triangle_np(cr.astype(np.float32), -2), -1) - 128.0
    r = y + 1.402 * cru
    g = y - 0.344136 * cbu - 0.714136 * cru
    b = y + 1.772 * cbu
    return np.stack([r, g, b], axis=-1)


def _upsample2x_triangle(c: torch.Tensor, dim: int) -> torch.Tensor:
    c = c.movedim(dim, -1)
    prev = torch.cat([c[..., :1], c[..., :-1]], dim=-1)
    nxt = torch.cat([c[..., 1:], c[..., -1:]], dim=-1)
    even = (3.0 * c + prev) * 0.25
    odd = (3.0 * c + nxt) * 0.25
    out = torch.stack([even, odd], dim=-1).reshape(*c.shape[:-1], 2 * c.shape[-1])
    return out.movedim(-1, dim)


def decode_yuv420(yuv: torch.Tensor, mean: Sequence[float], std: Sequence[float]
                  ) -> torch.Tensor:
    """planar uint8 [B, H*3//2, W] -> normalized float32 RGB [B, H, W, 3] on
    ``yuv``'s device: out = A [Y, Cb-128, Cr-128] + b with
    A = INV / (255 std_c) and b = -mean_c / std_c."""
    rows, w = yuv.shape[-2], yuv.shape[-1]
    h = rows * 2 // 3
    if yuv420_rows(h) != rows:
        raise ValueError(f"not a planar YUV420 batch: {tuple(yuv.shape)}")
    y = yuv[..., :h, :].float()
    cb = yuv[..., h:, : w // 2].float()
    cr = yuv[..., h:, w // 2:].float()
    cbu = _upsample2x_triangle(_upsample2x_triangle(cb, -2), -1) - 128.0
    cru = _upsample2x_triangle(_upsample2x_triangle(cr, -2), -1) - 128.0
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    a = (_INV / (255.0 * std[:, None])).astype(np.float32)     # [3 out, 3 in]
    b = (-mean / std).astype(np.float32)
    v = torch.stack([y, cbu, cru], dim=-1)                       # [B, H, W, 3]
    return v @ torch.from_numpy(a.T).to(v.device) + torch.from_numpy(b).to(v.device)


def psnr(ref: np.ndarray, test: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    mse = float(np.mean((ref.astype(np.float64) - test.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
