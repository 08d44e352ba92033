"""2-D sin-cos position embeddings and the bicubic resize of a learned
position table: port of ``colxlip_tpu/models/pos_embed.py`` in numpy.

``get_2d_sincos_pos_embed`` fills ``pos_embed_type='sin_cos_2d'``;
``interpolate_pos_embed`` resizes a learned [1 + gh * gw, D] table when a
checkpoint is loaded at another image size (``factory.load_weights``).
"""
from __future__ import annotations

import numpy as np


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """[grid*grid (+1), embed_dim] fixed sin-cos embedding (MAE convention:
    the w coordinate first; a zero row for the class token)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first, matching MAE convention
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = _sincos_1d(embed_dim // 2, grid[0])
    emb_w = _sincos_1d(embed_dim // 2, grid[1])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos_embed = np.concatenate([np.zeros((1, embed_dim)), pos_embed], axis=0)
    return pos_embed.astype(np.float32)


def interpolate_pos_embed(
    pos_embed: np.ndarray,
    new_grid: tuple,
    old_grid: tuple,
    num_prefix_tokens: int = 1,
) -> np.ndarray:
    """Bicubic-resample a learned [1+gh*gw, D] position table (numpy) to a
    new grid; the prefix (class) rows pass through. Sums in float64, result
    in the table's dtype."""
    prefix = pos_embed[:num_prefix_tokens]
    grid_embed = pos_embed[num_prefix_tokens:]
    d = grid_embed.shape[-1]
    oh, ow = old_grid
    nh, nw = new_grid
    grid_embed = np.asarray(grid_embed, np.float64).reshape(oh, ow, d)
    # the weights of F.interpolate(mode='bicubic', antialias=True,
    # align_corners=False), applied along each axis in turn
    wh = _torch_bicubic_weights(oh, nh)
    ww = _torch_bicubic_weights(ow, nw)
    resized = np.einsum("oi,iwd->owd", wh, grid_embed)
    resized = np.einsum("ow,hwd->hod", ww, resized)
    resized = resized.reshape(nh * nw, d).astype(pos_embed.dtype)
    return np.concatenate([np.asarray(prefix), resized], axis=0)


def _torch_bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] row-normalized weights matching
    torch.nn.functional.interpolate(mode='bicubic', antialias=True,
    align_corners=False) along one axis.

    Probed against torch element-for-element: the ANTIALIAS path uses the
    PIL-compatible a=-0.5 cubic (the non-AA path uses a=-0.75), widens the
    kernel by the scale factor when DOWNSCALING, EXCLUDES out-of-range taps
    (no edge folding) and renormalizes the surviving window."""
    a = -0.5

    def cubic(x):
        x = np.abs(x)
        return np.where(
            x <= 1.0, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
            np.where(x < 2.0, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a,
                     0.0))

    scale = n_in / n_out
    kernel_scale = max(scale, 1.0)  # antialias widening (downscale only)
    support = 2.0 * kernel_scale
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale - 0.5
        lo = max(int(np.floor(center - support)) + 1, 0)
        hi = min(int(np.floor(center + support)) + 1, n_in)
        js = np.arange(lo, hi)
        weights = cubic((js - center) / kernel_scale)
        w[i, js] = weights / weights.sum()
    return w
