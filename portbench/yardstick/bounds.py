"""The least time each hand-written kernel could take at its shapes.

A frozen copy of the arithmetic the port's chip smoke test uses
(``bound_ms``, ``attention_bounds``, ``maxsim_bound``, ``mlp_bounds`` and the
LayerNorm counts of ``kernel_bounds``), on shapes instead of tensors: each
input read once and each output written once at the memory rate, against
the operations at the peak rate of the input type. The larger of the two is
the bound. The attention and MLP backward counts include the one product
each kernel recomputes (five products: 10 B H N^2 D and 10 R D H), as the
kernels' own bounds always have; ``flops.py`` counts the model's FLOPs
without it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .peaks import ELEMENT_BYTES, PEAK_BYTES_PER_S, PEAK_FLOPS


def bound_s(bytes_moved: float, flops: float, dtype: str) -> float:
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def attention_fwd(b: int, n: int, heads: int, head_dim: int, causal: bool, dtype: str) -> float:
    """Packed QKV [B, N, 3 H D] -> out [B, N, H D]: 4 B N H D elements moved,
    4 B H N^2 D flops over the pairs a query meets (N (N + 1) / 2 causal)."""
    hd = heads * head_dim
    pairs = n * (n + 1) / 2 if causal else n * n
    return bound_s(4 * b * n * hd * ELEMENT_BYTES[dtype], 4 * b * pairs * hd, dtype)


def attention_bwd(b: int, n: int, heads: int, head_dim: int, causal: bool, dtype: str) -> float:
    """Reads qkv and dout, writes dqkv (7 B N H D elements); five products."""
    hd = heads * head_dim
    pairs = n * (n + 1) / 2 if causal else n * n
    return bound_s(7 * b * n * hd * ELEMENT_BYTES[dtype], 10 * b * pairs * hd, dtype)


def maxsim(m: int, k: int, lt: int, li: int, d: int, backward: bool, dtype: str) -> float:
    """Text [M, Lt, D] against image [K, Li, D]: 2 M K Lt Li D flops; the
    backward adds dT and dI at 2 M K Lt D each. Features read once (and their
    gradients written once, backward), the fp32 [M, K] scores moved once."""
    feats = (m * lt + k * li) * d * ELEMENT_BYTES[dtype]
    flops = 2 * m * k * lt * li * d + (4 * m * k * lt * d if backward else 0)
    return bound_s(feats * (2 if backward else 1) + m * k * 4, flops, dtype)


def layernorm_fwd(rows: int, d: int, dtype: str) -> float:
    return bound_s(2 * rows * d * ELEMENT_BYTES[dtype], 8 * rows * d, dtype)


def layernorm_bwd(rows: int, d: int, dtype: str) -> float:
    return bound_s(3 * rows * d * ELEMENT_BYTES[dtype], 16 * rows * d, dtype)


def mlp_fwd(rows: int, d: int, h: int, dtype: str) -> float:
    return bound_s((2 * rows * d + 2 * d * h) * ELEMENT_BYTES[dtype], 4 * rows * d * h, dtype)


def mlp_bwd(rows: int, d: int, h: int, dtype: str) -> float:
    return bound_s((3 * rows * d + 6 * d * h) * ELEMENT_BYTES[dtype], 10 * rows * d * h, dtype)


def train_step_bounds(geo, batch: int, dtype: str) -> Dict[str, List[float]]:
    """Every launch of each kernel in one colclip train step of a ColXLIP
    model (``geo``: ``flops.Geometry``), as a list of bounds in seconds.

    Attention: one forward and one backward launch a block of each tower
    (vision full, text causal at the full context). MaxSim: one forward and
    one backward over the batch's [B, Lt, E] text tokens and [B, P, E] patch
    tokens. LayerNorm (when the towers take the fused kernels): ln_1 and
    ln_2 of every block, ln_pre and ln_post over all vision tokens, ln_final,
    and the two of each token head. MLP: one a block."""
    v_rows, t_rows, p_rows = batch * geo.v_tokens, batch * geo.t_ctx, batch * geo.patches
    attn_f = ([attention_fwd(batch, geo.v_tokens, geo.v_heads, geo.v_head_dim, False, dtype)]
              * geo.v_layers
              + [attention_fwd(batch, geo.t_ctx, geo.t_heads, geo.t_head_dim, True, dtype)]
              * geo.t_layers)
    attn_b = ([attention_bwd(batch, geo.v_tokens, geo.v_heads, geo.v_head_dim, False, dtype)]
              * geo.v_layers
              + [attention_bwd(batch, geo.t_ctx, geo.t_heads, geo.t_head_dim, True, dtype)]
              * geo.t_layers)
    ln_shapes: List[Tuple[int, int]] = (
        [(v_rows, geo.v_width)] * (2 * geo.v_layers + 2)
        + [(t_rows, geo.t_width)] * (2 * geo.t_layers + 1)
        + [(p_rows, geo.v_width), (p_rows, geo.embed_dim)]
        + [(t_rows, geo.t_width), (t_rows, geo.embed_dim)])
    mlp_shapes = ([(v_rows, geo.v_width, geo.v_mlp)] * geo.v_layers
                  + [(t_rows, geo.t_width, geo.t_mlp)] * geo.t_layers)
    return {
        "attention_fwd": attn_f,
        "attention_bwd": attn_b,
        "maxsim_fwd": [maxsim(batch, batch, geo.t_ctx, geo.patches, geo.embed_dim, False, dtype)],
        "maxsim_bwd": [maxsim(batch, batch, geo.t_ctx, geo.patches, geo.embed_dim, True, dtype)],
        "layernorm_fwd": [layernorm_fwd(r, d, dtype) for r, d in ln_shapes],
        "layernorm_bwd": [layernorm_bwd(r, d, dtype) for r, d in ln_shapes],
        "mlp_fwd": [mlp_fwd(r, d, h, dtype) for r, d, h in mlp_shapes],
        "mlp_bwd": [mlp_bwd(r, d, h, dtype) for r, d, h in mlp_shapes],
    }
