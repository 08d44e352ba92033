"""Seeded weights and inputs, made on the device in a few large calls.

``make_state(model, seed, device)`` gives every parameter of a ColXLIP model
under its OpenCLIP state-dict name, in fp32 (the type the parameters are
trained and served in), as views into one buffer drawn by one ``randn`` from
a ``torch.Generator`` seeded with ``seed`` on ``device``. The same seed on
the same device gives the same bits, so the program and the reference each
get a copy of their own: the reference draws them again after the program
has been freed.

Scales follow OpenCLIP's initialisation (attention in-projection W^-1/2,
residual out-projections W^-1/2 (2 L)^-1/2, c_fc (2 W)^-1/2, embeddings
0.02 / 0.01, class and positional embedding and projections W^-1/2). Unlike
a fresh initialisation, the LayerNorm gains are 1 + 0.02 z and every bias is
0.02 z, as in a model that has trained: a zero bias would leave the token
heads' outputs for masked text positions exactly zero, a degenerate case
that the run would then measure instead of the model.
"""
from __future__ import annotations

import json
import math
import pathlib
from typing import Dict, List, Tuple

import torch

from .yardstick.flops import Geometry

SOT, EOT = 49406, 49407
LOGIT_SCALE = math.log(1 / 0.07)
BIAS_STD = 0.02
GAIN_STD = 0.02

Leaf = Tuple[str, Tuple[int, ...], float, float]   # name, shape, mean, std


def _block(prefix: str, width: int, layers: int) -> List[Leaf]:
    attn_std = width ** -0.5
    proj_std = width ** -0.5 * (2 * layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    leaves: List[Leaf] = []
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}."
        leaves += [
            (p + "ln_1.weight", (width,), 1.0, GAIN_STD),
            (p + "ln_1.bias", (width,), 0.0, BIAS_STD),
            (p + "attn.in_proj_weight", (3 * width, width), 0.0, attn_std),
            (p + "attn.in_proj_bias", (3 * width,), 0.0, BIAS_STD),
            (p + "attn.out_proj.weight", (width, width), 0.0, proj_std),
            (p + "attn.out_proj.bias", (width,), 0.0, BIAS_STD),
            (p + "ln_2.weight", (width,), 1.0, GAIN_STD),
            (p + "ln_2.bias", (width,), 0.0, BIAS_STD),
            (p + "mlp.c_fc.weight", (4 * width, width), 0.0, fc_std),
            (p + "mlp.c_fc.bias", (4 * width,), 0.0, BIAS_STD),
            (p + "mlp.c_proj.weight", (width, 4 * width), 0.0, proj_std),
            (p + "mlp.c_proj.bias", (width,), 0.0, BIAS_STD),
        ]
    return leaves


def _token_head(prefix: str, width: int, embed: int) -> List[Leaf]:
    return [(prefix + ".0.weight", (width,), 1.0, GAIN_STD),
            (prefix + ".0.bias", (width,), 0.0, BIAS_STD),
            (prefix + ".1.weight", (embed, width), 0.0, width ** -0.5),
            (prefix + ".1.bias", (embed,), 0.0, BIAS_STD),
            (prefix + ".3.weight", (embed,), 1.0, GAIN_STD),
            (prefix + ".3.bias", (embed,), 0.0, BIAS_STD)]


def leaves(g: Geometry) -> List[Leaf]:
    """Every parameter of the ColXLIP model ``g`` describes, in a fixed order."""
    vw, tw, e, p = g.v_width, g.t_width, g.embed_dim, g.patch_size
    out: List[Leaf] = [
        ("visual.class_embedding", (vw,), 0.0, vw ** -0.5),
        ("visual.positional_embedding", (g.v_tokens, vw), 0.0, vw ** -0.5),
        ("visual.proj", (vw, e), 0.0, vw ** -0.5),
        ("visual.conv1.weight", (vw, 3, p, p), 0.0, (3 * p * p) ** -0.5),
        ("visual.ln_pre.weight", (vw,), 1.0, GAIN_STD),
        ("visual.ln_pre.bias", (vw,), 0.0, BIAS_STD),
    ]
    out += _block("visual.transformer", vw, g.v_layers)
    out += [("visual.ln_post.weight", (vw,), 1.0, GAIN_STD),
            ("visual.ln_post.bias", (vw,), 0.0, BIAS_STD),
            ("token_embedding.weight", (g.vocab_size, tw), 0.0, 0.02),
            ("positional_embedding", (g.t_ctx, tw), 0.0, 0.01),
            ("text_projection", (tw, e), 0.0, tw ** -0.5)]
    out += _block("transformer", tw, g.t_layers)
    out += [("ln_final.weight", (tw,), 1.0, GAIN_STD),
            ("ln_final.bias", (tw,), 0.0, BIAS_STD),
            ("logit_scale", (), LOGIT_SCALE, 0.0)]
    out += _token_head("vision_token_layer", vw, e)
    out += _token_head("text_token_layer", tw, e)
    return out


def make_state(g: Geometry, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} of the whole model, drawn from ``seed`` on ``device``."""
    spec = leaves(g)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    views = [v.view(shape) for v, (_, shape, _, _) in zip(flat.split(sizes), spec)]
    torch._foreach_mul_(views, [std for _, _, _, std in spec])
    torch._foreach_add_(views, [mean for _, _, mean, _ in spec])
    return {name: v for v, (name, _, _, _) in zip(views, spec)}


def make_images(n: int, g: Geometry, gen: torch.Generator, device) -> torch.Tensor:
    """[n, H, W, 3] standard-normal float32 images, the synthetic feed's form."""
    return torch.randn((n, g.image_size, g.image_size, 3), generator=gen, device=device)


def make_texts(n: int, g: Geometry, gen: torch.Generator, device,
               lengths) -> torch.Tensor:
    """[n, ctx] int64 token rows: SOT, random ids below SOT, EOT at a length
    (EOT included) drawn from ``lengths``: ``[min, max]``, uniform, or a
    ``{length: count}`` table; zeros after."""
    ctx = g.t_ctx
    if isinstance(lengths, dict):
        table = sorted((int(k), v) for k, v in lengths.items())
        values = torch.tensor([min(k, ctx) for k, _ in table], device=device)
        weights = torch.tensor([float(v) for _, v in table], device=device)
        pick = torch.multinomial(weights, n, replacement=True, generator=gen)
        lengths = values[pick][:, None]
    else:
        lo, hi = lengths
        lengths = torch.randint(lo, min(hi, ctx) + 1, (n, 1), generator=gen, device=device)
    ids = torch.randint(1, SOT, (n, ctx), generator=gen, device=device)
    pos = torch.arange(ctx, device=device)[None, :]
    rows = torch.where(pos < lengths - 1, ids, torch.zeros_like(ids))
    rows = torch.where(pos == lengths - 1, torch.full_like(ids, EOT), rows)
    rows[:, 0] = SOT
    return rows


def caption_lengths(spec):
    """A workload's ``caption_tokens``: ``[min, max]`` as it stands, or the
    name of a table under ``portbench/data/`` (its ``counts``)."""
    if isinstance(spec, str):
        with open(pathlib.Path(__file__).resolve().parent / "data" / f"{spec}.json") as f:
            return json.load(f)["counts"]
    return spec
