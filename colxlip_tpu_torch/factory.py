"""Model factory: port of ``create_model`` / ``load_weights`` from
``colxlip_tpu/factory.py``.

``create_model(name, device, dtype)`` builds ``ColXLIP`` when "colxlip" is in
the name, else ``CLIP``, with fp32 parameters and ``dtype`` compute (the JAX
service's bf16 policy by default), initialised from a seeded
``torch.Generator`` on the CPU (the same weights whatever the device), then
moved to ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from .convert import load_pt_state_dict
from .models import CLIP, CLIPCfg, ColXLIP, get_model_config, list_models
from .models.layers import Linear, MultiHeadAttention
from .models.vision import PatchEmbed


def model_config(model_name: str, quick_gelu: Optional[bool] = None) -> CLIPCfg:
    cfg_dict = get_model_config(model_name)
    if cfg_dict is None:
        raise RuntimeError(f"Model config for {model_name} not found; "
                           f"available: {list_models()}")
    if "coca" in model_name.lower():
        raise NotImplementedError("CoCa models are not yet ported in "
                                  "colxlip_tpu_torch")
    cfg = CLIPCfg.from_dict(cfg_dict)
    if quick_gelu is not None:
        cfg = dataclasses.replace(cfg, quick_gelu=quick_gelu)
    return cfg


@torch.no_grad()
def init_weights(model: CLIP, generator: torch.Generator) -> None:
    """Random init at the JAX package's scales (lecun-normal dense kernels
    and zero biases; the text tower's depth-scaled block normals)."""
    def normal_(p: torch.Tensor, std: float) -> None:
        p.normal_(0.0, std, generator=generator)

    for mod in model.modules():
        if isinstance(mod, Linear):
            normal_(mod.weight, mod.weight.shape[1] ** -0.5)
            mod.bias.zero_()
        elif isinstance(mod, MultiHeadAttention):
            normal_(mod.in_proj_weight, mod.in_proj_weight.shape[1] ** -0.5)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, PatchEmbed):
            normal_(mod.weight, mod.weight[0].numel() ** -0.5)
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.02)
    vis, cfg = model.visual, model.cfg
    width = cfg.vision_cfg.width
    for p in (vis.class_embedding, vis.positional_embedding, vis.proj):
        normal_(p, width ** -0.5)
    tw, tl = cfg.text_cfg.width, cfg.text_cfg.layers
    normal_(model.positional_embedding, 0.01)
    normal_(model.text_projection, tw ** -0.5)
    proj_std = tw ** -0.5 * (2 * tl) ** -0.5
    for block in model.transformer.resblocks:
        normal_(block.attn.in_proj_weight, tw ** -0.5)
        normal_(block.attn.out_proj.weight, proj_std)
        normal_(block.mlp.c_fc.weight, (2 * tw) ** -0.5)
        normal_(block.mlp.c_proj.weight, proj_std)
    model.logit_scale.fill_(cfg.init_logit_scale)


def create_model(model_name: str, device: Union[str, torch.device],
                 dtype: torch.dtype = torch.bfloat16, *, seed: int = 0,
                 quick_gelu: Optional[bool] = None) -> Tuple[CLIP, CLIPCfg]:
    """(model on ``device`` in eval mode, its config), seeded random init."""
    cfg = model_config(model_name, quick_gelu)
    cls = ColXLIP if "colxlip" in model_name.lower() else CLIP
    model = cls(cfg, dtype=dtype)
    init_weights(model, torch.Generator(device="cpu").manual_seed(seed))
    return model.to(device).eval(), cfg


def load_weights(model: CLIP, checkpoint_path: str) -> None:
    """Load an OpenCLIP-layout .pt checkpoint into ``model``. Every key must
    match, except that a plain-CLIP checkpoint may leave a ColXLIP model's
    token heads at their init (the JAX package's tag-strip reuse)."""
    sd = load_pt_state_dict(checkpoint_path)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    heads = ("vision_token_layer.", "text_token_layer.")
    missing = [k for k in missing if not k.startswith(heads)]
    if missing or unexpected:
        raise RuntimeError(f"{checkpoint_path}: missing keys {missing[:8]}, "
                           f"unexpected keys {unexpected[:8]}")
