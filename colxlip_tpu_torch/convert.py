"""Weights in and out of the port.

``state_dict_from_jax_params`` turns the JAX package's parameter tree
(nested mappings of numpy arrays, as ``model.init`` returns them) into the
port's state dict, in pure numpy. It mirrors
``colxlip_tpu/training/checkpoint.py`` ``export_pt_state_dict``: OpenCLIP keys,
flat text tower, packed ``in_proj_weight``, conv-layout ``conv1``, the token
heads as a Sequential. ``.pt`` is the exchange format in both directions.

``load_pt_state_dict`` reads an OpenCLIP-layout ``.pt`` checkpoint (the
``--checkpoint`` of the server).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK = {
    ("ln_1", "scale"): ("ln_1.weight", False),
    ("ln_1", "bias"): ("ln_1.bias", False),
    ("ln_2", "scale"): ("ln_2.weight", False),
    ("ln_2", "bias"): ("ln_2.bias", False),
    ("attn", "in_proj", "kernel"): ("attn.in_proj_weight", True),
    ("attn", "in_proj", "bias"): ("attn.in_proj_bias", False),
    ("attn", "out_proj", "kernel"): ("attn.out_proj.weight", True),
    ("attn", "out_proj", "bias"): ("attn.out_proj.bias", False),
    ("mlp", "c_fc", "kernel"): ("mlp.c_fc.weight", True),
    ("mlp", "c_fc", "bias"): ("mlp.c_fc.bias", False),
    ("mlp", "c_proj", "kernel"): ("mlp.c_proj.weight", True),
    ("mlp", "c_proj", "bias"): ("mlp.c_proj.bias", False),
    ("ls_1", "gamma"): ("ls_1.gamma", False),
    ("ls_2", "gamma"): ("ls_2.gamma", False),
}
_TOKEN_HEAD = {
    ("ln_in", "scale"): ("0.weight", False),
    ("ln_in", "bias"): ("0.bias", False),
    ("proj", "kernel"): ("1.weight", True),
    ("proj", "bias"): ("1.bias", False),
    ("ln_out", "scale"): ("3.weight", False),
    ("ln_out", "bias"): ("3.bias", False),
}
_RESBLOCK = re.compile(r"^resblocks_(\d+)$")


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _transformer(blocks: Mapping, prefix: str, out: dict, unmapped: list) -> None:
    for name, block in blocks.items():
        m = _RESBLOCK.match(name)
        if not m:
            unmapped.append(prefix + name)
            continue
        for sub, v in _leaves(block):
            conv = _BLOCK.get(sub)
            if conv is None:
                unmapped.append(f"{prefix}{m.group(1)}.{'.'.join(sub)}")
                continue
            key, transpose = conv
            v = np.asarray(v)
            out[f"{prefix}{m.group(1)}.{key}"] = v.T if transpose else v


def state_dict_from_jax_params(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX params tree (``{'params': {...}}`` or the inner dict) -> OpenCLIP
    key -> float32 numpy array, equal to ``export_pt_state_dict``'s output."""
    p = params.get("params", params)
    if "text_decoder" in p or "cls_emb" in p.get("text", {}):
        raise ValueError("CoCa trees are not supported (CLIP/ColXLIP only)")
    out: Dict[str, np.ndarray] = {}
    unmapped: list = []

    for k, v in p.get("visual", {}).items():
        if k == "conv1":
            kernel = np.asarray(v["kernel"])  # [(ph pw c), width]
            width = kernel.shape[1]
            ph = int(round((kernel.shape[0] / 3) ** 0.5))
            if ph * ph * 3 != kernel.shape[0]:
                raise ValueError(f"non-square patchify kernel: {kernel.shape}")
            out["visual.conv1.weight"] = (
                kernel.reshape(ph, ph, 3, width).transpose(3, 2, 0, 1))
        elif k in ("class_embedding", "positional_embedding", "proj"):
            out[f"visual.{k}"] = np.asarray(v)
        elif k in ("ln_pre", "ln_post"):
            out[f"visual.{k}.weight"] = np.asarray(v["scale"])
            out[f"visual.{k}.bias"] = np.asarray(v["bias"])
        elif k == "transformer":
            _transformer(v, "visual.transformer.resblocks.", out, unmapped)
        else:
            unmapped.append(f"visual.{k}")

    for k, v in p.get("text", {}).items():
        if k == "token_embedding":
            out["token_embedding.weight"] = np.asarray(v["embedding"])
        elif k == "positional_embedding":
            out["positional_embedding"] = np.asarray(v)
        elif k == "ln_final":
            out["ln_final.weight"] = np.asarray(v["scale"])
            out["ln_final.bias"] = np.asarray(v["bias"])
        elif k == "text_projection":
            if isinstance(v, Mapping):  # Dense variant
                out["text_projection.weight"] = np.asarray(v["kernel"]).T
                if "bias" in v:
                    out["text_projection.bias"] = np.asarray(v["bias"])
            else:
                out["text_projection"] = np.asarray(v)
        elif k == "transformer":
            _transformer(v, "transformer.resblocks.", out, unmapped)
        else:
            unmapped.append(f"text.{k}")

    for head in ("vision_token_layer", "text_token_layer"):
        for sub, v in _leaves(p.get(head, {})):
            conv = _TOKEN_HEAD.get(sub)
            if conv is None:
                unmapped.append(f"{head}.{'.'.join(sub)}")
                continue
            key, transpose = conv
            v = np.asarray(v)
            out[f"{head}.{key}"] = v.T if transpose else v

    for k in ("logit_scale", "logit_bias"):
        if k in p:
            out[k] = np.asarray(p[k]).reshape(())
    if unmapped:
        raise ValueError(f"params with no .pt mapping: {unmapped[:8]}"
                         + ("..." if len(unmapped) > 8 else ""))
    return {k: v.astype(np.float32) for k, v in out.items()}


def load_pt_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """An OpenCLIP-layout .pt checkpoint -> state dict on the CPU. Accepts a
    bare state dict or {'state_dict': ...}, and strips DDP's ``module.``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else None
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state-dict checkpoint")
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}
