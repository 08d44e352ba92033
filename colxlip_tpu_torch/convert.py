"""Weights in and out of the port.

``state_dict_from_jax_params`` turns the JAX package's parameter tree
(nested mappings of numpy arrays, as ``model.init`` returns them) into the
port's state dict, in pure numpy. It mirrors
``colxlip_tpu/training/checkpoint.py`` ``export_pt_state_dict``: OpenCLIP keys,
flat text tower, packed ``in_proj_weight``, conv-layout ``conv1``, the token
heads as a Sequential. ``.pt`` is the exchange format in both directions.
CoCa trees use the OpenCLIP keys that the JAX importer
(``convert_openclip_state_dict``) reads: ``cls_emb``,
``text_decoder.resblocks.*``, ``text_decoder.cross_attn.*`` (q / k / v packed
into one ``attn.in_proj_weight``), ``text_decoder.ln_final`` and
``text_decoder.text_projection`` (the ``to_logits`` kernel [width, vocab] as
it is). An ``AttentionalPooler`` (``attn_pool``, in the vision tower or
CoCa's) keeps its JAX path: ``query``, ``ln_q``, ``ln_k``,
``attn.{q,k,v,out}_proj``.

``load_pt_state_dict`` reads an OpenCLIP-layout ``.pt`` checkpoint (the
``--checkpoint`` of the server, the ``--pretrained`` of the trainer).

``int8_params_from_jax`` turns the int8 trees of the JAX
``serving.int8.quantize_vision_params`` / ``quantize_text_params`` into the
port's, so both encoders can run on identical int8 weights.

``load_optax_adamw_state`` carries an optax AdamW state (``mu``, ``nu`` and
the step count, as numpy) into a ``torch.optim.AdamW``, so that both
packages can go on from one train state.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Union

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
_CROSS_BLOCK = re.compile(r"^cross_attn_(\d+)$")
_CROSS = {
    ("ln_1", "scale"): "ln_1.weight", ("ln_1", "bias"): "ln_1.bias",
    ("ln_1_kv", "scale"): "ln_1_kv.weight", ("ln_1_kv", "bias"): "ln_1_kv.bias",
    ("ln_2", "scale"): "ln_2.weight", ("ln_2", "bias"): "ln_2.bias",
}


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


def _attn_pool(tree: Mapping, prefix: str, out: dict, unmapped: list) -> None:
    """An AttentionalPooler subtree: the JAX path, Dense kernels transposed."""
    for sub, v in _leaves(tree):
        v = np.asarray(v)
        if sub == ("query",):
            out[prefix + "query"] = v
        elif len(sub) == 2 and sub[0] in ("ln_q", "ln_k"):
            out[f"{prefix}{sub[0]}.{'weight' if sub[1] == 'scale' else 'bias'}"] = v
        elif len(sub) == 3 and sub[0] == "attn" and sub[2] in ("kernel", "bias"):
            leaf = "weight" if sub[2] == "kernel" else "bias"
            out[f"{prefix}attn.{sub[1]}.{leaf}"] = v.T if leaf == "weight" else v
        else:
            unmapped.append(prefix + ".".join(sub))


def _cross_block(block: Mapping, prefix: str, out: dict, unmapped: list) -> None:
    """A CoCa cross-attention block: q / k / v packed into one in_proj."""
    attn = block.get("attn", {})
    names = ("q_proj", "k_proj", "v_proj")
    if all(n in attn for n in names):
        out[prefix + "attn.in_proj_weight"] = np.concatenate(
            [np.asarray(attn[n]["kernel"]).T for n in names])
        out[prefix + "attn.in_proj_bias"] = np.concatenate(
            [np.asarray(attn[n]["bias"]) for n in names])
    for sub, v in _leaves(block):
        v = np.asarray(v)
        if sub[:2] in (("attn", n) for n in names):
            continue
        if sub in _CROSS:
            out[prefix + _CROSS[sub]] = v
            continue
        conv = _BLOCK.get(sub)
        if conv is None:
            unmapped.append(prefix + ".".join(sub))
            continue
        key, transpose = conv
        out[prefix + key] = v.T if transpose else v


def state_dict_from_jax_params(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX params tree (``{'params': {...}}`` or the inner dict) -> OpenCLIP
    key -> float32 numpy array, equal to ``export_pt_state_dict``'s output
    for CLIP and ColXLIP trees."""
    p = params.get("params", params)
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
        elif k == "attn_pool":
            _attn_pool(v, "visual.attn_pool.", out, unmapped)
        else:
            unmapped.append(f"visual.{k}")

    for k, v in p.get("text", {}).items():
        if k == "token_embedding":
            out["token_embedding.weight"] = np.asarray(v["embedding"])
        elif k in ("positional_embedding", "cls_emb"):
            out[k] = np.asarray(v)
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

    if "attn_pool" in p:
        _attn_pool(p["attn_pool"], "attn_pool.", out, unmapped)
    for k, v in p.get("text_decoder", {}).items():
        self_block, cross = _RESBLOCK.match(k), _CROSS_BLOCK.match(k)
        if self_block:
            _transformer({k: v}, "text_decoder.resblocks.", out, unmapped)
        elif cross:
            _cross_block(v, f"text_decoder.cross_attn.{cross.group(1)}.", out, unmapped)
        elif k == "ln_final":
            out["text_decoder.ln_final.weight"] = np.asarray(v["scale"])
            out["text_decoder.ln_final.bias"] = np.asarray(v["bias"])
        else:
            unmapped.append(f"text_decoder.{k}")
    if "to_logits" in p:
        out["text_decoder.text_projection"] = np.asarray(p["to_logits"]["kernel"])
    for k in ("logit_scale", "logit_bias"):
        if k in p:
            out[k] = np.asarray(p[k]).reshape(())
    if unmapped:
        raise ValueError(f"params with no .pt mapping: {unmapped[:8]}"
                         + ("..." if len(unmapped) > 8 else ""))
    return {k: v.astype(np.float32) for k, v in out.items()}


def int8_params_from_jax(tree: Mapping, device: Union[str, torch.device] = "cpu") -> dict:
    """A JAX int8 tree (``colxlip_tpu.serving.int8.quantize_vision_params`` or
    ``quantize_text_params``, leaves readable by numpy) -> the port's
    (``colxlip_tpu_torch.serving.int8``): every quantized weight ``q``
    [in, out] is transposed to [out, in] (the channel moves from axis 1 to
    axis 0, ``scale`` stays [out]), LayerNorm ``scale`` becomes ``weight``,
    every other leaf is copied."""
    def tensor(v) -> torch.Tensor:
        return torch.from_numpy(np.array(v, order="C")).to(device)

    def convert(node):
        if node is None:
            return None
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        if not isinstance(node, Mapping):
            return tensor(node)
        if "q" in node:
            out = {"q": tensor(np.asarray(node["q"]).T), "scale": tensor(node["scale"])}
            if "bias" in node:
                out["bias"] = tensor(node["bias"])
            return out
        if set(node) == {"scale", "bias"}:                       # a LayerNorm
            return {"weight": tensor(node["scale"]), "bias": tensor(node["bias"])}
        return {k: convert(v) for k, v in node.items()}

    return convert(tree)


def load_pt_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """An OpenCLIP-layout .pt checkpoint -> state dict on the CPU. Accepts a
    bare state dict or {'state_dict': ...}, and strips DDP's ``module.``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else None
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state-dict checkpoint")
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_optax_adamw_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                           mu: Mapping, nu: Mapping, count: Union[int, np.ndarray]) -> int:
    """Load optax ``scale_by_adam`` moments into ``optimizer``.

    ``mu`` and ``nu`` are trees shaped like the JAX params (numpy leaves);
    they go through ``state_dict_from_jax_params``, so each moment lands on
    the parameter its weight would, transposed alike. Every parameter the
    optimizer holds gets ``exp_avg``, ``exp_avg_sq`` and ``step = count``.
    Returns ``count``, the number of updates made (the train step's
    ``step``)."""
    first, second = state_dict_from_jax_params(mu), state_dict_from_jax_params(nu)
    names = {p: name for name, p in model.named_parameters()}
    count = int(count)
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[p]
            # np.array(order="C"), not ascontiguousarray: that one turns the
            # 0-d logit_scale into shape (1,)
            m, v = (torch.from_numpy(np.array(sd[name], order="C")).to(p.device, p.dtype)
                    for sd in (first, second))
            if m.shape != p.shape:
                raise ValueError(f"{name}: moment {tuple(m.shape)} for a parameter "
                                 f"{tuple(p.shape)}")
            optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": m,
                                  "exp_avg_sq": v}
    return count
