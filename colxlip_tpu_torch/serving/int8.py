"""int8 post-training-quantized encoders (serving path, both towers): port
of ``colxlip_tpu/serving/int8.py``.

A functional forward of the vision and text towers (``models/vision.py``,
``models/text.py``), mirrored exactly, whose Dense layers run:

  - WEIGHTS:     per-output-channel symmetric int8, quantized once from the
                 trained fp32 weights (``quantize_vision_params``,
                 ``quantize_text_params``), round to nearest.
  - ACTIVATIONS: per-token (row-wise absmax) dynamic symmetric int8.
  - MATMUL:      int8 x int8 -> int32 (``ops.quantization.int8_mm``, the
                 library's product, as ``lax.dot_general`` in the JAX module).
  - EPILOGUE:    dequantization (row scale x channel scale), bias, then
                 LayerNorm / GELU in fp32 / bf16 as in the bf16 model; layer
                 outputs are bf16.

The attention core is ``ops.attention.packed_attention`` on the bf16 packed
QKV, with ``attn_impl`` (an ``ops.attention`` name; default 'fused', the
attention kernel on the card and its plain version on the CPU). 'xla_bf16' has the
numerics the JAX module takes off the TPU (``fused_mha_reference``:
normalised probabilities rounded to bf16).

Weight layout: the port's ``Linear`` weights are [out, in] and so are the
int8 values here, ``q`` int8 [out, in] with ``scale`` fp32 [out]: **axis 0 is
the channel**. The JAX trees hold ``q`` [in, out] with the channel on axis 1;
``convert.int8_params_from_jax`` transposes one into the other. The patch
embedding is stored as its matmul, [width, (p p 3)].

Scope, as in the JAX module: the standard ViT serving configuration
(learnable positional embedding, class-token pooling, no attentional pool or
LayerScale; causal text tower pooled at the EOT argmax). Anything else
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attention_ops
from ..ops.quantization import absmax_scale, int8_mm, quantize_rows_int8

Source = Union[nn.Module, Mapping[str, torch.Tensor]]
_DENSE = {"in_proj": ("attn.in_proj_weight", "attn.in_proj_bias"),
          "out_proj": ("attn.out_proj.weight", "attn.out_proj.bias"),
          "c_fc": ("mlp.c_fc.weight", "mlp.c_fc.bias"),
          "c_proj": ("mlp.c_proj.weight", "mlp.c_proj.bias")}


def _quant_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """fp32 [out, in] -> int8 [out, in] and one fp32 scale an output channel
    (round to nearest)."""
    w = w.detach().float().contiguous()
    scale = absmax_scale(w.abs().amax(dim=1), 1e-12)
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _state_dict(source: Source) -> Mapping[str, torch.Tensor]:
    return source.state_dict() if isinstance(source, nn.Module) else source


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float()


def _ln(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {"weight": _fp32(sd[prefix + ".weight"]), "bias": _fp32(sd[prefix + ".bias"])}


def _blocks(sd: Mapping[str, torch.Tensor], prefix: str) -> list:
    blocks = []
    while f"{prefix}{len(blocks)}.ln_1.weight" in sd:
        p = f"{prefix}{len(blocks)}."
        block: Dict[str, Any] = {"ln_1": _ln(sd, p + "ln_1"), "ln_2": _ln(sd, p + "ln_2")}
        for name, (weight, bias) in _DENSE.items():
            block[name] = {**_quant_weight(sd[p + weight]), "bias": _fp32(sd[p + bias])}
        blocks.append(block)
    return blocks


def quantize_vision_params(source: Source) -> Dict[str, Any]:
    """Quantize the Dense weights of a trained vision tower.

    ``source``: the port's model, or its state dict (OpenCLIP keys,
    ``visual.*``). Returns a nested dict with int8 weights and scales for
    every matmul (``q`` [out, in], ``scale`` [out]) and the remaining leaves
    (LayerNorm, embeddings, biases) in fp32, on the source's device."""
    sd = _state_dict(source)
    conv = sd["visual.conv1.weight"]                       # [width, 3, p, p]
    return {
        "class_embedding": _fp32(sd["visual.class_embedding"]),
        "positional_embedding": _fp32(sd["visual.positional_embedding"]),
        "ln_pre": _ln(sd, "visual.ln_pre") if "visual.ln_pre.weight" in sd else None,
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _quant_weight(sd["visual.proj"].T),
        # the patchify matmul's kernel, rows in the tower's (p p 3) order
        "conv1": _quant_weight(conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1)),
        "blocks": _blocks(sd, "visual.transformer.resblocks."),
    }


def quantize_text_params(source: Source) -> Dict[str, Any]:
    """Quantize the Dense weights of a trained text tower (same scheme as
    ``quantize_vision_params``; embeddings, LayerNorm and biases stay fp32)."""
    sd = _state_dict(source)
    return {
        "token_embedding": _fp32(sd["token_embedding.weight"]),
        "positional_embedding": _fp32(sd["positional_embedding"]),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _quant_weight(sd["text_projection"].T),
        "blocks": _blocks(sd, "transformer.resblocks."),
    }


def _qdense(x: torch.Tensor, qw: Mapping[str, torch.Tensor],
            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[..., in] float -> [..., out] through an int8 x int8 -> int32 product.
    Activations: per-row (token) dynamic absmax int8."""
    xq, row_scale = quantize_rows_int8(x.reshape(-1, x.shape[-1]).float(), 1e-12)
    acc = int8_mm(xq, qw["q"])
    y = acc.float() * row_scale * qw["scale"][None, :]
    if "bias" in qw:
        y = y + qw["bias"]
    return y.to(out_dtype).reshape(*x.shape[:-1], qw["q"].shape[0])


def _layernorm(x: torch.Tensor, ln: Mapping[str, torch.Tensor],
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    return (y * ln["weight"] + ln["bias"]).to(out_dtype)


def _blocks_forward(cfg, x: torch.Tensor, blocks, heads: int, causal: bool,
                    attn_impl: str = "fused") -> torch.Tensor:
    for blk in blocks:
        qkv = _qdense(_layernorm(x, blk["ln_1"]), blk["in_proj"])
        attn = attention_ops.packed_attention(qkv, heads, causal, attn_impl)
        x = x + _qdense(attn, blk["out_proj"])
        h = _qdense(_layernorm(x, blk["ln_2"]), blk["c_fc"])
        if cfg.quick_gelu:
            # QuickGELU checkpoints (the OpenAI tags): erf-GELU here would
            # diverge far beyond quantization noise
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h, approximate="tanh" if cfg.gelu_approximate else "none")
        x = x + _qdense(h, blk["c_proj"])
    return x


def _l2_normalize(pooled: torch.Tensor) -> torch.Tensor:
    return pooled / pooled.square().sum(dim=-1, keepdim=True).clamp_min(1e-12).sqrt()


@torch.no_grad()
def vision_encode_int8(cfg, qparams: Mapping[str, Any], images: torch.Tensor, *,
                       normalize: bool = True, attn_impl: str = "fused") -> torch.Tensor:
    """images [B, H, W, 3] (float, or integer 0..255) -> pooled features
    [B, embed_dim] fp32, on the device of ``qparams`` and ``images``.

    ``cfg``: the model's ``CLIPCfg``. Mirrors ``VisionTransformer.forward``
    for the standard serving configuration."""
    vcfg = cfg.vision_cfg
    if (vcfg.attentional_pool or vcfg.ls_init_value is not None
            or vcfg.final_ln_after_pool or vcfg.pool_type != "tok"
            or vcfg.pos_embed_type != "learnable"):
        raise NotImplementedError(
            "int8 serving path covers the standard ViT serving config "
            "(learnable pos-embed, tok pooling, no attn-pool/LayerScale); "
            "use the bf16 model for other configurations")
    b = images.shape[0]
    p = vcfg.patch_size
    gh, gw = images.shape[1] // p, images.shape[2] // p
    if not images.is_floating_point():
        mean = images.new_tensor(vcfg.image_mean, dtype=torch.float32)
        std = images.new_tensor(vcfg.image_std, dtype=torch.float32)
        images = (images.float() / 255.0 - mean) / std

    x = images.float().reshape(b, gh, p, gw, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
    x = _qdense(x, qparams["conv1"])
    cls = qparams["class_embedding"].bfloat16().expand(b, 1, vcfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + qparams["positional_embedding"].bfloat16()
    if qparams.get("ln_pre") is not None:
        x = _layernorm(x, qparams["ln_pre"])
    x = _blocks_forward(cfg, x, qparams["blocks"], vcfg.heads, causal=False,
                        attn_impl=attn_impl)
    x = _layernorm(x, qparams["ln_post"])
    pooled = _qdense(x[:, 0], qparams["proj"], out_dtype=torch.float32)
    return _l2_normalize(pooled) if normalize else pooled


@torch.no_grad()
def text_encode_int8(cfg, qparams: Mapping[str, Any], text: torch.Tensor, *,
                     normalize: bool = True, attn_impl: str = "fused") -> torch.Tensor:
    """text [B, L] integer token ids -> pooled features [B, embed_dim] fp32.

    Mirrors ``encode_text_tower`` for the standard serving configuration:
    causal mask and argmax(EOT) pooling."""
    tcfg = cfg.text_cfg
    if tcfg.pool_type != "argmax" or tcfg.no_causal_mask:
        raise NotImplementedError(
            "int8 text serving covers the standard causal/argmax config; "
            "use the bf16 model for other configurations")
    x = qparams["token_embedding"][text.long()].bfloat16()
    x = x + qparams["positional_embedding"][:text.shape[1]].bfloat16()
    x = _blocks_forward(cfg, x, qparams["blocks"], tcfg.heads, causal=True,
                        attn_impl=attn_impl)
    x = _layernorm(x, qparams["ln_final"])
    pooled = x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
    pooled = _qdense(pooled, qparams["text_projection"], out_dtype=torch.float32)
    return _l2_normalize(pooled) if normalize else pooled
