"""Self-contained serving bundles of both towers through ``torch.export``:
port of ``colxlip_tpu/serving/aot.py``.

The JAX module lowers the jitted towers with ``jax.export`` and bakes the
weights into the serialized StableHLO. Here each tower is traced with
``torch.export.export`` into an ``ExportedProgram`` (the graph of ATen
operations with the parameters as its constants) and written with
``torch.export.save``; ``load_aot_bundle`` reads it back with
``torch.export.load`` and needs no model class, config file or checkpoint.

- **Symbolic batch.** The leading dim is a ``torch.export.Dim``: one bundle
  serves any batch. ``static_batch`` pins it instead.
- **Device.** A program holds the device it was traced on (its constants
  live there), so ``platforms`` is that one device type; loading it for
  another raises with the advice to re-export there, as the JAX loader does
  for a backend the bundle was not lowered for.
- **Attention.** While ``torch.export`` traces, ``ops.attention``
  ``resolve_impl`` turns 'fused' into 'xla' (the JAX dispatch leaves the
  Pallas kernel for XLA under symbolic dims): the bundle's attention is
  SDPA and launches no kernel of ``csrc/``. A model built with
  ``COLXLIP_LN_IMPL`` / ``COLXLIP_MLP_IMPL=fused`` is refused: those kernels
  are not traceable.

Bundle layout (a directory):

    meta.json          format 'colxlip-aot-v1', model name, embed_dim,
                       context/image sizes, image dtype, logit_scale,
                       platforms, static_batch, output names, file bytes
    encode_text.pt2    tokens [b, L] int64 -> (pooled [b, E], token
                       features [b, L, E]?), l2-normalised
    encode_image.pt2   images [b, H, W, 3] float32 or uint8 -> (pooled,
                       token features?), l2-normalised
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

FORMAT = "colxlip-aot-v1"
META_NAME = "meta.json"
_SUFFIX = ".pt2"
TOWERS = ("encode_text", "encode_image")
# the traced example's batch under a symbolic dim: 2, since torch.export
# specialises a dim whose example is 0 or 1
_EXAMPLE_BATCH = 2


class _Tower(nn.Module):
    """``model.encode_<kind>(x, normalize=True)`` as a tuple."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = getattr(self.model, self.method)(x, normalize=True)
        return out if isinstance(out, tuple) else (out,)


def _image_hw(cfg) -> Tuple[int, int]:
    s = cfg.vision_cfg.image_size
    return (s, s) if isinstance(s, int) else tuple(s)


def _check_traceable(model: nn.Module) -> None:
    from ..models.layers import MLP, LayerNorm

    fused = sorted({type(m).__name__ for m in model.modules()
                    if (isinstance(m, LayerNorm) and m.impl == "fused")
                    or (isinstance(m, MLP) and m.fused)})
    if fused:
        raise ValueError(f"export_towers: {fused} modules built under COLXLIP_LN_IMPL / "
                         "COLXLIP_MLP_IMPL=fused run CUDA kernels that torch.export cannot "
                         "trace; build the model on the library path ('xla') to export it")


def export_towers(model: nn.Module, cfg, *, static_batch: Optional[int] = None,
                  uint8_images: bool = False) -> Dict[str, torch.export.ExportedProgram]:
    """Trace both towers on the model's device: {'encode_text': ...,
    'encode_image': ...}. ``static_batch`` None exports a symbolic batch (one
    program, any batch); an int pins it. ``uint8_images`` gives the image
    entry a uint8 input, normalised on the device by the tower."""
    if static_batch is not None and static_batch < 1:
        raise ValueError(f"static_batch must be >= 1, got {static_batch}")
    _check_traceable(model)
    model = model.eval()
    device = next(model.parameters()).device
    b = _EXAMPLE_BATCH if static_batch is None else static_batch
    h, w = _image_hw(cfg)
    ctx = cfg.text_cfg.context_length
    tokens = torch.zeros((b, ctx), dtype=torch.int64, device=device)
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    images = torch.zeros((b, h, w, 3), dtype=torch.uint8 if uint8_images else torch.float32,
                         device=device)
    dynamic = None if static_batch is not None else ({0: torch.export.Dim("b", min=1)},)
    exported = {}
    with torch.no_grad():
        for name, example in (("encode_text", tokens), ("encode_image", images)):
            exported[name] = torch.export.export(_Tower(model, name), (example,),
                                                 dynamic_shapes=dynamic)
    return exported


def save_aot_bundle(out_dir: str, model: nn.Module, cfg, *, model_name: str = "",
                    static_batch: Optional[int] = None, uint8_images: bool = False) -> dict:
    """Export both towers and write the bundle directory; returns its meta."""
    exported = export_towers(model, cfg, static_batch=static_batch, uint8_images=uint8_images)
    os.makedirs(out_dir, exist_ok=True)
    sizes = {}
    for name, ep in exported.items():
        path = os.path.join(out_dir, name + _SUFFIX)
        torch.export.save(ep, path)
        sizes[name] = os.path.getsize(path)
    h, w = _image_hw(cfg)
    n_out = len(exported["encode_text"].graph_signature.user_outputs)
    meta = {
        "format": FORMAT,
        "model": model_name,
        "embed_dim": cfg.embed_dim,
        "context_length": cfg.text_cfg.context_length,
        "image_size": [h, w],
        "image_dtype": "uint8" if uint8_images else "float32",
        "logit_scale": float(model.logit_scale.detach().float().exp()),
        "platforms": [next(model.parameters()).device.type],
        "static_batch": static_batch,
        "outputs": ["pooled", "token_features"][:n_out] or ["pooled"],
        "bytes": sizes,
    }
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


@dataclasses.dataclass
class AotModel:
    """A loaded bundle. ``encode_text`` / ``encode_image`` mirror the live
    model's (a tuple of (pooled, token_features?) tensors on ``device``);
    ``meta`` holds what scoring needs (embed_dim, logit_scale)."""
    meta: dict
    device: torch.device
    _text: nn.Module
    _image: nn.Module

    @property
    def logit_scale(self) -> float:
        return float(self.meta["logit_scale"])

    def _check_batch(self, batch: int, what: str) -> None:
        pinned = self.meta["static_batch"]
        if pinned is not None and batch != pinned:
            raise ValueError(f"{what}: this bundle was exported with static_batch={pinned}, "
                             f"got a batch of {batch}")

    def encode_text(self, tokens) -> Tuple[torch.Tensor, ...]:
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(tokens, torch.Tensor)
                                 else tokens)
        ctx = self.meta["context_length"]
        if tokens.ndim != 2 or tokens.shape[1] != ctx or tokens.is_floating_point():
            raise ValueError(f"tokens must be [b, {ctx}] int64, got {tuple(tokens.shape)}")
        self._check_batch(tokens.shape[0], "tokens")
        with torch.no_grad():
            return tuple(self._text(tokens.to(self.device, torch.int64)))

    def encode_image(self, images) -> Tuple[torch.Tensor, ...]:
        want = torch.uint8 if self.meta["image_dtype"] == "uint8" else torch.float32
        images = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor)
                                 else images)
        h, w = self.meta["image_size"]
        if images.ndim != 4 or tuple(images.shape[1:]) != (h, w, 3):
            raise ValueError(f"images must be [b, {h}, {w}, 3] {self.meta['image_dtype']}, "
                             f"got {tuple(images.shape)}")
        self._check_batch(images.shape[0], "images")
        with torch.no_grad():
            return tuple(self._image(images.to(self.device, want)))


def load_aot_bundle(path: str, device: "str | torch.device" = "cuda") -> AotModel:
    """Read a bundle directory written by ``save_aot_bundle`` for ``device``
    (the card unless told otherwise). Needs no model code; raises when the
    bundle was exported for another device type."""
    device = torch.device(device)
    with open(os.path.join(path, META_NAME)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a colxlip AOT bundle (format={meta.get('format')!r})")
    if device.type not in meta["platforms"]:
        raise ValueError(f"bundle was exported for {meta['platforms']} but the requested "
                         f"device is {device.type!r} — re-export on it "
                         f"(scripts/torch_export_aot.py --device {device.type})")
    programs = [torch.export.load(os.path.join(path, name + _SUFFIX)).module()
                for name in TOWERS]
    return AotModel(meta=meta, device=device, _text=programs[0], _image=programs[1])
