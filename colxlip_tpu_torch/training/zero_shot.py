"""Zero-shot ImageNet classification: port of
``colxlip_tpu/training/zero_shot.py``.

A prompt-ensemble classifier from the class names (the 80 OpenAI templates,
or the 7 of ``SIMPLE_TEMPLATES``), kept on the model's device, then top-1 and
top-5 over a torchvision-layout validation folder. Class names resolve in
the JAX order: an explicit ``classnames_path``, then
``<val_dir>/classnames.json``, then the vendored OpenAI list
(``imagenet_classnames.py``). The towers run in eval mode under
``torch.no_grad()``; the top-5 is numpy's argsort of the logits on the host,
as in the JAX function.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .evaluate import inference, model_device, synchronize

logger = logging.getLogger(__name__)

OPENAI_IMAGENET_TEMPLATES: List[Callable[[str], str]] = [
    lambda c: f"a bad photo of a {c}.",
    lambda c: f"a photo of many {c}.",
    lambda c: f"a sculpture of a {c}.",
    lambda c: f"a photo of the hard to see {c}.",
    lambda c: f"a low resolution photo of the {c}.",
    lambda c: f"a rendering of a {c}.",
    lambda c: f"graffiti of a {c}.",
    lambda c: f"a bad photo of the {c}.",
    lambda c: f"a cropped photo of the {c}.",
    lambda c: f"a tattoo of a {c}.",
    lambda c: f"the embroidered {c}.",
    lambda c: f"a photo of a hard to see {c}.",
    lambda c: f"a bright photo of a {c}.",
    lambda c: f"a photo of a clean {c}.",
    lambda c: f"a photo of a dirty {c}.",
    lambda c: f"a dark photo of the {c}.",
    lambda c: f"a drawing of a {c}.",
    lambda c: f"a photo of my {c}.",
    lambda c: f"the plastic {c}.",
    lambda c: f"a photo of the cool {c}.",
    lambda c: f"a close-up photo of a {c}.",
    lambda c: f"a black and white photo of the {c}.",
    lambda c: f"a painting of the {c}.",
    lambda c: f"a painting of a {c}.",
    lambda c: f"a pixelated photo of the {c}.",
    lambda c: f"a sculpture of the {c}.",
    lambda c: f"a bright photo of the {c}.",
    lambda c: f"a cropped photo of a {c}.",
    lambda c: f"a plastic {c}.",
    lambda c: f"a photo of the dirty {c}.",
    lambda c: f"a jpeg corrupted photo of a {c}.",
    lambda c: f"a blurry photo of the {c}.",
    lambda c: f"a photo of the {c}.",
    lambda c: f"a good photo of the {c}.",
    lambda c: f"a rendering of the {c}.",
    lambda c: f"a {c} in a video game.",
    lambda c: f"a photo of one {c}.",
    lambda c: f"a doodle of a {c}.",
    lambda c: f"a close-up photo of the {c}.",
    lambda c: f"a photo of a {c}.",
    lambda c: f"the origami {c}.",
    lambda c: f"the {c} in a video game.",
    lambda c: f"a sketch of a {c}.",
    lambda c: f"a doodle of the {c}.",
    lambda c: f"a origami {c}.",
    lambda c: f"a low resolution photo of a {c}.",
    lambda c: f"the toy {c}.",
    lambda c: f"a rendition of the {c}.",
    lambda c: f"a photo of the clean {c}.",
    lambda c: f"a photo of a large {c}.",
    lambda c: f"a rendition of a {c}.",
    lambda c: f"a photo of a nice {c}.",
    lambda c: f"a photo of a weird {c}.",
    lambda c: f"a blurry photo of a {c}.",
    lambda c: f"a cartoon {c}.",
    lambda c: f"art of a {c}.",
    lambda c: f"a sketch of the {c}.",
    lambda c: f"a embroidered {c}.",
    lambda c: f"a pixelated photo of a {c}.",
    lambda c: f"itap of the {c}.",
    lambda c: f"a jpeg corrupted photo of the {c}.",
    lambda c: f"a good photo of a {c}.",
    lambda c: f"a plushie {c}.",
    lambda c: f"a photo of the nice {c}.",
    lambda c: f"a photo of the small {c}.",
    lambda c: f"a photo of the weird {c}.",
    lambda c: f"the cartoon {c}.",
    lambda c: f"art of the {c}.",
    lambda c: f"a drawing of the {c}.",
    lambda c: f"a photo of the large {c}.",
    lambda c: f"a black and white photo of a {c}.",
    lambda c: f"the plushie {c}.",
    lambda c: f"a dark photo of a {c}.",
    lambda c: f"itap of a {c}.",
    lambda c: f"graffiti of the {c}.",
    lambda c: f"a toy {c}.",
    lambda c: f"itap of my {c}.",
    lambda c: f"a photo of a cool {c}.",
    lambda c: f"a photo of a small {c}.",
    lambda c: f"a tattoo of the {c}.",
]

SIMPLE_TEMPLATES: List[Callable[[str], str]] = [
    lambda c: f"itap of a {c}.",
    lambda c: f"a bad photo of the {c}.",
    lambda c: f"a origami {c}.",
    lambda c: f"a photo of the large {c}.",
    lambda c: f"a {c} in a video game.",
    lambda c: f"art of the {c}.",
    lambda c: f"a photo of the small {c}.",
]


def load_classnames(path: str) -> List[str]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        # {"0": "tench", ...} or {"0": ["n01440764", "tench"], ...}
        items = sorted(data.items(), key=lambda kv: int(kv[0]))
        return [v[-1] if isinstance(v, list) else v for _, v in items]
    return list(data)


def _pooled(out) -> torch.Tensor:
    return (out[0] if isinstance(out, tuple) else out).float()


def build_zero_shot_classifier(model: torch.nn.Module, tokenizer, classnames: Sequence[str],
                               templates: Sequence[Callable[[str], str]] = OPENAI_IMAGENET_TEMPLATES,
                               batch_classes: int = 32) -> torch.Tensor:
    """[embed_dim, num_classes] float32 prompt-ensemble weights on the
    model's device: each class's normalised text features averaged over the
    templates, then normalised (+1e-12)."""
    device = model_device(model)
    num_templates = len(templates)
    weights = []
    with inference(model):
        for start in range(0, len(classnames), batch_classes):
            chunk = classnames[start:start + batch_classes]
            texts = [t(c) for c in chunk for t in templates]
            tokens = torch.from_numpy(np.asarray(tokenizer(texts))).to(device)
            emb = _pooled(model.encode_text(tokens, normalize=True))
            emb = emb.reshape(len(chunk), num_templates, -1).mean(dim=1)
            weights.append(emb / (emb.norm(dim=-1, keepdim=True) + 1e-12))
    return torch.cat(weights).T.contiguous()


def iter_imagenet_val(val_dir: str, transform, batch_size: int):
    """torchvision-layout val dir: val/<class_dir>/*.JPEG, class dirs sorted."""
    from PIL import Image

    class_dirs = sorted(
        d for d in os.listdir(val_dir) if os.path.isdir(os.path.join(val_dir, d))
    )
    images, labels = [], []
    for label, cdir in enumerate(class_dirs):
        full = os.path.join(val_dir, cdir)
        for fname in sorted(os.listdir(full)):
            images.append(os.path.join(full, fname))
            labels.append(label)
    for i in range(0, len(images), batch_size):
        batch = []
        for path in images[i : i + batch_size]:
            with Image.open(path) as img:
                batch.append(transform(img))
        yield np.stack(batch), np.asarray(labels[i : i + batch_size])


def resolve_classnames(val_dir: str, classnames_path: Optional[str] = None) -> List[str]:
    """An explicit path, then ``<val_dir>/classnames.json``, then the
    vendored OpenAI list."""
    if classnames_path is None:
        candidate = os.path.join(val_dir, "classnames.json")
        classnames_path = candidate if os.path.exists(candidate) else None
    if classnames_path is not None:
        return load_classnames(classnames_path)
    from .imagenet_classnames import IMAGENET_CLASSNAMES

    return IMAGENET_CLASSNAMES


def zero_shot_eval(model: torch.nn.Module, tokenizer, transform, val_dir: str, *,
                   classnames_path: Optional[str] = None, batch_size: int = 256,
                   use_simple_templates: bool = False) -> Dict[str, float]:
    """Top-1 / top-5 zero-shot accuracy over ``val_dir``; ``{}`` for an empty
    folder. Logs the classifier's seconds and the images' (host load and
    transform apart)."""
    classnames = resolve_classnames(val_dir, classnames_path)
    templates = SIMPLE_TEMPLATES if use_simple_templates else OPENAI_IMAGENET_TEMPLATES
    device = model_device(model)
    t0 = time.perf_counter()
    classifier = build_zero_shot_classifier(model, tokenizer, classnames, templates)
    synchronize(device)
    t1 = time.perf_counter()

    top1 = top5 = n = 0
    load = 0.0
    with inference(model):
        batches = iter_imagenet_val(val_dir, transform, batch_size)
        while True:
            t_wait = time.perf_counter()
            item = next(batches, None)
            load += time.perf_counter() - t_wait
            if item is None:
                break
            images, labels = item
            feats = _pooled(model.encode_image(
                torch.from_numpy(images).to(device), normalize=True))
            logits = (feats @ classifier).cpu().numpy()
            top = np.argsort(-logits, axis=1)[:, :5]
            top1 += int((top[:, 0] == labels).sum())
            top5 += int((top == labels[:, None]).any(axis=1).sum())
            n += len(labels)
    logger.info("zero-shot seconds: classifier (%d classes x %d templates) %.3f, images "
                "(%d) %.3f of which host load + transform %.3f", len(classnames),
                len(templates), t1 - t0, n, time.perf_counter() - t1, load)
    if n == 0:
        return {}
    return {"imagenet-zeroshot-val-top1": top1 / n,
            "imagenet-zeroshot-val-top5": top5 / n}
