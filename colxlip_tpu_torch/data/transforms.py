"""Eval image transform: port of ``image_transform(size, is_train=False)``
from ``colxlip_tpu/data/transforms.py``.

Bicubic shortest-side resize, center crop, RGB, OpenAI mean/std normalize;
the output is an NHWC float32 numpy array [H, W, 3], the layout the port's
``encode_image`` takes (as the JAX vision tower does). The train-time
augmentations and the uint8 / YUV420 feeds are not ported yet.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
from PIL import Image

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_shortest(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    short = min(w, h)
    if short == size:
        return img
    scale = size / short
    return img.resize((max(1, int(round(w * scale))),
                       max(1, int(round(h * scale)))), Image.BICUBIC)


def center_crop(img: Image.Image, size: Tuple[int, int]) -> Image.Image:
    th, tw = size
    w, h = img.size
    x = int(round((w - tw) / 2.0))
    y = int(round((h - th) / 2.0))
    if x < 0 or y < 0:  # pad an image smaller than the crop
        canvas = Image.new(img.mode, (max(w, tw), max(h, th)), 0)
        canvas.paste(img, ((max(w, tw) - w) // 2, (max(h, th) - h) // 2))
        img = canvas
        w, h = img.size
        x = int(round((w - tw) / 2.0))
        y = int(round((h - th) / 2.0))
    return img.crop((x, y, x + tw, y + th))


class EvalTransform:
    """PIL image -> normalized NHWC float32 array [H, W, 3]."""

    def __init__(self, size: Union[int, Tuple[int, int]],
                 mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD):
        self.size_hw = (size, size) if isinstance(size, int) else tuple(size)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img: Image.Image) -> np.ndarray:
        if img.mode != "RGB":
            img = img.convert("RGB")
        img = center_crop(resize_shortest(img, min(self.size_hw)), self.size_hw)
        arr = np.asarray(img).astype(np.float32) / 255.0
        return (arr - self.mean) / self.std


def image_transform(image_size: Union[int, Tuple[int, int]], is_train: bool,
                    mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD) -> EvalTransform:
    """The eval transform; ``is_train=True`` is not ported yet and raises."""
    if is_train:
        raise NotImplementedError(
            "train-time augmentation is not yet ported in colxlip_tpu_torch")
    return EvalTransform(image_size, mean, std)
