"""Image transforms: port of ``colxlip_tpu/data/transforms.py``.

  train: RandomResizedCrop(size, scale=(0.9, 1.0), bicubic) -> RGB -> float
         -> normalize (OpenAI mean / std)
  eval : shortest-side resize (bicubic) -> center crop -> RGB -> float
         -> normalize

The output is an NHWC numpy array [H, W, 3], the layout the port's
``encode_image`` takes (as the JAX vision tower does): normalized float32,
or raw uint8 RGB with ``normalize_on_device`` (the tower normalizes on the
card, 4x fewer host-to-device bytes). The random draws follow the JAX
transform's order on the same ``random.Random``, so a seeded sample crops
the same box in both packages.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional, Tuple, Union

import numpy as np
from PIL import Image

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass
class PreprocessCfg:
    """What a transform resizes to and normalizes with."""
    size: Union[int, Tuple[int, int]] = 224
    mode: str = "RGB"
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN
    std: Tuple[float, ...] = OPENAI_DATASET_STD
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    fill_color: int = 0

    @property
    def size_hw(self) -> Tuple[int, int]:
        s = self.size
        return (s, s) if isinstance(s, int) else tuple(s)


@dataclasses.dataclass
class AugmentationCfg:
    """The RandomResizedCrop ranges the reference recipes read."""
    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Tuple[float, float] = (3 / 4, 4 / 3)

    @classmethod
    def from_kwargs(cls, kw: dict) -> "AugmentationCfg":
        """Build from ``--aug-cfg k=v`` pairs; an unknown key raises rather
        than train with the defaults."""
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(kw) - valid)
        if unknown:
            raise ValueError(
                f"--aug-cfg got unsupported key(s) {unknown}; this build "
                f"supports {sorted(valid)} (the subset the reference recipes "
                f"read: open_clip's color_jitter/gray_scale/timm keys are "
                f"not implemented)")
        return cls(**{k: tuple(v) if isinstance(v, (list, tuple)) else v
                      for k, v in kw.items()})


_PIL_INTERP = {
    "bicubic": Image.BICUBIC,
    "bilinear": Image.BILINEAR,
    "nearest": Image.NEAREST,
    "lanczos": Image.LANCZOS,
}


def _to_rgb(img: Image.Image) -> Image.Image:
    return img.convert("RGB") if img.mode != "RGB" else img


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    arr = arr.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def sample_rrc_box(w: int, h: int, scale=(0.9, 1.0), ratio=(3 / 4, 4 / 3),
                   rng: Optional[random.Random] = None) -> Tuple[int, int, int, int]:
    """A RandomResizedCrop box (x, y, cw, ch) in image coordinates:
    torchvision's 10 rejection-sampling tries, then a center crop clamped to
    the aspect range. The PIL path and the native decoder share it."""
    rng = rng or random
    area = w * h
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = float(np.exp(rng.uniform(log_ratio[0], log_ratio[1])))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw)
            y = rng.randint(0, h - ch)
            return x, y, cw, ch
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def random_resized_crop(img: Image.Image, size: Tuple[int, int], scale=(0.9, 1.0),
                        ratio=(3 / 4, 4 / 3), interpolation=Image.BICUBIC,
                        rng: Optional[random.Random] = None) -> Image.Image:
    """torchvision RandomResizedCrop: one resize of the drawn box."""
    w, h = img.size
    x, y, cw, ch = sample_rrc_box(w, h, scale, ratio, rng)
    return img.resize(size[::-1], interpolation, box=(x, y, x + cw, y + ch))


def resize_shortest(img: Image.Image, size: int, interpolation=Image.BICUBIC) -> Image.Image:
    w, h = img.size
    short = min(w, h)
    if short == size:
        return img
    scale = size / short
    return img.resize((max(1, int(round(w * scale))),
                       max(1, int(round(h * scale)))), interpolation)


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


class ImageTransform:
    """Callable PIL image -> NHWC array [H, W, 3]: normalized float32, or
    raw uint8 RGB with ``normalize_on_device``. ``ship='yuv420'`` implies
    the uint8 output: the pipeline turns whole batches into planar YUV420
    (``ops.yuv420.apply_ship_format``). ``raw_aug`` picks the augmentation of
    packed raw records (``apply_raw``)."""

    def __init__(self, cfg: PreprocessCfg, is_train: bool,
                 aug: Optional[AugmentationCfg] = None, seed: Optional[int] = None,
                 normalize_on_device: bool = False, raw_aug: str = "rrc",
                 ship: str = "rgb"):
        if raw_aug not in ("rrc", "crop"):
            raise ValueError(f"raw_aug must be 'rrc' or 'crop', got {raw_aug!r}")
        if ship not in ("rgb", "yuv420"):
            raise ValueError(f"ship must be 'rgb' or 'yuv420', got {ship!r}")
        self.cfg = cfg
        self.is_train = is_train
        self.aug = aug or AugmentationCfg()
        self.interp = _PIL_INTERP[cfg.interpolation]
        self.rng = random.Random(seed) if seed is not None else random
        self.normalize_on_device = normalize_on_device or ship == "yuv420"
        self.raw_aug = raw_aug
        self.ship = ship

    def __call__(self, img: Image.Image, rng: Optional[random.Random] = None) -> np.ndarray:
        """``rng`` (a per-sample generator) takes the place of the
        instance's, so a seeded pipeline stays deterministic."""
        img = _to_rgb(img)
        hw = self.cfg.size_hw
        if self.is_train:
            use_rng = rng if rng is not None else (
                self.rng if self.rng is not random else None)
            img = random_resized_crop(img, hw, scale=self.aug.scale, ratio=self.aug.ratio,
                                      interpolation=self.interp, rng=use_rng)
        else:
            img = center_crop(resize_shortest(img, min(hw), self.interp), hw)
        if self.normalize_on_device:
            return np.asarray(img, np.uint8)
        return _normalize(np.asarray(img), self.cfg.mean, self.cfg.std)

    def apply_raw(self, arr: np.ndarray, rng: Optional[random.Random] = None) -> np.ndarray:
        """Transform a pre-decoded uint8 HWC record (``data/pack.py``).
        ``raw_aug='rrc'`` is the PIL path's RandomResizedCrop bit for bit;
        ``'crop'`` a plain random crop of the record (a numpy slice), when
        the record covers the output size."""
        hw = self.cfg.size_hw
        if self.is_train and self.raw_aug == "crop":
            h, w = arr.shape[:2]
            if h >= hw[0] and w >= hw[1]:
                use_rng = rng if rng is not None else self.rng
                y = use_rng.randint(0, h - hw[0])
                x = use_rng.randint(0, w - hw[1])
                out = arr[y:y + hw[0], x:x + hw[1]]
                if self.normalize_on_device:
                    return np.ascontiguousarray(out)
                return _normalize(out, self.cfg.mean, self.cfg.std)
        return self(Image.fromarray(arr), rng=rng)


def image_transform(image_size: Union[int, Tuple[int, int]], is_train: bool,
                    mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD,
                    interpolation: str = "bicubic",
                    aug_cfg: Optional[AugmentationCfg] = None, seed: Optional[int] = None,
                    normalize_on_device: bool = False, raw_aug: str = "rrc",
                    ship: str = "rgb") -> ImageTransform:
    """A train or eval transform."""
    cfg = PreprocessCfg(size=image_size, mean=tuple(mean), std=tuple(std),
                        interpolation=interpolation)
    return ImageTransform(cfg, is_train, aug=aug_cfg, seed=seed,
                          normalize_on_device=normalize_on_device, raw_aug=raw_aug, ship=ship)
