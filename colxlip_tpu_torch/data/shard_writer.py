"""Seeded WebDataset tar shards in the reference's recaption layout, for
driving the tar pipeline without a dataset download.

Each sample is ``<key>.jpg`` plus ``<key>.json``. The
JPEG is what the reference's scrape writes: img2dataset with
``image_size=512, resize_mode=keep_ratio`` keeps the shorter side at 512
and the longer side as it was (drawn here from 512-768), saved at quality
95; the content is low-frequency (bilinear upsampling of a coarse random
grid), so the files decode like photographs of that size. The JSON holds
``raw_caption`` and the short and long IB / SV / LLA fields of
``captions.CAPTION_KEYS``: the long fields 80-150 words, drawn from the
ImageNet class names. A ``sizes.json`` beside the shards gives the sample
counts (``wds.get_dataset_size``). Every shard draws from its own
``numpy`` generator seeded by (seed, shard), so the bytes do not depend on
the thread pool's order.

    python -m colxlip_tpu_torch.data.shard_writer --out-dir shards --shards 8 \\
        --per-shard 384          # shards/0000.tar .. 0007.tar + sizes.json
"""
from __future__ import annotations

import argparse
import io
import json
import os
import tarfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..training.imagenet_classnames import IMAGENET_CLASSNAMES
from .captions import CAPTION_KEYS

_WORDS = np.array(sorted({w.lower() for name in IMAGENET_CLASSNAMES
                          for w in name.replace("-", " ").split() if w.isalpha()}))


def seeded_jpeg(rng: np.random.Generator, h: int, w: int, quality: int) -> bytes:
    coarse = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(buf, format="JPEG",
                                                                 quality=quality)
    return buf.getvalue()


def _sentence(rng: np.random.Generator, lo: int, hi: int) -> str:
    return " ".join(_WORDS[rng.integers(0, len(_WORDS), int(rng.integers(lo, hi + 1)))])


def seeded_captions(rng: np.random.Generator) -> dict:
    """``raw_caption`` and the six recaption fields; a long field is 80-150
    words in sentences of 8-20."""
    meta = {"raw_caption": _sentence(rng, 4, 12)}
    for key in CAPTION_KEYS[1:]:
        if key.startswith("short"):
            meta[key] = [_sentence(rng, 6, 16)]
            continue
        total, sentences = int(rng.integers(80, 151)), []
        while total > 0:
            n = min(total, int(rng.integers(8, 21)))
            sentences.append(_sentence(rng, n, n))
            total -= n
        meta[key] = [". ".join(sentences) + "."]
    return meta


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_shard(path: str, shard: int, samples: int, *, seed: int = 0,
                short_side: int = 512, long_side: Tuple[int, int] = (512, 768),
                quality: int = 95) -> int:
    """Write one shard; returns its bytes."""
    rng = np.random.default_rng([seed, shard])
    with tarfile.open(path + ".tmp", "w") as tf:
        for i in range(samples):
            key = f"{shard:04d}{i:05d}"
            long = int(rng.integers(long_side[0], long_side[1] + 1))
            h, w = (short_side, long) if rng.integers(2) else (long, short_side)
            _add(tf, f"{key}.jpg", seeded_jpeg(rng, h, w, quality))
            _add(tf, f"{key}.json", json.dumps(seeded_captions(rng)).encode())
    os.replace(path + ".tmp", path)
    return os.path.getsize(path)


def write_shards(out_dir: str, shards: int, per_shard: int, *, seed: int = 0,
                 short_side: int = 512, long_side: Tuple[int, int] = (512, 768),
                 quality: int = 95, workers: Optional[int] = None) -> Tuple[List[str], float, int]:
    """``shards`` tars of ``per_shard`` samples under ``out_dir`` plus
    ``sizes.json``, one thread a shard (PIL's resize and encode release the
    GIL). Returns (paths, seconds, bytes)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"{s:04d}.tar") for s in range(shards)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers or min(shards, os.cpu_count() or 1)) as pool:
        sizes = list(pool.map(
            lambda s: write_shard(paths[s], s, per_shard, seed=seed, short_side=short_side,
                                  long_side=long_side, quality=quality),
            range(shards)))
    with open(os.path.join(out_dir, "sizes.json"), "w") as f:
        json.dump({os.path.basename(p): per_shard for p in paths}, f)
    return paths, time.perf_counter() - t0, sum(sizes)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", required=True)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--per-shard", type=int, default=384)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--short-side", type=int, default=512)
    p.add_argument("--long-side", type=int, nargs=2, default=(512, 768))
    p.add_argument("--quality", type=int, default=95)
    args = p.parse_args(argv)
    paths, secs, size = write_shards(args.out_dir, args.shards, args.per_shard, seed=args.seed,
                                     short_side=args.short_side,
                                     long_side=tuple(args.long_side), quality=args.quality)
    print(f"wrote {len(paths)} shards, {args.shards * args.per_shard} samples, "
          f"{size / 1e6:.1f} MB in {secs:.1f} s -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
