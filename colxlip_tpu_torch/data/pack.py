"""Packed raw-uint8 shards: port of ``colxlip_tpu/data/pack.py``.

A pack pass decodes every image of a WebDataset tar shard once, offline,
resizes its shortest side to a size just above the train crop, and rewrites
the shard as a tar of raw uint8 RGB records. The train pipeline then reads a
record with a memcpy instead of a JPEG decode; what is left a sample is the
crop (a numpy slice with ``raw_aug='crop'``, or one small PIL bicubic resize
with the exact ``'rrc'``). Records take about 10x the bytes of JPEGs, and
the shuffle buffer holds records, so size ``--shuffle-buffer`` to the
host's memory.

Format: tar member ``<key>.raw`` = 9-byte header ``<4sHHB`` (magic
``b'CXR1'``, height, width, channels) + H*W*C uint8 RGB bytes, row-major.
Caption members (``.json`` / ``.txt``) pass through byte-identical. A packed
directory gets a ``sizes.json`` sidecar, so ``get_dataset_size`` finds the
sample count without ``--train-num-samples``.

    python -m colxlip_tpu_torch.data.pack --urls 'shards/{0000..0007}.tar' \
        --out-dir packed --size 256 --workers 8
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import os
import struct
import tarfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

RAW_MAGIC = b"CXR1"
_HEADER = struct.Struct("<4sHHB")  # magic, height, width, channels


def encode_raw(arr: np.ndarray) -> bytes:
    """uint8 HWC array -> raw record bytes."""
    if arr.dtype != np.uint8 or arr.ndim != 3:
        raise ValueError(f"expected uint8 HWC array, got {arr.dtype} {arr.shape}")
    h, w, c = arr.shape
    if h > 0xFFFF or w > 0xFFFF or c > 0xFF:
        raise ValueError(f"image too large for raw header: {arr.shape}")
    return _HEADER.pack(RAW_MAGIC, h, w, c) + np.ascontiguousarray(arr).tobytes()


def decode_raw(data: bytes) -> np.ndarray:
    """Raw record bytes -> uint8 HWC array (zero-copy view of the payload)."""
    magic, h, w, c = _HEADER.unpack_from(data)
    if magic != RAW_MAGIC:
        raise ValueError(f"bad raw record magic: {magic!r}")
    expect = _HEADER.size + h * w * c
    if len(data) != expect:
        raise ValueError(f"raw record size mismatch: {len(data)} != {expect}")
    return np.frombuffer(data, np.uint8, offset=_HEADER.size).reshape(h, w, c)


def pack_shard(
    src: str,
    dst: str,
    *,
    size: int = 256,
    interpolation: str = "bicubic",
) -> int:
    """Rewrite one wds tar shard with images as pre-decoded raw records.

    Returns the number of samples packed. Unreadable images are skipped with
    a warning (log_and_continue semantics); every non-image member (captions,
    metadata sidecars) passes through byte-identical. Refuses shards that
    already contain ``.raw`` records (re-packing a packed shard would be a
    silent data-losing no-op), and warns when a shard packs to 0 samples.
    """
    from .transforms import _PIL_INTERP, resize_shortest
    from .wds import IMAGE_EXTS, decode_image, iter_tar_samples

    interp = _PIL_INTERP[interpolation]
    tmp = dst + ".tmp"
    count = 0
    with tarfile.open(tmp, "w") as out:
        for sample in iter_tar_samples(src):
            key = sample.get("__key__", b"").decode()
            if "raw" in sample:
                raise ValueError(
                    f"{src}: sample {key!r} already has a .raw member — this "
                    "shard appears to be packed already; refusing to re-pack")
            if not any(ext in sample for ext in IMAGE_EXTS):
                continue
            try:
                img = decode_image(sample)
            except Exception as exn:  # noqa: BLE001 — skip, keep packing
                logger.warning("pack: skipping %s (%r)", key, exn)
                continue
            img = resize_shortest(img, size, interp)
            record = encode_raw(np.asarray(img, np.uint8))
            _add_member(out, f"{key}.raw", record)
            for ext, data in sample.items():
                if ext == "__key__" or ext in IMAGE_EXTS:
                    continue
                _add_member(out, f"{key}.{ext}", data)
            count += 1
    if count == 0:
        logger.warning("pack: %s packed 0 samples (no decodable images)", src)
    os.replace(tmp, dst)
    return count


def _add_member(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def pack_shards(
    urls: str,
    out_dir: str,
    *,
    size: int = 256,
    interpolation: str = "bicubic",
    workers: int = 0,
) -> Tuple[List[str], int]:
    """Pack every shard of a brace-expanded spec into ``out_dir``.

    Writes a ``sizes.json`` sidecar mapping shard basename -> sample count
    (the open_clip sizes convention ``get_dataset_size`` reads). Returns
    (packed shard paths, total samples).
    """
    from .wds import expand_urls

    shard_list, _ = expand_urls(urls)
    if not shard_list:
        raise ValueError(f"no shards matched: {urls}")
    # Shards are written to out_dir/<basename>: a multi-source '::' spec (or a
    # brace spec spanning directories) can expand to colliding basenames, which
    # would race under workers>1 and silently overwrite serially.
    from collections import Counter

    dupes = [b for b, n in Counter(
        os.path.basename(s) for s in shard_list).items() if n > 1]
    if dupes:
        raise ValueError(
            f"duplicate shard basenames across sources (would collide in "
            f"{out_dir}): {sorted(dupes)[:5]}{'...' if len(dupes) > 5 else ''}"
            " — pack each source into its own out dir")
    os.makedirs(out_dir, exist_ok=True)

    def job(src: str) -> Tuple[str, int]:
        dst = os.path.join(out_dir, os.path.basename(src))
        n = pack_shard(src, dst, size=size, interpolation=interpolation)
        logger.info("packed %s -> %s (%d samples)", src, dst, n)
        return dst, n

    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as pool:  # PIL decode releases the GIL
            results = list(pool.map(job, shard_list))
    else:
        results = [job(s) for s in shard_list]

    sizes = {os.path.basename(dst): n for dst, n in results}
    with open(os.path.join(out_dir, "sizes.json"), "w") as f:
        json.dump(sizes, f, indent=0, sort_keys=True)
    total = sum(sizes.values())
    return [dst for dst, _ in results], total


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Pack wds tar shards into pre-decoded raw-uint8 shards "
                    "(removes JPEG decode from the training hot path)")
    p.add_argument("--urls", required=True,
                   help="shard spec, e.g. '/data/shard-{0000..0099}.tar'")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--size", type=int, default=256,
                   help="shortest-side resize at pack time (default 256 "
                        "for 224 train crops)")
    p.add_argument("--interpolation", default="bicubic",
                   choices=["bicubic", "bilinear", "nearest", "lanczos"])
    p.add_argument("--workers", type=int, default=0,
                   help="shard-parallel pack threads")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    paths, total = pack_shards(
        args.urls, args.out_dir, size=args.size,
        interpolation=args.interpolation, workers=args.workers)
    print(f"packed {len(paths)} shards, {total} samples -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
