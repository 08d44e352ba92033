"""WebDataset tar-shard train pipeline: port of ``colxlip_tpu/data/wds.py``.

  - ``braceexpand``          : shard patterns like ``shards-{0000..0999}.tar``
  - ``expand_urls``          : '::'-joined sources with per-source weights
  - ``resampled_shards``     : shards drawn with replacement, weighted, seeded
                               by (seed, epoch, worker)
  - ``deterministic_shards`` : an epoch-seeded shuffle, then the node and
                               worker split
  - ``iter_tar_samples``     : tar -> {ext: bytes} grouped by key, logging
                               and skipping a corrupt member or shard
  - ``ShuffleBuffer``        : the bounded streaming sample shuffle
  - ``WdsTrainPipeline``     : decode -> transform -> caption sampling ->
                               tokenize -> batch on worker threads, with the
                               equal-batches rounding and rollover.

The random draws, the seeds and the order of every step are the JAX
pipeline's, so with one worker the two give the same batches bit for bit.
With ``native_decode`` the pipeline builds the port's C++ decoder when it is
constructed and raises if it cannot (the JAX pipeline quietly decodes with
PIL then); a member that is not a readable JPEG still takes the per-sample
PIL path, as there.
"""
from __future__ import annotations

import io
import itertools
import json
import logging
import os
import queue
import random
import re
import tarfile
import threading
import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .captions import sample_and_tokenize

logger = logging.getLogger(__name__)

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")


# ---------------------------------------------------------------------------
# shard list expansion
# ---------------------------------------------------------------------------

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def braceexpand(pattern: str) -> List[str]:
    """Expand the numeric ``{0000..0999}`` ranges used by shard specs."""
    m = _BRACE_RE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        head = pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
        out.extend(braceexpand(head))
    return out


def expand_urls(
    urls, weights: Optional[str] = None
) -> Tuple[List[str], Optional[List[float]]]:
    """'::'-joined multi-source expansion with weights (data.py:81-100)."""
    if isinstance(urls, str):
        url_list = urls.split("::")
        if weights is None:
            all_urls: List[str] = []
            for u in url_list:
                all_urls.extend(braceexpand(u))
            return all_urls, None
        weight_list = [float(w) for w in str(weights).split("::")]
        if len(weight_list) != len(url_list):
            raise ValueError(
                f"Expected {len(url_list)} weights to match sources, got {len(weight_list)}"
            )
        all_urls, all_weights = [], []
        for u, w in zip(url_list, weight_list):
            expanded = braceexpand(u)
            all_urls.extend(expanded)
            all_weights.extend([w] * len(expanded))
        return all_urls, all_weights
    return list(urls), list(weights) if weights is not None else None


# ---------------------------------------------------------------------------
# shard selection
# ---------------------------------------------------------------------------

class SharedEpoch:
    """Mutable epoch holder shared with loader threads (data.py:71-78 analog)."""

    def __init__(self, epoch: int = 0):
        self._value = epoch
        self._lock = threading.Lock()

    def set_value(self, epoch: int) -> None:
        with self._lock:
            self._value = epoch

    def get_value(self) -> int:
        with self._lock:
            return self._value


def resampled_shards(
    urls: Sequence[str],
    weights: Optional[Sequence[float]],
    *,
    seed: int,
    epoch: int,
    worker_id: int = 0,
    num_shards: Optional[int] = None,
) -> Iterator[str]:
    """Infinite weighted sampling with replacement (data.py:629-680)."""
    rng = random.Random((seed, epoch, worker_id).__hash__())
    urls = list(urls)
    w = list(weights) if weights is not None else None
    count = 0
    while num_shards is None or count < num_shards:
        if w is None:
            yield rng.choice(urls)
        else:
            yield rng.choices(urls, weights=w, k=1)[0]
        count += 1


def deterministic_shards(
    urls: Sequence[str],
    *,
    seed: int,
    epoch: int,
    rank: int = 0,
    world_size: int = 1,
    worker_id: int = 0,
    num_workers: int = 1,
) -> List[str]:
    """Epoch-seeded shuffle then node/worker split (detshuffle2 + split_by_node
    + split_by_worker, data.py:276-285)."""
    urls = list(urls)
    rng = random.Random(seed + epoch)
    rng.shuffle(urls)
    urls = urls[rank::world_size]
    return urls[worker_id::num_workers]


# ---------------------------------------------------------------------------
# tar streaming
# ---------------------------------------------------------------------------

def log_and_continue(exn: Exception) -> bool:
    """data.py:126-129: warn and keep going on data-plane errors."""
    logger.warning("Handling dataset error (%r). Ignoring.", exn)
    return True


def split_member_name(name: str) -> Tuple[str, str]:
    """webdataset member-name split: key = everything up to the FIRST dot
    after the last '/', ext = the rest (itself possibly dotted, e.g.
    'meta.tsv'). The reference's tar→sample grouping inherits this from
    webdataset's base_plus_ext (used via tarfile_to_samples, reference
    data.py:286-288); a last-dot split would break '<key>.meta.tsv'-style
    sidecar members into phantom samples."""
    dot = name.find(".", name.rfind("/") + 1)
    if dot < 0:
        return name, ""
    return name[:dot], name[dot + 1:]


def iter_tar_samples(
    path: str, handler: Callable[[Exception], bool] = log_and_continue
) -> Iterator[Dict[str, bytes]]:
    """Group tar members by basename into {'__key__', ext: bytes} samples."""
    try:
        stream = tarfile.open(path, mode="r|*")
    except Exception as exn:  # unreadable shard
        if handler(exn):
            return
        raise
    current_key: Optional[str] = None
    sample: Dict[str, bytes] = {}
    try:
        for member in stream:
            if not member.isfile():
                continue
            base, ext = split_member_name(member.name)
            try:
                data = stream.extractfile(member).read()
            except Exception as exn:
                if handler(exn):
                    continue
                raise
            if base != current_key:
                if current_key is not None and sample:
                    yield sample
                current_key = base
                sample = {"__key__": base.encode()}
            sample[ext.lower()] = data
        if current_key is not None and sample:
            yield sample
    except Exception as exn:  # corrupt tar mid-stream
        if not handler(exn):
            raise
    finally:
        stream.close()


def probe_native_sample(sample: Dict[str, bytes], transform, rng):
    """(jpeg_bytes, crop_box | None) for the fused C++ decoder, or None when
    the sample is not a readable JPEG. Shared by the threaded (wds) and grain
    pipelines so the key-probe + aug-gated RandomResizedCrop box draw cannot
    diverge."""
    from .. import native
    from .transforms import sample_rrc_box

    data = sample.get("jpg") or sample.get("jpeg")
    if data is None:
        return None
    info = native.jpeg_info(data)
    if info is None:
        return None
    w, h = info
    aug = getattr(transform, "aug", None)
    box = None
    if transform.is_train and aug is not None:
        box = sample_rrc_box(w, h, aug.scale, aug.ratio, rng)
    return data, box


def _has_image(sample: Dict[str, bytes]) -> bool:
    # 'raw' = packed pre-decoded record (data/pack.py)
    return "raw" in sample or any(ext in sample for ext in IMAGE_EXTS)


def has_image_and_json(sample: Dict[str, bytes]) -> bool:
    """data.py:120-123 filter."""
    return "json" in sample and _has_image(sample)


def has_image_and_txt(sample: Dict[str, bytes]) -> bool:
    """data.py:113-117 filter (plain txt-caption shards)."""
    return "txt" in sample and _has_image(sample)


def decode_image(sample: Dict[str, bytes]):
    from PIL import Image

    for ext in IMAGE_EXTS:
        if ext in sample:
            img = Image.open(io.BytesIO(sample[ext]))
            img.load()
            return img.convert("RGB")
    raise KeyError("no image in sample")


class ShuffleBuffer:
    """Bounded streaming shuffle (webdataset shuffle(bufsize, initial))."""

    def __init__(self, source: Iterator, bufsize: int = 5000, initial: int = 1000,
                 rng: Optional[random.Random] = None):
        self.source = source
        self.bufsize = bufsize
        self.initial = min(initial, bufsize)
        self.rng = rng or random.Random()

    def __iter__(self):
        # webdataset _shuffle semantics: grow the buffer toward bufsize by
        # consuming an extra sample per yield during warmup, POP a random
        # element once `initial` is reached. (The earlier swap-after-append
        # variant double-inserted every item once warm — near-100% sample
        # duplication and unbounded buffer growth.)
        buf: List = []
        source = iter(self.source)

        def pick():
            idx = self.rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            return buf.pop()

        for item in source:
            buf.append(item)
            if len(buf) < self.bufsize:
                try:
                    buf.append(next(source))
                except StopIteration:
                    pass
            if len(buf) >= self.initial:
                yield pick()
        while buf:
            yield pick()


# ---------------------------------------------------------------------------
# full train pipeline
# ---------------------------------------------------------------------------

@dataclass
class WdsConfig:
    urls: str
    weights: Optional[str] = None
    batch_size: int = 64
    num_samples: Optional[int] = None       # --train-num-samples
    resampled: bool = False                 # --dataset-resampled
    seed: int = 0
    num_workers: int = 4
    shuffle_buffer: int = 5000
    shuffle_initial: int = 1000
    num_sampled_captions: int = 1
    max_merged_num: int = 3
    pixelprose: bool = False
    caption_key: str = "json"               # 'json' diverse captions | 'txt'
    rank: int = 0
    world_size: int = 1
    native_decode: bool = False             # fused C++ JPEG decode+crop+resize
    decode_threads: int = 8


def get_dataset_size(shards: Sequence[str]) -> Optional[int]:
    """Discover the sample count from shard-directory sidecars.

    open_clip_train's ``get_dataset_size`` behavior (reference data.py:277-288):
    a ``sizes.json`` file mapping shard basename -> sample count, or a
    ``__len__`` file holding the total. Handles multi-source (``::``) specs by
    grouping shards per directory; returns None (caller must pass
    --train-num-samples) if any shard is unaccounted for — a silent wrong
    count is worse than an explicit requirement.
    """
    if not shards:
        return None
    by_dir: Dict[str, List[str]] = {}
    for s in shards:
        by_dir.setdefault(os.path.dirname(s), []).append(os.path.basename(s))
    total = 0
    for dir_path, names in by_dir.items():
        sizes_path = os.path.join(dir_path, "sizes.json")
        len_path = os.path.join(dir_path, "__len__")
        if os.path.exists(sizes_path):
            try:
                with open(sizes_path) as f:
                    sizes = json.load(f)
                total += sum(int(sizes[n]) for n in names)
                continue
            except (KeyError, ValueError, OSError) as e:
                logger.warning("sizes.json in %s unusable (%s)", dir_path, e)
                return None
        if os.path.exists(len_path):
            # __len__ counts the whole directory; only trust it when the
            # spec covers every shard in the dir
            try:
                with open(len_path) as f:
                    n_total = int(f.read().strip())
                n_tars = len([x for x in os.listdir(dir_path) if x.endswith(".tar")])
                if n_tars == len(names):
                    total += n_total
                    continue
            except (ValueError, OSError) as e:
                logger.warning("__len__ in %s unusable (%s)", dir_path, e)
            return None
        return None
    return total


def _round_num_batches(num_samples: int, batch_size: int, world_size: int,
                       num_workers: int) -> int:
    """Equal-batches-per-worker rounding (data.py:317-330)."""
    global_batch = batch_size * world_size
    num_batches = num_samples // global_batch
    num_workers = max(1, num_workers)
    num_batches = (num_batches // num_workers) * num_workers
    return max(num_batches, num_workers)


class WdsTrainPipeline:
    """Streaming (images, texts) batch iterator over tar shards.

    Each loader thread owns a disjoint worker_id and processes whole shards;
    decoded samples flow through a bounded queue into the batcher. Epoch
    changes take effect at iterator (re)construction via SharedEpoch, like the
    reference's worker-shared epoch bump (data.py:74-78).
    """

    def __init__(self, cfg: WdsConfig, transform, tokenizer,
                 shared_epoch: Optional[SharedEpoch] = None):
        if cfg.num_workers < 1:
            # --workers 0 is valid in the reference (in-process loading);
            # raw 0 here would crash shard slicing (urls[0::0]) and collapse
            # resampled per-rank seeds (rank * 0 + 0 == 0 for every rank)
            cfg = dataclasses.replace(cfg, num_workers=1)
        if cfg.native_decode:
            from .. import native

            native.load("dataloader")   # build now: raises here, not in a worker
        self.cfg = cfg
        self.transform = transform
        self.tokenizer = tokenizer
        self.shared_epoch = shared_epoch or SharedEpoch(0)
        self.urls, self.url_weights = expand_urls(cfg.urls, cfg.weights)
        if not self.urls:
            raise ValueError(f"no shards matched: {cfg.urls}")
        num_samples = cfg.num_samples
        if num_samples is None:
            num_samples = get_dataset_size(self.urls)
            if num_samples is not None:
                logger.info("dataset size from sizes.json/__len__: %d samples",
                            num_samples)
        if num_samples is not None:
            self.num_batches = _round_num_batches(
                num_samples, cfg.batch_size, cfg.world_size, cfg.num_workers
            )
        else:
            self.num_batches = None

    def set_epoch(self, epoch: int) -> None:
        self.shared_epoch.set_value(epoch)

    # -- worker side ---------------------------------------------------------

    def _worker_shards(self, worker_id: int, epoch: int) -> Iterator[str]:
        cfg = self.cfg
        if cfg.resampled:
            return resampled_shards(
                self.urls, self.url_weights, seed=cfg.seed, epoch=epoch,
                worker_id=cfg.rank * cfg.num_workers + worker_id,
            )
        return iter(deterministic_shards(
            self.urls, seed=cfg.seed, epoch=epoch,
            rank=cfg.rank, world_size=cfg.world_size,
            worker_id=worker_id, num_workers=cfg.num_workers,
        ))

    def _tokenize(self, sample: Dict[str, bytes], rng: random.Random):
        cfg = self.cfg
        if cfg.caption_key == "json":
            meta = json.loads(sample["json"])
            return sample_and_tokenize(
                meta, self.tokenizer, k=cfg.num_sampled_captions,
                max_merged_num=cfg.max_merged_num, pixelprose=cfg.pixelprose,
                rng=rng,
            )
        caption = sample["txt"].decode("utf-8", errors="replace")
        return self.tokenizer([caption] * cfg.num_sampled_captions)

    def _process_sample_native(self, sample: Dict[str, bytes], rng: random.Random):
        """Return (jpeg_bytes, crop_box, tokens) for the fused C++ decoder.

        Falls back to the PIL path for non-JPEG images or unreadable headers.
        """
        probe = probe_native_sample(sample, self.transform, rng)
        if probe is None:
            return self._process_sample(sample, rng)
        data, box = probe
        return ("__raw__", data, box, self._tokenize(sample, rng))

    def _process_sample(self, sample: Dict[str, bytes], rng: random.Random):
        cfg = self.cfg
        if "raw" in sample:  # packed pre-decoded record: no JPEG on hot path
            from .pack import decode_raw

            img_arr = self.transform.apply_raw(decode_raw(sample["raw"]), rng=rng)
        else:
            img = decode_image(sample)
            img_arr = self.transform(img, rng=rng)  # per-worker seeded crops
        texts = self._tokenize(sample, rng)
        return img_arr, texts

    def _worker_loop(self, worker_id: int, epoch: int, out_q: "queue.Queue",
                     stop: threading.Event) -> None:
        cfg = self.cfg
        rng = random.Random((cfg.seed, epoch, cfg.rank, worker_id).__hash__())
        process = self._process_sample_native if cfg.native_decode else self._process_sample
        filt = has_image_and_json if cfg.caption_key == "json" else has_image_and_txt
        try:
            shards = self._worker_shards(worker_id, epoch)
            samples = itertools.chain.from_iterable(
                iter_tar_samples(s) for s in shards
            )
            samples = (s for s in samples if filt(s))
            if cfg.shuffle_buffer > 1:
                samples = iter(ShuffleBuffer(
                    samples, cfg.shuffle_buffer // max(1, cfg.num_workers),
                    cfg.shuffle_initial // max(1, cfg.num_workers), rng,
                ))
            for s in samples:
                if stop.is_set():
                    return
                try:
                    item = process(s, rng)
                except Exception as exn:
                    log_and_continue(exn)
                    continue
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except Exception as exn:
            log_and_continue(exn)
        finally:
            # worker-done sentinel. Must not block forever: when the consumer
            # returns early (num_batches reached) the queue may be full and
            # never drained again — an untimed put would hang every worker
            # thread past the consumer's join timeout.
            while not stop.is_set():
                try:
                    out_q.put(None, timeout=0.5)
                    break
                except queue.Full:
                    continue

    # -- consumer side -------------------------------------------------------

    def _assemble_batch(self, items):
        """Stack a batch; fused-native items are decoded in one C++ call."""
        cfg = self.cfg
        txts = np.stack([it[-1] for it in items])
        raw_idx = [i for i, it in enumerate(items)
                   if isinstance(it[0], str) and it[0] == "__raw__"]
        if not raw_idx:
            return self._ship_format(np.stack([it[0] for it in items])), txts
        from .. import native

        pcfg = self.transform.cfg
        out_h, out_w = pcfg.size_hw
        jpegs = [items[i][1] for i in raw_idx]
        boxes = [items[i][2] for i in raw_idx]
        crops = None
        if boxes[0] is not None:
            crops = np.asarray(boxes, np.int32)
        on_device = getattr(self.transform, "normalize_on_device", False)
        decoded, failures = native.process_batch(
            jpegs, (out_h, out_w), pcfg.mean, pcfg.std,
            crops=crops, num_threads=cfg.decode_threads,
            normalize=not on_device,
        )
        if failures:
            logger.warning("native decode: %d failed samples zeroed", failures)
        imgs = np.zeros((len(items), out_h, out_w, 3),
                        np.uint8 if on_device else np.float32)
        for j, i in enumerate(raw_idx):
            imgs[i] = decoded[j]
        for i, it in enumerate(items):
            if not (isinstance(it[0], str) and it[0] == "__raw__"):
                imgs[i] = it[0]
        return self._ship_format(imgs), txts

    def _ship_format(self, imgs: np.ndarray) -> np.ndarray:
        """Wire-format conversion of an assembled uint8 RGB batch: with
        ship='yuv420' the batch leaves the host as planar YUV420 —
        1.5 bytes/px instead of 3. One vectorized call per batch (shared
        dispatch: ops/yuv420.apply_ship_format)."""
        from ..ops.yuv420 import apply_ship_format

        return apply_ship_format(self.transform, imgs, native=self.cfg.native_decode)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        cfg = self.cfg
        epoch = self.shared_epoch.get_value()
        num_workers = max(1, cfg.num_workers)
        out_q: "queue.Queue" = queue.Queue(maxsize=4 * cfg.batch_size)
        stop = threading.Event()
        threads = [
            threading.Thread(
                target=self._worker_loop, args=(w, epoch, out_q, stop), daemon=True,
                name=f"wds-worker-e{epoch}-{w}",
            )
            for w in range(num_workers)
        ]
        for t in threads:
            t.start()

        produced_batches = 0
        done_workers = 0
        items: List = []
        reservoir: List = []  # last full batch, for equal-batch rollover
        try:
            while done_workers < num_workers:
                item = out_q.get()
                if item is None:
                    done_workers += 1
                    continue
                items.append(item)
                if len(items) == cfg.batch_size:
                    yield self._assemble_batch(items)
                    reservoir = items
                    items = []
                    produced_batches += 1
                    if self.num_batches is not None and produced_batches >= self.num_batches:
                        return
            # deterministic mode: drop the final partial batch (reference
            # drops partials via wds batched(partial=False)) — but every
            # host MUST still emit exactly num_batches or the others hang in
            # the next collective: repeat recent samples to fill the tail,
            # the reference's equal-batch rollover (data.py:321-330).
            if self.num_batches is not None and produced_batches < self.num_batches:
                pool = items + reservoir
                if not pool:
                    raise RuntimeError(
                        f"shard split for rank {cfg.rank} yielded no samples; "
                        f"cannot equalize to {self.num_batches} batches — "
                        "other hosts would deadlock in the first collective")
                logger.warning(
                    "shard split exhausted at %d/%d batches; repeating "
                    "samples for the remainder (equal-batches-per-host)",
                    produced_batches, self.num_batches)
                k = 0
                while produced_batches < self.num_batches:
                    batch = [pool[(k + i) % len(pool)]
                             for i in range(cfg.batch_size)]
                    k += cfg.batch_size
                    yield self._assemble_batch(batch)
                    produced_batches += 1
        finally:
            stop.set()
            try:
                for t in threads:
                    t.join(timeout=2.0)
            except Exception:  # noqa: BLE001
                # generator finalized during interpreter shutdown: threading
                # internals may already be torn down; workers are daemonic
                pass
