"""Synthetic in-memory dataset: port of ``colxlip_tpu/data/synthetic.py``.

Pure numpy, and the same stream bit for bit as the JAX package's for the
same seed (the same ``default_rng`` draws in the same order): deterministic,
shaped like the tar pipeline's output, so the whole train loop runs with no
data files (``--dataset-type synthetic``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticConfig:
    batch_size: int = 64  # per-HOST batch (the local shard of the global)
    image_size: Tuple[int, int] = (224, 224)
    context_length: int = 77
    num_sampled_captions: int = 1
    vocab_size: int = 49408
    sot_token: int = 49406
    eot_token: int = 49407
    seed: int = 0
    num_samples: int = 100_000  # nominal epoch size (GLOBAL samples)
    # multi-host: every host generates the same seed-deterministic GLOBAL
    # batch stream and keeps its own rank's rows — the synthetic analog of
    # the wds pipeline's split_by_node (reference data.py:276-285). Without
    # this, each host would feed IDENTICAL samples (duplicated data) and
    # len() would over-count the epoch by world_size.
    rank: int = 0
    world_size: int = 1


class SyntheticDataset:
    """Yields (images [B,H,W,3] f32, texts [B,k,ctx] i32) LOCAL batches."""

    def __init__(self, cfg: SyntheticConfig):
        if not (0 <= cfg.rank < cfg.world_size):
            raise ValueError(f"rank {cfg.rank} not in [0, {cfg.world_size})")
        self.cfg = cfg
        self.num_batches = max(
            1, cfg.num_samples // (cfg.batch_size * cfg.world_size))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        h, w = cfg.image_size
        gb = cfg.batch_size * cfg.world_size
        lo, hi = cfg.rank * cfg.batch_size, (cfg.rank + 1) * cfg.batch_size
        for _ in range(self.num_batches):
            images = rng.standard_normal((gb, h, w, 3), dtype=np.float32)
            texts = np.zeros(
                (gb, cfg.num_sampled_captions, cfg.context_length), np.int32
            )
            lengths = rng.integers(3, cfg.context_length - 1, gb)
            body = rng.integers(1, cfg.sot_token, texts.shape)
            for b in range(gb):
                texts[b, :, 1:lengths[b]] = body[b, :, 1:lengths[b]]
                texts[b, :, 0] = cfg.sot_token
                texts[b, :, lengths[b]] = cfg.eot_token
            yield images[lo:hi], texts[lo:hi]

    def __len__(self) -> int:
        return self.num_batches
