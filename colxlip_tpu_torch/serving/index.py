"""Late-interaction retrieval index: build once, two-stage search. Port of
``colxlip_tpu/serving/index.py``.

  stage 1  pooled-feature dot product over the WHOLE corpus (the plain CLIP
           global score: one [D] x [N, D] product a query), on the host in
           numpy -> the top-``shortlist`` candidate ids
  stage 2  exact MaxSim rerank of the shortlist with the stored token
           features: the candidates' tokens go to the index's device and
           through ``ops.maxsim`` (the MaxSim kernel on the card)

``shortlist >= corpus size`` is exact brute force.

Index layout (``index_dir/``), byte for byte the JAX package's, so an index
written by either package opens in the other:

  meta.json    {"embed_dim", "token_len", "num_items", "ids", "model",
                "logit_scale", "dtype"}
  pooled.npy   [N, D]      l2-normalized pooled features
  tokens.npy   [N, Li, D]  token-head features

Both arrays are standard ``.npy`` files that ``RetrievalIndex`` opens with
``mmap_mode='r'``: stage 2 touches only ``shortlist`` rows a query.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.maxsim import maxsim

_META = "meta.json"
_POOLED = "pooled.npy"
_TOKENS = "tokens.npy"


class IndexWriter:
    """Accumulate (pooled, tokens) batches, then write one index directory.
    Batches are held as ``dtype`` (float16) chunks until ``finalize``."""

    def __init__(self, out_dir: str, *, model: str = "",
                 logit_scale: float = 100.0, dtype: str = "float16"):
        self.out_dir = out_dir
        self.model = model
        self.logit_scale = float(logit_scale)
        self.dtype = np.dtype(dtype)
        self._pooled: List[np.ndarray] = []
        self._tokens: List[np.ndarray] = []
        self._ids: List = []

    def add(self, pooled: np.ndarray, tokens: np.ndarray,
            ids: Optional[Sequence] = None) -> None:
        pooled = np.asarray(pooled)
        tokens = np.asarray(tokens)
        if pooled.ndim != 2 or tokens.ndim != 3 or len(pooled) != len(tokens):
            raise ValueError(
                f"expected pooled [n, D] and tokens [n, Li, D], got "
                f"{pooled.shape} / {tokens.shape}")
        self._pooled.append(pooled.astype(self.dtype))
        self._tokens.append(tokens.astype(self.dtype))
        if ids is not None:
            if len(ids) != len(pooled):
                raise ValueError("ids length != batch length")
            self._ids.extend(ids)

    def finalize(self) -> str:
        if not self._pooled:
            raise ValueError("empty index")
        if self._ids and len(self._ids) != sum(len(p) for p in self._pooled):
            raise ValueError("ids were provided for only some batches")
        os.makedirs(self.out_dir, exist_ok=True)
        pooled = np.concatenate(self._pooled)
        tokens = np.concatenate(self._tokens)
        np.save(os.path.join(self.out_dir, _POOLED), pooled)
        np.save(os.path.join(self.out_dir, _TOKENS), tokens)
        meta = {
            "embed_dim": int(pooled.shape[1]),
            "token_len": int(tokens.shape[1]),
            "num_items": int(pooled.shape[0]),
            "ids": list(self._ids) if self._ids else None,
            "model": self.model,
            "logit_scale": self.logit_scale,
            "dtype": self.dtype.name,
        }
        with open(os.path.join(self.out_dir, _META), "w") as f:
            json.dump(meta, f)
        return self.out_dir


def build_image_index(model, images: Iterable[np.ndarray], out_dir: str, *,
                      device: Union[str, torch.device],
                      ids: Optional[Sequence] = None, batch_size: int = 256,
                      model_name: str = "") -> str:
    """Encode an image iterable through the vision tower of ``model`` (a
    ColXLIP model on ``device``) and write an index.

    ``images`` yields [H, W, 3] float32 preprocessed arrays (the eval
    transform's output) or uint8 arrays, which the tower normalises. Every
    batch has ``batch_size`` rows: the last one is padded by repeating its
    last image, and the pad rows are cut before they are written."""
    device = torch.device(device)
    ls = float(model.logit_scale.detach().float().exp())
    writer = IndexWriter(out_dir, model=model_name, logit_scale=ls)
    buf: List[np.ndarray] = []

    def flush() -> None:
        if not buf:
            return
        n = len(buf)
        batch = np.stack(buf + [buf[-1]] * (batch_size - n))
        with torch.inference_mode():
            out = model.encode_image(torch.from_numpy(batch).to(device), normalize=True)
        if not isinstance(out, tuple):
            raise ValueError("model has no token outputs: build the index with a "
                             "colxlip model (token head required)")
        pooled, tokens = out
        writer.add(pooled[:n].float().cpu().numpy(), tokens[:n].float().cpu().numpy())
        buf.clear()

    for img in images:
        buf.append(np.asarray(img))
        if len(buf) == batch_size:
            flush()
    flush()
    if ids is not None:
        writer._ids = list(ids)
    return writer.finalize()


class RetrievalIndex:
    """Memory-mapped two-stage (global shortlist -> MaxSim rerank) search.
    ``device`` is where stage 2 runs: ``cuda:0`` unless told otherwise."""

    def __init__(self, index_dir: str, device: Union[str, torch.device] = "cuda:0"):
        with open(os.path.join(index_dir, _META)) as f:
            self.meta = json.load(f)
        self.device = torch.device(device)
        self.pooled = np.load(os.path.join(index_dir, _POOLED), mmap_mode="r")
        self.tokens = np.load(os.path.join(index_dir, _TOKENS), mmap_mode="r")
        self.ids = self.meta.get("ids")
        self.logit_scale = float(self.meta.get("logit_scale", 100.0))
        if self.pooled.shape[0] != self.tokens.shape[0]:
            raise ValueError("corrupt index: pooled/tokens row mismatch")
        # stage 1 is one [N, D] fp32 matmul a query wave; keep a dense fp32
        # copy only when it is small, else matmul the fp16 mmap
        self._pooled_f32 = (np.asarray(self.pooled, np.float32)
                            if self.pooled.nbytes <= 256 * 1024 * 1024
                            else None)

    def __len__(self) -> int:
        return int(self.meta["num_items"])

    def search(
        self,
        query_pooled: np.ndarray,
        query_tokens: Optional[np.ndarray] = None,
        *,
        k: int = 10,
        shortlist: int = 100,
        scoring: str = "maxsim",
        alpha: float = 0.5,
        mask_mode: str = "nonzero",
        text_mask: Optional[np.ndarray] = None,
        maxsim_impl: str = "auto",
    ) -> Tuple[np.ndarray, np.ndarray, Optional[List]]:
        """[M, D] queries (+ [M, Lt, D] token features for maxsim/mixed)
        -> (indices [M, k], scores [M, k], ids [M][k] or None).

        scoring='global' ranks by stage 1 alone; 'maxsim'/'mixed' rerank the
        stage-1 shortlist with exact late interaction (score values match
        ``training.evaluate.score_similarity`` on the same candidates)."""
        q = np.asarray(query_pooled, np.float32)
        if q.ndim != 2:
            raise ValueError(f"query_pooled must be [M, D], got {q.shape}")
        n = len(self)
        k = min(k, n)
        shortlist = min(max(shortlist, k), n)
        base = (self._pooled_f32 if self._pooled_f32 is not None
                else np.asarray(self.pooled, np.float32))
        g = self.logit_scale * (q @ base.T)  # [M, N]

        if scoring == "global":
            top = np.argpartition(-g, k - 1, axis=1)[:, :k]
            scores = np.take_along_axis(g, top, axis=1)
            order = np.argsort(-scores, axis=1)
            top = np.take_along_axis(top, order, axis=1)
            scores = np.take_along_axis(scores, order, axis=1)
            return top, scores, self._resolve(top)

        if scoring not in ("maxsim", "mixed"):
            raise ValueError(f"unknown scoring: {scoring!r}")
        if query_tokens is None:
            raise ValueError(f"scoring={scoring!r} needs query_tokens")
        qt = torch.from_numpy(np.asarray(query_tokens, np.float32)).to(self.device)
        masks = (None if text_mask is None else
                 torch.from_numpy(np.asarray(text_mask, np.float32)).to(self.device))

        cand = np.argpartition(-g, shortlist - 1, axis=1)[:, :shortlist]
        out_idx = np.empty((len(q), k), np.int64)
        out_scores = np.empty((len(q), k), np.float32)
        for m in range(len(q)):
            rows = np.sort(cand[m])  # sorted rows read faster off the mmap
            cand_tokens = torch.from_numpy(
                np.asarray(self.tokens[rows], np.float32)).to(self.device)
            with torch.inference_mode():
                s_tok = maxsim(
                    qt[m:m + 1], cand_tokens, mask_mode=mask_mode,
                    text_mask=None if masks is None else masks[m:m + 1],
                    impl=maxsim_impl)[0].cpu().numpy()  # [shortlist]
            s = self.logit_scale * s_tok
            if scoring == "mixed":
                s = alpha * g[m, rows] + (1 - alpha) * s
            order = np.argsort(-s)[:k]
            out_idx[m] = rows[order]
            out_scores[m] = s[order]
        return out_idx, out_scores, self._resolve(out_idx)

    def _resolve(self, idx: np.ndarray) -> Optional[List]:
        if self.ids is None:
            return None
        return [[self.ids[int(i)] for i in row] for row in idx]
