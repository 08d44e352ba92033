"""Retrieval evaluation: port of ``colxlip_tpu/training/evaluate.py``.

  - ``compute_retrieval_metrics``: R@1/5/10 and the mean and median rank in
    both directions, the JAX definition line for line in numpy on the host
    (ranks under numpy's stable argsort of ``-sim``, ties to the lower
    column), so the values are the JAX package's bit for bit.
  - ``Encoder``: the model in eval mode under ``torch.no_grad()`` on one
    device; the pooled features and the tokens stay on that device in fp32
    (the JAX version takes them to host numpy). Batches keep their own size:
    no fixed shape to pad to. ``local_shard_scheme``'s mesh waits for the
    distributed port.
  - ``score_similarity``: 'global', 'maxsim' or 'mixed' on the device, the
    token features straight into the MaxSim kernel (``ops.maxsim``).
  - ``retrieval_on_split`` / ``evaluate``: encode, score, metrics, one
    ``results.jsonl`` line an eval with the JAX keys. Each suite logs its
    time split: host image load and transform, image encode, text encode,
    scoring, metrics.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..data.retrieval import RetrievalSuite
from ..ops.maxsim import maxsim

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _ranks_of(sim: np.ndarray, targets: List[List[int]]) -> np.ndarray:
    """Rank of the best ground-truth column of each row under a stable
    descending sort."""
    order = np.argsort(-sim, axis=1, kind="stable")
    ranks = np.empty(sim.shape[0], dtype=np.int64)
    inv = np.empty_like(order)
    rows = np.arange(sim.shape[0])[:, None]
    inv[rows, order] = np.arange(sim.shape[1])[None, :]
    for i, tgts in enumerate(targets):
        ranks[i] = min(inv[i, t] for t in tgts)
    return ranks


def compute_retrieval_metrics(i2t_sim: np.ndarray, txt2img: Dict[int, int],
                              img2txt: Dict[int, List[int]]) -> Dict[str, float]:
    """R@K and mean / median ranks of ``i2t_sim`` [num_images, num_texts]
    (host numpy); text-to-image reads its transpose."""
    i2t_sim = np.asarray(i2t_sim)
    t2i_sim = i2t_sim.T
    t2i_ranks = _ranks_of(t2i_sim, [[txt2img[i]] for i in range(t2i_sim.shape[0])])
    i2t_ranks = _ranks_of(i2t_sim, [list(img2txt[i]) for i in range(i2t_sim.shape[0])])

    def pack(prefix, ranks):
        return {
            f"{prefix}_R@1": float((ranks < 1).mean()),
            f"{prefix}_R@5": float((ranks < 5).mean()),
            f"{prefix}_R@10": float((ranks < 10).mean()),
            f"{prefix}_mean_rank": float(ranks.mean() + 1),
            f"{prefix}_median_rank": float(np.floor(np.median(ranks)) + 1),
        }

    return {**pack("text_to_image", t2i_ranks), **pack("image_to_text", i2t_ranks)}


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def synchronize(device: torch.device) -> None:
    """Wait for the card (a no-op on the CPU), so a host clock reads work done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def inference(model: torch.nn.Module):
    """``model`` in eval mode under ``torch.no_grad()``; its mode comes back
    afterwards (the epoch-end eval runs on the training model)."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


class Encoder:
    """Encodes a suite's texts and images with ``model`` on its own device,
    under ``inference``. ``seconds`` holds the last pass's host wait on the
    batch iterator ('load': for images, file reads, decode and transform)
    and its wall time to the last feature on the device ('total')."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 256, with_tokens: bool = True):
        self.model = model
        self.batch_size = batch_size
        self.with_tokens = with_tokens
        self.device = model_device(model)
        self.seconds = {"load": 0.0, "total": 0.0}

    def _run(self, fn: Callable, batches: Iterable[np.ndarray]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        feats, toks = [], []
        load = 0.0
        t0 = time.perf_counter()
        with inference(self.model):
            it = iter(batches)
            while True:
                t_wait = time.perf_counter()
                batch = next(it, None)
                load += time.perf_counter() - t_wait
                if batch is None:
                    break
                out = fn(torch.from_numpy(np.asarray(batch)).to(self.device), normalize=True)
                if isinstance(out, tuple):
                    feats.append(out[0].float())
                    if self.with_tokens:
                        toks.append(out[1].float())
                else:
                    feats.append(out.float())
        synchronize(self.device)
        self.seconds = {"load": load, "total": time.perf_counter() - t0}
        return torch.cat(feats), (torch.cat(toks) if toks else None)

    def encode_texts(self, suite: RetrievalSuite):
        return self._run(self.model.encode_text, suite.iter_text_batches(self.batch_size))

    def encode_images(self, suite: RetrievalSuite):
        return self._run(self.model.encode_image, suite.iter_image_batches(self.batch_size))


# ---------------------------------------------------------------------------
# scoring + per-suite eval
# ---------------------------------------------------------------------------

def score_similarity(img_feats: torch.Tensor, txt_feats: torch.Tensor,
                     img_tokens: Optional[torch.Tensor],
                     txt_tokens: Optional[torch.Tensor], logit_scale: float,
                     scoring: str = "global", alpha: float = 0.5,
                     mask_mode: str = "nonzero",
                     text_mask: Optional[torch.Tensor] = None,
                     maxsim_impl: str = "auto") -> torch.Tensor:
    """[num_images, num_texts] float32 similarity: 'global' (scaled cosine of
    the pooled features), 'maxsim' (scaled MaxSim of the token features,
    through ``maxsim_impl``) or 'mixed' (alpha * global + (1 - alpha) *
    maxsim)."""
    if scoring not in ("global", "maxsim", "mixed"):
        raise ValueError(f"unknown scoring: {scoring!r}")
    if scoring in ("global", "mixed"):
        global_sim = logit_scale * (img_feats.float() @ txt_feats.float().T)
        if scoring == "global":
            return global_sim
    if img_tokens is None or txt_tokens is None:
        raise ValueError(f"scoring={scoring!r} needs token features")
    s_t2i = maxsim(txt_tokens.float().contiguous(), img_tokens.float().contiguous(),
                   mask_mode=mask_mode, text_mask=text_mask,
                   impl=maxsim_impl)  # [n_txt, n_img]
    token_sim = logit_scale * s_t2i.T
    if scoring == "maxsim":
        return token_sim
    return alpha * global_sim + (1 - alpha) * token_sim


def valid_text_mask(tokens: np.ndarray) -> np.ndarray:
    """[N, L] float32: 1 before each row's EOT (its largest id), the mask the
    train step derives for ``mask_mode='valid'``."""
    eot = tokens.argmax(axis=-1)
    return (np.arange(tokens.shape[1])[None, :] < eot[:, None]).astype(np.float32)


def retrieval_on_split(model: torch.nn.Module, suite: RetrievalSuite, *,
                       batch_size: int = 256, scoring: str = "global", alpha: float = 0.5,
                       logit_scale: Optional[float] = None, maxsim_impl: str = "auto",
                       mask_mode: str = "nonzero") -> Dict[str, float]:
    """Encode the suite, score it, compute the metrics, keyed
    ``<suite>_<metric>`` as in the JAX package. ``logit_scale`` defaults to
    exp of the model's parameter."""
    with_tokens = scoring in ("maxsim", "mixed")
    enc = Encoder(model, batch_size=batch_size, with_tokens=with_tokens)
    txt_feats, txt_tokens = enc.encode_texts(suite)
    text_s = enc.seconds["total"]
    img_feats, img_tokens = enc.encode_images(suite)
    image_s = enc.seconds
    if logit_scale is None:
        logit_scale = float(np.exp(model.logit_scale.detach().cpu().numpy()))
    text_mask = None
    if mask_mode == "valid" and with_tokens:
        text_mask = torch.from_numpy(valid_text_mask(np.asarray(suite.tokens))).to(enc.device)
    t0 = time.perf_counter()
    sim = score_similarity(img_feats, txt_feats, img_tokens, txt_tokens, logit_scale,
                           scoring=scoring, alpha=alpha, maxsim_impl=maxsim_impl,
                           mask_mode=mask_mode, text_mask=text_mask)
    synchronize(enc.device)
    t1 = time.perf_counter()
    metrics = compute_retrieval_metrics(sim.cpu().numpy(), suite.txt2img, suite.img2txt)
    t2 = time.perf_counter()
    logger.info("%s seconds: image load + transform %.3f, image encode %.3f, text encode "
                "%.3f, score (%s) %.3f, metrics %.3f", suite.name, image_s["load"],
                image_s["total"] - image_s["load"], text_s, scoring, t1 - t0, t2 - t1)
    prefixed = {f"{suite.name}_{k}": v for k, v in metrics.items()}
    prefixed[f"{suite.name}_num_text_samples"] = suite.num_texts
    prefixed[f"{suite.name}_num_image_samples"] = suite.num_images
    return prefixed


def evaluate(model: torch.nn.Module, suites: List[RetrievalSuite], *, epoch: int = 0,
             batch_size: int = 256, scoring: str = "global", alpha: float = 0.5,
             results_file: Optional[str] = None,
             zero_shot_fn: Optional[Callable[[torch.nn.Module], Dict[str, float]]] = None,
             maxsim_impl: str = "auto", mask_mode: str = "nonzero") -> Dict[str, float]:
    """Zero-shot (when ``zero_shot_fn`` is given) and every suite; appends
    one JSON line to ``results_file``."""
    metrics: Dict[str, float] = {"epoch": epoch}
    if zero_shot_fn is not None:
        metrics.update(zero_shot_fn(model))
    for suite in suites:
        logger.info("evaluating retrieval on %s (%d texts / %d images)",
                    suite.name, suite.num_texts, suite.num_images)
        metrics.update(retrieval_on_split(
            model, suite, batch_size=batch_size, scoring=scoring, alpha=alpha,
            maxsim_impl=maxsim_impl, mask_mode=mask_mode))
    logger.info("eval epoch %d: %s", epoch,
                "\t".join(f"{k}: {round(v, 4)}" for k, v in metrics.items()))
    if results_file:
        os.makedirs(os.path.dirname(results_file) or ".", exist_ok=True)
        with open(results_file, "a") as f:
            f.write(json.dumps(metrics) + "\n")
    return metrics
