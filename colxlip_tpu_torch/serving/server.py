"""Batched HTTP inference server for the ColXLIP/CLIP towers on one GPU.

Port of ``colxlip_tpu/serving/server.py``:

  - **Buckets.** Every request batch is padded to a power-of-two bucket
    (1, 2, 4, ... max_batch); text pad rows are SOT/EOT rows so the
    argmax-EOT pool stays defined. Pad rows are sliced off before the
    response; the towers are per-sample, so they never touch real rows.
  - **Dynamic batching.** One batcher thread per request kind (text / image)
    coalesces concurrent requests up to ``max_batch`` items or
    ``max_wait_ms``; HTTP threads only tokenize / decode / wait.
  - **Text-context buckets** (``--text-buckets``): a wave whose longest
    caption fits a shorter context encodes [n, bucket]; the token features
    past EOT are zeroed by the model, so zero-padding them back to the full
    context gives the full-context result.
  - **Kernels.** On the card every self-attention layer runs
    ``csrc/fused_attention.cu`` and ``/v1/score`` with maxsim/mixed scoring
    runs ``csrc/maxsim.cu`` on token features that never leave the device.

Endpoints (JSON), as in the JAX server:

  GET  /healthz, GET /metrics
  POST /v1/embed/text   {"texts": [...], "return_tokens": false}
  POST /v1/embed/image  {"images_b64": [...], "return_tokens": false}
  POST /v1/score        {"texts": [...], "images_b64": [...],
                         "scoring": "global"|"maxsim"|"mixed", "alpha": 0.5}
                        -> {"similarity": [[image x text]], "scoring": ...}
  POST /v1/search       {"texts": [...], "k": 10, "shortlist": 100,
                         "scoring": "maxsim"}   (needs --index <dir>)
                        -> {"indices": [[...]], "scores": [[...]], "ids"?}
                        two-stage text -> corpus search (serving/index.py)
  POST /v1/caption      {"images_b64": [...], "method": "greedy"|"top_k"|"top_p",
                         "max_len": null, "top_k": 50, "top_p": 0.9,
                         "temperature": 1.0, "seed": 0}
                        -> {"captions": [...]}   (CoCa models; 400 otherwise)
                        autoregressive decode (serving/generate.py), at most
                        max_batch images a decode

Run: ``python -m colxlip_tpu_torch.serving.server --model ViT-B-16-colxlip``.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..data.tokenizer import EOT_TOKEN, SOT_TOKEN, get_tokenizer_cached
from ..data.transforms import image_transform
from ..factory import create_model, load_weights
from ..training.evaluate import score_similarity
from ..models.coca import CoCa
from .generate import generate_captions, tokens_to_text
from .index import RetrievalIndex

logger = logging.getLogger(__name__)


def disable_tf32() -> None:
    """fp32 matmuls in full fp32, as the JAX reference computes them: the
    global scores and the plain versions' products must not drop to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def next_bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    if n >= max_batch:
        return max_batch
    b = 1
    while b < n:
        b *= 2
    return b


@dataclass
class _Work:
    payload: np.ndarray          # [n, ...] request batch
    future: Future = field(default_factory=Future)


class DynamicBatcher:
    """Coalesces concurrent same-kind requests into one device wave.

    ``fn`` maps a [B, ...] batch -> tuple of [B, ...] arrays or tensors; each
    submitted item's future resolves with the tuple sliced to its own rows.
    """

    def __init__(self, fn, max_batch: int = 64, max_wait_ms: float = 3.0,
                 name: str = "batcher"):
        self._fn = fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue[Optional[_Work]]" = queue.Queue()
        self._stopping = False
        self._stats_lock = threading.Lock()
        self.stats = {"waves": 0, "items": 0, "max_wave": 0, "failures": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._thread.start()

    def submit(self, payload: np.ndarray) -> Future:
        if self._stopping:
            raise RuntimeError("batcher is shut down")
        w = _Work(np.asarray(payload))
        self._q.put(w)
        return w.future

    def stop(self) -> None:
        self._stopping = True
        self._q.put(None)
        self._thread.join(timeout=10)

    def _collect(self) -> Optional[List[_Work]]:
        """Block for the first item, then drain up to max_batch rows or
        max_wait_s, whichever comes first."""
        first = self._q.get()
        if first is None:
            return None
        wave = [first]
        rows = first.payload.shape[0]
        deadline = time.monotonic() + self.max_wait_s
        while rows < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                w = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if w is None:
                self._q.put(None)  # propagate shutdown after this wave
                break
            wave.append(w)
            rows += w.payload.shape[0]
        return wave

    def _loop(self) -> None:
        while True:
            wave = self._collect()
            if wave is None:
                return
            try:
                batch = (wave[0].payload if len(wave) == 1
                         else np.concatenate([w.payload for w in wave]))
                outs = self._fn(batch)
                # count the wave before any caller can see its result, so a
                # /metrics read after a response always includes it
                with self._stats_lock:
                    self.stats["waves"] += 1
                    self.stats["items"] += batch.shape[0]
                    self.stats["max_wave"] = max(self.stats["max_wave"],
                                                 batch.shape[0])
                i = 0
                for w in wave:
                    n = w.payload.shape[0]
                    w.future.set_result(tuple(o[i:i + n] for o in outs))
                    i += n
            except Exception as e:  # noqa: BLE001 — fail the wave, keep serving
                logger.exception("batch wave failed")
                with self._stats_lock:
                    self.stats["failures"] += 1
                for w in wave:
                    if not w.future.done():
                        w.future.set_exception(e)


class InferenceEngine:
    """Bucketed encode for one model on one device.

    ``run`` returns (pooled l2-normalized, token features) per tower (a
    1-tuple for plain CLIP) as tensors on the model's device, sliced to the
    true row count: callers copy to the host only what they return.
    """

    def __init__(self, model, device: Union[str, torch.device],
                 max_batch: int = 64, text_ctx_buckets: Tuple[int, ...] = ()):
        self.model = model
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.text_ctx_buckets = tuple(sorted(text_ctx_buckets))
        self.last_text_ctx: Optional[int] = None  # introspection/tests
        self._encode = {
            "text": lambda x: model.encode_text(x, normalize=True),
            "image": lambda x: model.encode_image(x, normalize=True),
        }

    def run(self, kind: str, batch: np.ndarray) -> Tuple[torch.Tensor, ...]:
        # inference_mode is thread-local: entered here, in the calling
        # (batcher) thread, not once in __init__
        with torch.inference_mode():
            return self._run(kind, batch)

    def _run(self, kind: str, batch: np.ndarray) -> Tuple[torch.Tensor, ...]:
        n = batch.shape[0]
        if n > self.max_batch:
            parts = [self._run(kind, batch[i:i + self.max_batch])
                     for i in range(0, n, self.max_batch)]
            return tuple(torch.cat(cols) for cols in zip(*parts))
        full_ctx = None
        if kind == "text" and self.text_ctx_buckets:
            full_ctx = batch.shape[1]
            # EOT is the largest id, so argmax finds it per row; route to a
            # bucket only when every row has one (else argmax is some other
            # token and cutting there would drop real tokens)
            if (batch.max(axis=1) == EOT_TOKEN).all():
                needed = int(batch.argmax(axis=1).max()) + 1
                for c in self.text_ctx_buckets:
                    if needed <= c < full_ctx:
                        batch = batch[:, :c]
                        break
            self.last_text_ctx = batch.shape[1]
        b = next_bucket(n, self.max_batch)
        if b != n:
            pad = np.zeros((b - n,) + batch.shape[1:], batch.dtype)
            if kind == "text":
                pad[:, 0] = SOT_TOKEN
                pad[:, 1] = EOT_TOKEN
            batch = np.concatenate([batch, pad])
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        out = self._encode[kind](x)
        out = out if isinstance(out, tuple) else (out,)
        if full_ctx is not None and x.shape[1] < full_ctx:
            # the tail is EOT-zeroed by the model: zeros restore full width
            out = tuple(F.pad(o, (0, 0, 0, full_ctx - o.shape[1]))
                        if o.ndim == 3 else o for o in out)
        return tuple(o[:n] for o in out)

    def warmup(self, shapes: Dict[str, Tuple[int, ...]]) -> None:
        """Run every bucket of the ladder once for the given per-kind item
        shapes (e.g. {'text': (77,), 'image': (224, 224, 3)}), text-context
        buckets included, so no request pays first-call costs."""
        for kind, shape in shapes.items():
            eot_slots = [None]
            if kind == "text":
                full = shape[0]
                eot_slots = [c - 1 for c in self.text_ctx_buckets
                             if c < full] + [full - 1]
            b = 1
            while True:
                dtype = np.int32 if kind == "text" else np.float32
                for eot in eot_slots:
                    batch = np.zeros((min(b, self.max_batch),) + tuple(shape), dtype)
                    if kind == "text":
                        batch[:, 0] = SOT_TOKEN
                        batch[:, eot] = EOT_TOKEN
                    self.run(kind, batch)[0].cpu()
                if b >= self.max_batch:
                    break
                b *= 2


class ColXLIPService:
    """Model + tokenizer + transform + batchers behind the HTTP handler."""

    def __init__(self, model_name: str, checkpoint: Optional[str] = None, *,
                 device: Union[str, torch.device] = "cuda:0",
                 dtype: torch.dtype = torch.bfloat16, max_batch: int = 64,
                 max_wait_ms: float = 3.0, scoring: str = "global",
                 alpha: float = 0.5, mask_mode: str = "nonzero",
                 quick_gelu: Optional[bool] = None,
                 text_ctx_buckets: Tuple[int, ...] = (),
                 index_dir: Optional[str] = None,
                 model=None, cfg=None, seed: int = 0):
        disable_tf32()
        self.device = torch.device(device)
        if model is None:
            model, cfg = create_model(model_name, self.device, dtype, seed=seed,
                                      quick_gelu=quick_gelu)
            if checkpoint:
                load_weights(model, checkpoint)
            else:
                logger.warning("serving RANDOM-INIT weights (no --checkpoint)")
        self.model_name = model_name
        self.cfg = cfg
        self.model = model
        self._metrics_lock = threading.Lock()
        self.request_counts: Dict[str, int] = {}
        self.request_seconds: Dict[str, float] = {}
        self.scoring = scoring
        self.alpha = alpha
        self.mask_mode = mask_mode
        self.tokenizer = get_tokenizer_cached(cfg.text_cfg.context_length)
        self.transform = image_transform(cfg.vision_cfg.image_size, is_train=False)
        bad = [c for c in text_ctx_buckets
               if not 3 <= c <= cfg.text_cfg.context_length]
        if bad:
            raise ValueError(f"text_ctx_buckets {bad} outside [3, "
                             f"{cfg.text_cfg.context_length}] (the model's context)")
        self.engine = InferenceEngine(model, self.device, max_batch=max_batch,
                                      text_ctx_buckets=text_ctx_buckets)
        self._batchers = {
            kind: DynamicBatcher(lambda b, k=kind: self.engine.run(k, b),
                                 max_batch=max_batch, max_wait_ms=max_wait_ms,
                                 name=f"batcher-{kind}")
            for kind in ("text", "image")
        }
        self.logit_scale = float(model.logit_scale.detach().float().exp())
        self.index: Optional[RetrievalIndex] = None
        if index_dir:
            self.index = RetrievalIndex(index_dir, device=self.device)
            logger.info("retrieval index: %d items from %s", len(self.index), index_dir)

    # ---- request paths (called from HTTP threads) ----

    def tokenize(self, texts: List[str]) -> np.ndarray:
        return np.asarray(self.tokenizer(texts), np.int32)

    def decode_images(self, images_b64: List[str]) -> np.ndarray:
        from PIL import Image

        arrs = []
        for b64 in images_b64:
            with Image.open(io.BytesIO(base64.b64decode(b64))) as img:
                arrs.append(self.transform(img))
        return np.stack(arrs).astype(np.float32)

    def embed(self, kind: str, batch: np.ndarray, timeout: float = 120.0):
        return self._batchers[kind].submit(batch).result(timeout=timeout)

    def score(self, texts: List[str], images_b64: List[str],
              scoring: Optional[str] = None,
              alpha: Optional[float] = None) -> np.ndarray:
        tokens = self.tokenize(texts)
        imgs = self.decode_images(images_b64)
        f_txt = self._batchers["text"].submit(tokens)
        f_img = self._batchers["image"].submit(imgs)
        txt_out, img_out = f_txt.result(timeout=120), f_img.result(timeout=120)
        scoring = scoring or self.scoring
        with torch.inference_mode():
            text_mask = None
            if self.mask_mode == "valid" and scoring in ("maxsim", "mixed"):
                eot = tokens.argmax(axis=-1)
                mask = np.arange(tokens.shape[1])[None, :] < eot[:, None]
                text_mask = torch.from_numpy(mask.astype(np.float32)).to(self.device)
            sim = score_similarity(
                img_out[0], txt_out[0],
                img_out[1] if len(img_out) > 1 else None,
                txt_out[1] if len(txt_out) > 1 else None,
                self.logit_scale, scoring=scoring,
                alpha=self.alpha if alpha is None else alpha,
                mask_mode=self.mask_mode, text_mask=text_mask)
            return sim.cpu().numpy()

    def search(self, texts: List[str], *, k: int = 10, shortlist: int = 100,
               scoring: Optional[str] = None, alpha: Optional[float] = None):
        """Text -> corpus-image search against the loaded retrieval index:
        (indices [M, k], scores [M, k], ids [M][k] or None)."""
        if self.index is None:
            raise ValueError("no retrieval index loaded (start the server "
                             "with --index <dir>)")
        tokens = self.tokenize(texts)
        out = self._batchers["text"].submit(tokens).result(timeout=120)
        pooled = out[0].float().cpu().numpy()
        q_tokens = out[1].float().cpu().numpy() if len(out) > 1 else None
        scoring = scoring or ("maxsim" if q_tokens is not None else "global")
        text_mask = None
        if self.mask_mode == "valid" and scoring in ("maxsim", "mixed"):
            eot = tokens.argmax(axis=-1)
            text_mask = (np.arange(tokens.shape[1])[None, :]
                         < eot[:, None]).astype(np.float32)
        return self.index.search(
            pooled, q_tokens, k=k, shortlist=shortlist, scoring=scoring,
            alpha=self.alpha if alpha is None else alpha,
            mask_mode=self.mask_mode, text_mask=text_mask)

    def caption(self, images_b64: List[str], *, method: str = "greedy",
                max_len: Optional[int] = None, top_k: int = 50, top_p: float = 0.9,
                temperature: float = 1.0, seed: int = 0) -> List[str]:
        """CoCa models only: decode a caption an image, ``max_batch`` images
        a decode (each with the request's ``seed``)."""
        if not isinstance(self.model, CoCa):
            raise ValueError(f"{self.model_name!r} has no caption decoder — "
                             "captioning needs a CoCa model")
        imgs = self.decode_images(images_b64)
        step = self.engine.max_batch
        tokens = np.concatenate([generate_captions(
            self.model, imgs[i:i + step], method=method, max_len=max_len, top_k=top_k,
            top_p=top_p, temperature=temperature, seed=seed)
            for i in range(0, len(imgs), step)])
        return tokens_to_text(tokens, self.tokenizer)

    def record(self, path: str, seconds: float) -> None:
        with self._metrics_lock:
            self.request_counts[path] = self.request_counts.get(path, 0) + 1
            self.request_seconds[path] = self.request_seconds.get(path, 0.0) + seconds

    def metrics(self) -> dict:
        with self._metrics_lock:
            counts = dict(self.request_counts)
            seconds = {k: round(v, 4) for k, v in self.request_seconds.items()}
        return {
            "requests": counts,
            "request_seconds_total": seconds,
            "batcher": {k: dict(b.stats) for k, b in self._batchers.items()},
            "index_items": len(self.index) if self.index is not None else None,
        }

    def stop(self) -> None:
        for b in self._batchers.values():
            b.stop()


def _host(t: torch.Tensor) -> list:
    return t.float().cpu().numpy().tolist()


class _Handler(BaseHTTPRequestHandler):
    service: ColXLIPService  # set by make_server

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logger.debug("%s " + fmt, self.address_string(), *args)

    _post_t0: Optional[float] = None   # set while a POST is not yet recorded

    def _record_post(self) -> None:
        if self._post_t0 is not None:
            self.service.record(self.path, time.monotonic() - self._post_t0)
            self._post_t0 = None

    def _send(self, code: int, obj: dict) -> None:
        # a POST is counted before its response leaves, so a client that
        # reads /metrics after the response always sees it
        self._record_post()
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            raise ValueError("empty request body")
        return json.loads(self.rfile.read(length))

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path == "/metrics":
            return self._send(200, self.service.metrics())
        if self.path != "/healthz":
            return self._send(404, {"error": f"unknown path {self.path}"})
        svc = self.service
        self._send(200, {
            "status": "ok",
            "model": svc.model_name,
            "embed_dim": svc.cfg.embed_dim,
            "image_size": svc.cfg.vision_cfg.image_size,
            "context_length": svc.cfg.text_cfg.context_length,
            "scoring": svc.scoring,
            "device": str(svc.device),
            "index_items": len(svc.index) if svc.index is not None else None,
        })

    def do_POST(self):  # noqa: N802 — http.server API
        self._post_t0 = time.monotonic()
        try:
            self._route_post()
        finally:
            self._record_post()       # a request that sent no response

    def _embed(self, req: dict, kind: str, key: str) -> None:
        items = req[key]
        if not isinstance(items, list) or not items:
            raise ValueError(f"'{key}' must be a non-empty list")
        svc = self.service
        batch = svc.tokenize(items) if kind == "text" else svc.decode_images(items)
        out = svc.embed(kind, batch)
        resp = {"embeddings": _host(out[0]), "count": len(items)}
        if req.get("return_tokens") and len(out) > 1:
            resp["token_embeddings"] = _host(out[1])
        self._send(200, resp)

    def _route_post(self):
        try:
            req = self._read_json()
            if self.path == "/v1/embed/text":
                return self._embed(req, "text", "texts")
            if self.path == "/v1/embed/image":
                return self._embed(req, "image", "images_b64")
            if self.path == "/v1/score":
                sim = self.service.score(req["texts"], req["images_b64"],
                                         scoring=req.get("scoring"),
                                         alpha=req.get("alpha"))
                return self._send(200, {
                    "similarity": sim.tolist(),
                    "scoring": req.get("scoring") or self.service.scoring,
                })
            if self.path == "/v1/search":
                idx, scores, ids = self.service.search(
                    req["texts"], k=int(req.get("k", 10)),
                    shortlist=int(req.get("shortlist", 100)),
                    scoring=req.get("scoring"), alpha=req.get("alpha"))
                resp = {"indices": idx.tolist(), "scores": scores.tolist()}
                if ids is not None:
                    resp["ids"] = ids
                return self._send(200, resp)
            if self.path == "/v1/caption":
                caps = self.service.caption(
                    req["images_b64"], method=req.get("method", "greedy"),
                    max_len=req.get("max_len"), top_k=int(req.get("top_k", 50)),
                    top_p=float(req.get("top_p", 0.9)),
                    temperature=float(req.get("temperature", 1.0)),
                    seed=int(req.get("seed", 0)))
                return self._send(200, {"captions": caps})
            return self._send(404, {"error": f"unknown path {self.path}"})
        except (KeyError, ValueError, TypeError) as e:
            return self._send(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surface, don't kill the thread
            logger.exception("request failed")
            return self._send(500, {"error": str(e)})


def make_server(service: ColXLIPService, host: str = "0.0.0.0",
                port: int = 8080) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; port 0 picks an ephemeral
    port (read it back from ``server.server_address``)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="ViT-B-16-colxlip")
    p.add_argument("--checkpoint", default=None,
                   help="OpenCLIP-layout .pt checkpoint (default: random init)")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=3.0)
    p.add_argument("--scoring", default="global",
                   choices=["global", "maxsim", "mixed"])
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--mask-mode", default="nonzero",
                   choices=["nonzero", "plain", "valid"])
    p.add_argument("--force-quick-gelu", action="store_true")
    p.add_argument("--warmup", action="store_true",
                   help="run the whole power-of-two bucket ladder for both "
                        "towers (and build the kernels) before serving")
    p.add_argument("--index", default=None,
                   help="retrieval-index dir (serving/index.py) to enable "
                        "POST /v1/search")
    p.add_argument("--text-buckets", type=int, nargs="*", default=[],
                   help="short text-context buckets (e.g. 32): a wave whose "
                        "longest caption fits encodes [n, bucket] instead of "
                        "the full context, with the same features")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    svc = ColXLIPService(
        args.model, args.checkpoint, device=args.device,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        scoring=args.scoring, alpha=args.alpha, mask_mode=args.mask_mode,
        quick_gelu=True if args.force_quick_gelu else None,
        text_ctx_buckets=tuple(args.text_buckets),
        index_dir=args.index,
    )
    if args.warmup:
        s = svc.cfg.vision_cfg.image_size
        s = s if isinstance(s, int) else s[0]
        logger.info("warming the bucket ladder (text + image towers)...")
        svc.engine.warmup({"text": (svc.cfg.text_cfg.context_length,),
                           "image": (s, s, 3)})
    server = make_server(svc, args.host, args.port)
    logger.info("serving %s on %s:%d (%s)", args.model, *server.server_address,
                args.device)
    try:
        server.serve_forever()
    finally:
        svc.stop()


if __name__ == "__main__":
    main()
