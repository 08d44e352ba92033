#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (colxlip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed on its own lines; any failure raises (non-zero exit):

  1. device: requires torch.cuda.is_available(); prints the card's name and
     power limit (nvidia-smi).
  2. build: compiles colxlip_tpu_torch/csrc/*.cu with nvcc for sm_90a.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the serving shapes, with the tolerances below.
  4. slice: the serving path end to end — ColXLIPService (ViT-B-16-colxlip,
     full width, random init from seed 0, bf16 compute) behind make_server on
     an ephemeral port, driven over HTTP; checks finite unit-norm embeddings,
     that both kernels were launched by the requests, and the /v1/score
     matrices against a plain-path recomputation on the same device.
  5. timings (CUDA events, after warm-up): each kernel against its plain
     version, encode throughput at batch 64, request latency.

The last line is {"ok": true, "device": {...}}; the line before it is the
nvidia-smi name and power limit, and before that one JSON object with the
per-kernel results.
"""
from __future__ import annotations

import base64
import contextlib
import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

MODEL = "ViT-B-16-colxlip"
MAX_BATCH = 64
# kernel vs plain version on the same inputs:
#   fp32: summation order only (1e-5 absolute on outputs of magnitude < ~3);
#   bf16: the output is rounded to bf16 (2^-8 relative), so one rounding
#         step apart on |out| < 1 is < 4e-3.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
MAXSIM_TOL = 1e-5          # fp32 scores in [-1, 1], summation order only
# /v1/score (kernels) vs a plain-path recomputation: both run the model in
# bf16, so the kernels' and the plain versions' roundings differ at 2^-8
# relative per step through 12 layers; bound the cosine-level drift at 2e-2
SCORE_TOL_PER_UNIT_SCALE = 2e-2


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def jpeg_b64(rng, h: int, w: int) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype="uint8")).save(
        buf, format="JPEG", quality=90)
    return base64.b64encode(buf.getvalue()).decode()


def http(port: int, path: str, body=None):
    """(response JSON, seconds) for a GET (body None) or a JSON POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise RuntimeError(f"{path}: HTTP {r.status}")
        out = json.loads(r.read())
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def plain_attention():
    """Route the towers' attention through the plain version (for the
    plain-path recomputation only)."""
    from colxlip_tpu_torch.ops import attention

    kernel = attention.fused_mha_packed
    attention.fused_mha_packed = attention.fused_mha_plain
    try:
        yield
    finally:
        attention.fused_mha_packed = kernel


def main() -> int:
    import torch

    # ---- phase 1: device -------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from colxlip_tpu_torch.ops import attention, build, maxsim
    from colxlip_tpu_torch.serving.server import (
        ColXLIPService, disable_tf32, make_server)

    disable_tf32()  # fp32 matmuls in full fp32 (the plain versions, scores)
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[1 device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    # ---- phase 2: build --------------------------------------------------
    kernels = build.load_kernels()
    log(f"[2 build] {kernels.build_seconds:.1f} s nvcc {' '.join(build.NVCC_FLAGS)}"
        f" -> {kernels.path.relative_to(build.PKG_DIR.parent)}")

    # ---- phase 3: each kernel against its plain version -------------------
    gen = torch.Generator(device="cpu").manual_seed(0)
    attn_cases = [
        # name, B, N, H, D, causal, dtype
        ("vision", 64, 197, 12, 64, False, torch.bfloat16),
        ("text", 64, 77, 8, 64, True, torch.bfloat16),
        ("tiny-d32", 8, 32, 4, 32, True, torch.bfloat16),
        ("vision-fp32", 64, 197, 12, 64, False, torch.float32),
    ]
    attn_inputs, attn_err = {}, 0.0
    with torch.inference_mode():
        for name, b, n, h, d, causal, dtype in attn_cases:
            qkv = torch.randn(b, n, 3 * h * d, generator=gen).to(dev, dtype)
            got = attention.fused_mha_packed(qkv, h, causal)
            want = attention.fused_mha_plain(qkv, h, causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = ATTN_TOL[str(dtype).split(".")[-1]]
            log(f"[3 kernels] attention {name} B={b} N={n} H={h} D={d} "
                f"causal={causal} {dtype}: max_abs_err {err:.3g} (tol {tol})")
            if not err <= tol:
                raise RuntimeError(f"attention {name}: {err} > {tol}")
            attn_err = max(attn_err, err)
            attn_inputs[name] = (qkv, h, causal)

        m = k = 64
        lt, li, d = 77, 196, 512
        t = torch.nn.functional.normalize(torch.randn(m, lt, d, generator=gen), dim=-1)
        eot = torch.randint(3, lt, (m,), generator=gen)
        keep = torch.arange(lt)[None, :] < eot[:, None]
        t = (t * keep[:, :, None]).to(dev)           # zero text rows past EOT
        img = torch.nn.functional.normalize(
            torch.randn(k, li, d, generator=gen), dim=-1).to(dev)
        text_mask = keep.float().to(dev)
        maxsim_err = 0.0
        for mode in ("nonzero", "plain", "valid"):
            got = maxsim.maxsim(t, img, mask_mode=mode, text_mask=text_mask)
            want = maxsim.maxsim_plain(t, img, mask_mode=mode, text_mask=text_mask)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            log(f"[3 kernels] maxsim {mode} M={m} K={k} Lt={lt} Li={li} D={d} "
                f"fp32: max_abs_err {err:.3g} (tol {MAXSIM_TOL})")
            if not err <= MAXSIM_TOL:
                raise RuntimeError(f"maxsim {mode}: {err} > {MAXSIM_TOL}")
            maxsim_err = max(maxsim_err, err)

    # ---- phase 4: the serving slice over HTTP ------------------------------
    t0 = time.perf_counter()
    svc = ColXLIPService(MODEL, device=dev, max_batch=MAX_BATCH, seed=0)
    httpd = make_server(svc, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    log(f"[4 slice] {MODEL} random init (seed 0) on {dev}, bf16 compute, "
        f"built in {time.perf_counter() - t0:.1f} s; serving on port {port}")
    rng = np.random.default_rng(0)
    captions = ["a photo of a cat sleeping on a red sofa",
                "two dogs running on the beach at sunset",
                "a bowl of ramen with an egg"]
    images = [jpeg_b64(rng, int(rng.integers(200, 320)), int(rng.integers(200, 320)))
              for _ in range(3)]
    wide_texts = [f"a photo of item number {i} on a wooden table" for i in range(MAX_BATCH)]
    wide_images = [jpeg_b64(rng, 240, 300) for _ in range(MAX_BATCH)]
    requests = [
        ("/healthz", None),
        ("/v1/embed/text", {"texts": captions, "return_tokens": True}),
        ("/v1/embed/image", {"images_b64": images}),
        ("/v1/score", {"texts": captions, "images_b64": images, "scoring": "maxsim"}),
        ("/v1/score", {"texts": captions, "images_b64": images, "scoring": "mixed"}),
        ("/v1/score", {"texts": wide_texts, "images_b64": wide_images,
                       "scoring": "maxsim"}),
    ]
    try:
        attention.LAUNCHES.reset()
        maxsim.LAUNCHES.reset()
        results = [http(port, path, body) for path, body in requests]
        torch.cuda.synchronize()
        launches = {"fused_attention": attention.LAUNCHES.value,
                    "maxsim": maxsim.LAUNCHES.value}
        log(f"[4 slice] {len(requests)} requests: "
            + ", ".join(f"{p} {s * 1e3:.0f} ms" for (p, _), (_, s) in zip(requests, results))
            + f" | kernel launches {launches}")
        if min(launches.values()) < 1:
            raise RuntimeError(f"a kernel of the path was never launched: {launches}")

        health = results[0][0]
        if health["status"] != "ok" or health["embed_dim"] != 512:
            raise RuntimeError(f"/healthz: {health}")
        for i, shape in ((1, (3, 512)), (2, (3, 512))):
            emb = np.asarray(results[i][0]["embeddings"], np.float32)
            norms = np.linalg.norm(emb, axis=-1)
            if emb.shape != shape or not np.isfinite(emb).all() or \
                    np.abs(norms - 1).max() > 1e-2:
                raise RuntimeError(f"{requests[i][0]}: shape {emb.shape}, "
                                   f"norms {norms}")
        # token features: unit norm before EOT (at and after it they are the
        # token head's response to a zeroed input, all-zero at random init)
        tok = np.asarray(results[1][0]["token_embeddings"], np.float32)
        eot = svc.tokenize(captions).argmax(axis=-1)
        before = np.arange(tok.shape[1])[None, :] < eot[:, None]
        if tok.shape != (3, 77, 512) or not np.isfinite(tok).all() or \
                np.abs(np.linalg.norm(tok, axis=-1)[before] - 1).max() > 1e-2:
            raise RuntimeError(f"text token embeddings: shape {tok.shape}")

        # /v1/score against the plain path (plain attention in the towers,
        # plain MaxSim, same weights, same inputs, same device)
        scale = svc.logit_scale
        score_err = 0.0
        for i in (3, 4, 5):
            body = requests[i][1]
            sim = np.asarray(results[i][0]["similarity"], np.float32)
            n_img, n_txt = len(body["images_b64"]), len(body["texts"])
            if sim.shape != (n_img, n_txt) or not np.isfinite(sim).all():
                raise RuntimeError(f"/v1/score: shape {sim.shape}")
            with plain_attention(), torch.inference_mode():
                txt = svc.engine.run("text", svc.tokenize(body["texts"]))
                im = svc.engine.run("image", svc.decode_images(body["images_b64"]))
                token = scale * maxsim.maxsim_plain(
                    txt[1].float(), im[1].float(), mask_mode=svc.mask_mode).T
                if body["scoring"] == "mixed":
                    glob = scale * (im[0].float() @ txt[0].float().T)
                    token = svc.alpha * glob + (1 - svc.alpha) * token
                want = token.cpu().numpy()
            err = float(np.abs(sim - want).max())
            score_err = max(score_err, err)
            tol = SCORE_TOL_PER_UNIT_SCALE * scale
            log(f"[4 slice] /v1/score {body['scoring']} {n_img}x{n_txt} vs plain "
                f"path: max_abs_err {err:.3g} (tol {tol:.3g} = "
                f"{SCORE_TOL_PER_UNIT_SCALE} x logit_scale {scale:.4f}); "
                f"|score| max {np.abs(want).max():.3g}")
            if not err <= tol:
                raise RuntimeError(f"/v1/score {body['scoring']}: {err} > {tol}")

        # ---- phase 5: timings --------------------------------------------
        timing = {}
        with torch.inference_mode():
            for name, (qkv, h, causal) in attn_inputs.items():
                ker = cuda_ms(lambda: attention.fused_mha_packed(qkv, h, causal), 20)
                plain = cuda_ms(lambda: attention.fused_mha_plain(qkv, h, causal), 20)
                timing[f"attention/{name}"] = (ker, plain)
            for mode in ("nonzero", "plain", "valid"):
                ker = cuda_ms(lambda: maxsim.maxsim(t, img, mask_mode=mode,
                                                    text_mask=text_mask), 10)
                plain = cuda_ms(lambda: maxsim.maxsim_plain(
                    t, img, mask_mode=mode, text_mask=text_mask), 10)
                timing[f"maxsim/{mode}"] = (ker, plain)
        for key, (ker, plain) in timing.items():
            log(f"[5 timing] {key}: kernel {ker:.4f} ms, plain {plain:.4f} ms "
                f"({card})")

        img_batch = svc.decode_images(wide_images)
        txt_batch = svc.tokenize(wide_texts)
        for kind, batch in (("image", img_batch), ("text", txt_batch)):
            ms = cuda_ms(lambda: svc.engine.run(kind, batch), 10)
            unit = "img/s" if kind == "image" else "txt/s"
            log(f"[5 timing] encode {kind} batch {MAX_BATCH} (host batch -> "
                f"normalized features on device): {ms:.3f} ms = "
                f"{MAX_BATCH / ms * 1e3:.1f} {unit} ({card})")
        lat = {}
        for _ in range(5):
            for path, body in requests[1:5]:
                key = path + ("" if body.get("scoring") is None else f"[{body['scoring']}]")
                lat.setdefault(key, []).append(http(port, path, body)[1])
        lat["/v1/score[maxsim] 64x64"] = [http(port, *requests[5])[1] for _ in range(3)]
        for key, secs in lat.items():
            log(f"[5 timing] request {key}: median {statistics.median(secs) * 1e3:.1f} ms "
                f"over {len(secs)} ({card})")
        log(f"[5 timing] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        httpd.shutdown()
        svc.stop()
        server.join(timeout=30)

    print(json.dumps({"kernels": [
        {"name": "fused_attention_fwd", "route": "cuda",
         "source": "colxlip_tpu_torch/csrc/fused_attention.cu",
         "replaces": "colxlip_tpu/ops/fused_attention.py:103",
         "launches": launches["fused_attention"], "max_abs_err": attn_err,
         "ms": timing["attention/vision"][0],
         "plain_ms": timing["attention/vision"][1]},
        {"name": "maxsim_fwd", "route": "cuda",
         "source": "colxlip_tpu_torch/csrc/maxsim.cu",
         "replaces": "colxlip_tpu/ops/maxsim_pallas.py:86",
         "launches": launches["maxsim"], "max_abs_err": maxsim_err,
         "ms": timing["maxsim/nonzero"][0],
         "plain_ms": timing["maxsim/nonzero"][1]},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
