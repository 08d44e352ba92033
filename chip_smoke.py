#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (colxlip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printed on its own lines; any failure raises (non-zero exit):

  1. device: requires torch.cuda.is_available(); prints the card's name and
     power limit (nvidia-smi).
  2. build: compiles colxlip_tpu_torch/csrc/*.cu with nvcc for sm_90a (one
     nvcc per source, all at once).
  3. kernels: each forward kernel against its plain PyTorch version at the
     serving shapes, and each backward kernel against its plain version at
     the training shapes (batch 256) in fp32 and bf16, with the tolerances
     below.
  4. serving slice: ColXLIPService (ViT-B-16-colxlip, full width, random
     init from seed 0, bf16 compute) behind make_server on an ephemeral
     port, driven over HTTP; checks finite unit-norm embeddings, that both
     forward kernels were launched by the requests, and the /v1/score
     matrices against a plain-path recomputation on the same device.
  5. timings (CUDA events, after warm-up): each kernel against its plain
     version, encode throughput at batch 64, request latency.
  6. train slice: make_train_step on ViT-B-16-colxlip (full width and depth,
     seed 0, fp32 parameters, bf16 compute), colclip loss (alpha 0.5, mask
     'nonzero'), AdamW with a cosine schedule, batch 256 of seeded synthetic
     images and token ids, TRAIN_STEPS steps on one fixed batch; checks that
     every loss is finite and the loss falls, that every forward and
     backward kernel was launched by the steps, and (at batch 64) the step's
     losses and gradients against the same step through the plain versions;
     times the step (ms, img/s), reads the peak device memory, and prints
     the device time of one more step by kernel (torch.profiler) with the
     device's idle share of that step.

The last line is {"ok": true, "device": {...}}; the line before it is the
nvidia-smi name and power limit, and before that one JSON object with the
per-kernel results.
"""
from __future__ import annotations

import base64
import contextlib
import copy
import io
import json
import math
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
# backward kernels vs their plain versions, relative to the largest |grad|:
#   fp32: summation order only (1e-5);
#   bf16: each gradient is summed in fp32 and rounded to bf16 once, and the
#         attention backward rounds dz and p to bf16 on the way, where the
#         two versions may land one step apart: 2^-7 (two bf16 steps).
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TRAIN_BATCH = 256
TRAIN_STEPS = 10
COMPARE_BATCH = 64
# the train step through the kernels vs through the plain versions (batch
# 64, same weights and inputs), per gradient tensor: (min cosine, max
# relative norm difference) and the max relative difference of the losses.
#   fp32 compute: the kernels and the plain versions differ by summation
#     order only (1e-7 relative per call), grown through 12 layers of each
#     tower and the backward: cosine >= 0.9999, norms and losses 1e-3.
#   bf16 compute: the two round bf16 intermediates at different places, and
#     the differences compound through the towers; the LayerNorm-bias
#     gradients are sums over 12,544 tokens with heavy cancellation, whose
#     direction moves by about 1e-2 between two roundings (cosine 0.991 for
#     vision_token_layer.0.bias in the first run on the H100). So: cosine
#     >= 0.98, norms 5e-2, losses 1e-2.
STEP_TOL = {"float32": (0.9999, 1e-3, 1e-3), "bfloat16": (0.98, 5e-2, 1e-2)}


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
def plain_versions():
    """Route CUDA tensors through the kernels' plain versions, forward and
    backward (for the plain-path recomputations only)."""
    from colxlip_tpu_torch.ops import attention, maxsim

    saved = [(mod, name, getattr(mod, name)) for mod in (attention, maxsim)
             for name in ("_launch_fwd", "_launch_bwd")]
    attention._launch_fwd = attention.fused_mha_plain
    attention._launch_bwd = attention.fused_mha_bwd_plain
    maxsim._launch_fwd = lambda t, i, mode, mask: maxsim.maxsim_plain(
        t, i, mask_mode=mode, text_mask=mask)
    maxsim._launch_bwd = lambda t, i, g, mode, mask: maxsim.maxsim_bwd_plain(
        t, i, g, mask_mode=mode, text_mask=mask)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def max_rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (both read as fp32)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def check_backward_kernels(dev, gen):
    """Phase 3b: each backward kernel against its plain version at the
    training shapes, in fp32 and bf16. Returns (max errors, timing inputs)."""
    import torch

    from colxlip_tpu_torch.ops import attention, maxsim

    errs = {"attention_bwd": 0.0, "maxsim_bwd": 0.0}
    inputs = {}
    for name, b, n, h, d, causal in (("vision", TRAIN_BATCH, 197, 12, 64, False),
                                     ("text", TRAIN_BATCH, 77, 8, 64, True),
                                     ("tiny-d32", 8, 32, 4, 32, True)):
        qkv = torch.randn(b, n, 3 * h * d, generator=gen)
        dout = torch.randn(b, n, h * d, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            q, g = qkv.to(dev, dtype), dout.to(dev, dtype)
            got = attention._launch_bwd(q, g, h, causal)
            want = attention.fused_mha_bwd_plain(q, g, h, causal)
            torch.cuda.synchronize()
            err, tol = max_rel_err(got, want), BWD_TOL[str(dtype).split(".")[-1]]
            log(f"[3 kernels] attention bwd {name} B={b} N={n} H={h} D={d} "
                f"causal={causal} {dtype}: max_abs_err / max|grad| {err:.3g} (tol {tol})")
            if not err <= tol:
                raise RuntimeError(f"attention bwd {name} {dtype}: {err} > {tol}")
            errs["attention_bwd"] = max(errs["attention_bwd"], err)
            if dtype == torch.bfloat16:
                inputs[f"attention_bwd/{name}"] = (q, g, h, causal)
            del got, want

    m = k = TRAIN_BATCH
    lt, li, d = 77, 196, 512
    t = torch.nn.functional.normalize(torch.randn(m, lt, d, generator=gen), dim=-1)
    eot = torch.randint(3, lt, (m,), generator=gen)
    keep = torch.arange(lt)[None, :] < eot[:, None]
    t = t * keep[:, :, None]                                # zero rows past EOT
    img = torch.nn.functional.normalize(torch.randn(k, li, d, generator=gen), dim=-1)
    gs = torch.randn(m, k, generator=gen) / m
    text_mask = keep.float().to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        tt, ii, g = t.to(dev, dtype), img.to(dev, dtype), gs.to(dev)
        modes = ("nonzero", "plain", "valid") if dtype == torch.bfloat16 else ("nonzero",)
        for mode in modes:
            got = maxsim._launch_bwd(tt, ii, g, mode, text_mask)
            want = maxsim.maxsim_bwd_plain(tt, ii, g, mask_mode=mode, text_mask=text_mask)
            torch.cuda.synchronize()
            err = max(max_rel_err(a, w) for a, w in zip(got, want))
            tol = BWD_TOL[str(dtype).split(".")[-1]]
            log(f"[3 kernels] maxsim bwd {mode} M={m} K={k} Lt={lt} Li={li} D={d} {dtype}: "
                f"max_abs_err / max|grad| {err:.3g} (tol {tol}) (dT, dI)")
            if not err <= tol:
                raise RuntimeError(f"maxsim bwd {mode} {dtype}: {err} > {tol}")
            errs["maxsim_bwd"] = max(errs["maxsim_bwd"], err)
            del got, want
        if dtype == torch.bfloat16:
            inputs["maxsim_bwd"] = (tt, ii, g, text_mask)
    return errs, inputs


def synthetic_batch(n: int, image_size: int, ctx: int, seed: int):
    """Seeded NHWC float images and token ids laid out like bench.py's:
    SOT, 19 random ids, EOT at column 20, zeros after."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, image_size, image_size, 3)).astype(np.float32)
    texts = np.zeros((n, ctx), np.int64)
    texts[:, 0] = 49406
    texts[:, 1:20] = rng.integers(1, 49000, (n, 19))
    texts[:, 20] = 49407
    return images, texts


def compare_step(dev, dtype, ref_state, step_cfg, images, texts) -> None:
    """One train step (learning rate 0) through the kernels and through the
    plain versions on the same weights and inputs; raises on disagreement."""
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.parallel.train_step import make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    results = []
    for plain in (False, True):
        model, _ = create_model(MODEL, dev, dtype, seed=0)
        model.load_state_dict(ref_state)
        model.train()
        zero = const_lr(0.0, 0)
        step = make_train_step(model, create_optimizer(model, zero), zero, step_cfg)
        with plain_versions() if plain else contextlib.nullcontext():
            metrics = step(images, texts)
        grads = {k: p.grad.float() for k, p in model.named_parameters()}
        results.append(({k: float(v) for k, v in metrics.items()}, grads))
        del step, model
    (m_k, g_k), (m_p, g_p) = results
    cos_min, norm_tol, loss_tol = STEP_TOL[str(dtype).split(".")[-1]]
    loss_err = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-30) for k in m_p)
    cosines, norm_err = {}, 0.0
    for name, w in g_p.items():
        g = g_k[name]
        nw, ng = w.norm().item(), g.norm().item()
        if nw == 0 and ng == 0:
            continue
        cosines[name] = (g * w).sum().item() / max(nw * ng, 1e-30)
        norm_err = max(norm_err, abs(ng - nw) / max(nw, 1e-30))
    worst = sorted(cosines, key=cosines.get)[:3]
    log(f"[6 train] batch {images.shape[0]} step in {dtype}, kernels vs plain versions: "
        + " ".join(f"{k} {m_k[k]:.5f}/{m_p[k]:.5f}" for k in m_p)
        + f"; max rel loss diff {loss_err:.3g} (tol {loss_tol}); lowest per-tensor grad "
        f"cosines " + ", ".join(f"{n} {cosines[n]:.5f}" for n in worst)
        + f" (min {cos_min}); max rel per-tensor grad-norm diff {norm_err:.3g} "
        f"(tol {norm_tol}); {len(g_p)} tensors")
    if not (loss_err <= loss_tol and cosines[worst[0]] >= cos_min and norm_err <= norm_tol):
        raise RuntimeError(f"the {dtype} train step through the kernels disagrees with "
                           "the plain versions")


def profile_step(step, images, texts, card: str) -> None:
    """Device time of one step by kernel, and the device's idle share of it
    (torch.profiler; the step's wall time includes the profiler's cost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(images, texts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[6 train] profiled step: {device_ms:.1f} ms of kernels in {wall_ms:.1f} ms "
        f"(device idle {max(0.0, 1 - device_ms / wall_ms):.1%}) ({card})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[6 train]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d} x  "
            f"{e.key[:90]}")


def train_phase(dev, card: str):
    """Phase 6: the one-GPU train step at full ViT-B-16-colxlip width."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention, maxsim
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import cosine_lr

    t0 = time.perf_counter()
    model, cfg = create_model(MODEL, dev, torch.bfloat16, seed=0)
    model.train()
    ref_state = copy.deepcopy(model.state_dict())
    size = cfg.vision_cfg.image_size
    images, texts = synthetic_batch(TRAIN_BATCH, size, cfg.text_cfg.context_length, seed=0)
    images = torch.from_numpy(images).to(dev)
    texts = torch.from_numpy(texts).to(dev)
    step_cfg = TrainStepConfig(loss_type="colclip", alpha=0.5, mask_mode="nonzero")
    schedule = cosine_lr(2e-4, 2, TRAIN_STEPS)
    step = make_train_step(model, create_optimizer(model, schedule), schedule, step_cfg)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[6 train] {MODEL} random init (seed 0) on {dev}: {n_params / 1e6:.1f} M fp32 "
        f"params, bf16 compute, colclip (alpha 0.5, mask nonzero), AdamW cosine_lr(2e-4, "
        f"warmup 2, {TRAIN_STEPS} steps), batch {TRAIN_BATCH} x {size}px / "
        f"{cfg.text_cfg.context_length} tokens; built in {time.perf_counter() - t0:.1f} s")

    counters = {"fused_attention_fwd": attention.LAUNCHES, "fused_attention_bwd":
                attention.BWD_LAUNCHES, "maxsim_fwd": maxsim.LAUNCHES,
                "maxsim_bwd": maxsim.BWD_LAUNCHES}
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        vals = {k: float(v) for k, v in metrics.items()}
        losses.append(vals["total_loss"])
        log(f"[6 train] step {i}: " + " ".join(f"{k} {v:.5f}" for k, v in vals.items())
            + f" | {secs[-1] * 1e3:.1f} ms")
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"step {i}: non-finite metrics {vals}")
    launches = {name: c.value for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[6 train] kernel launches over {TRAIN_STEPS} steps: {launches}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the train step was never launched: {launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    step_ms = statistics.median(secs[2:]) * 1e3
    log(f"[6 train] loss {losses[0]:.5f} -> {losses[-1]:.5f}; step at batch {TRAIN_BATCH}: "
        f"median {step_ms:.2f} ms over steps 2..{TRAIN_STEPS - 1} = "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} img/s; peak device memory {peak:.2f} GiB ({card})")

    profile_step(step, images, texts, card)
    del step, model
    torch.cuda.empty_cache()

    # the same step through the kernels and through the plain versions, at
    # batch COMPARE_BATCH (the plain attention backward holds [B, H, N, N]),
    # in fp32 and in bf16 compute
    for dtype in (torch.float32, torch.bfloat16):
        compare_step(dev, dtype, ref_state, step_cfg, images[:COMPARE_BATCH],
                     texts[:COMPARE_BATCH])
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak,
            "losses": losses}


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
    bwd_err, bwd_inputs = check_backward_kernels(dev, gen)

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
        for counter in (attention.LAUNCHES, attention.BWD_LAUNCHES, maxsim.LAUNCHES,
                        maxsim.BWD_LAUNCHES):
            counter.reset()
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
            with plain_versions(), torch.inference_mode():
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
            # forward kernels at the training shapes (batch 256, bf16)
            for name in ("vision", "text"):
                qkv, _, h, causal = bwd_inputs[f"attention_bwd/{name}"]
                timing[f"attention/{name}-train"] = (
                    cuda_ms(lambda: attention.fused_mha_packed(qkv, h, causal), 10),
                    cuda_ms(lambda: attention.fused_mha_plain(qkv, h, causal), 10))
            tt, ii, g, tmask = bwd_inputs["maxsim_bwd"]
            timing["maxsim/nonzero-train"] = (
                cuda_ms(lambda: maxsim.maxsim(tt, ii), 5),
                cuda_ms(lambda: maxsim.maxsim_plain(tt, ii), 5))
        # backward kernels at the training shapes (batch 256, bf16)
        for name in ("vision", "text", "tiny-d32"):
            qkv, dout, h, causal = bwd_inputs[f"attention_bwd/{name}"]
            timing[f"attention_bwd/{name}"] = (
                cuda_ms(lambda: attention._launch_bwd(qkv, dout, h, causal), 10),
                cuda_ms(lambda: attention.fused_mha_bwd_plain(qkv, dout, h, causal), 10))
        timing["maxsim_bwd/nonzero"] = (
            cuda_ms(lambda: maxsim._launch_bwd(tt, ii, g, "nonzero", None), 5),
            cuda_ms(lambda: maxsim.maxsim_bwd_plain(tt, ii, g), 5))
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
    del svc, bwd_inputs
    torch.cuda.empty_cache()

    # ---- phase 6: the train slice -----------------------------------------
    train = train_phase(dev, card)

    tl = train["launches"]
    print(json.dumps({"kernels": [
        {"name": "fused_attention_fwd", "route": "cuda",
         "source": "colxlip_tpu_torch/csrc/fused_attention.cu",
         "replaces": "colxlip_tpu/ops/fused_attention.py:103",
         "launches": tl["fused_attention_fwd"], "launches_serving": launches["fused_attention"],
         "max_abs_err": attn_err, "ms": timing["attention/vision"][0],
         "plain_ms": timing["attention/vision"][1]},
        {"name": "fused_attention_bwd", "route": "cuda",
         "source": "colxlip_tpu_torch/csrc/fused_attention_bwd.cu",
         "replaces": "colxlip_tpu/ops/fused_attention.py:115",
         "launches": tl["fused_attention_bwd"], "max_abs_err": bwd_err["attention_bwd"],
         "ms": timing["attention_bwd/vision"][0],
         "plain_ms": timing["attention_bwd/vision"][1]},
        {"name": "maxsim_fwd", "route": "cuda",
         "source": "colxlip_tpu_torch/csrc/maxsim.cu",
         "replaces": "colxlip_tpu/ops/maxsim_pallas.py:86",
         "launches": tl["maxsim_fwd"], "launches_serving": launches["maxsim"],
         "max_abs_err": maxsim_err, "ms": timing["maxsim/nonzero"][0],
         "plain_ms": timing["maxsim/nonzero"][1]},
        {"name": "maxsim_bwd", "route": "cuda",
         "source": "colxlip_tpu_torch/csrc/maxsim_bwd.cu",
         "replaces": "colxlip_tpu/ops/maxsim_pallas.py:244",
         "launches": tl["maxsim_bwd"], "max_abs_err": bwd_err["maxsim_bwd"],
         "ms": timing["maxsim_bwd/nonzero"][0],
         "plain_ms": timing["maxsim_bwd/nonzero"][1]},
    ], "train_step": {"batch": TRAIN_BATCH, "ms": train["step_ms"],
                      "img_per_s": TRAIN_BATCH / train["step_ms"] * 1e3,
                      "peak_gib": train["peak_gib"]}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
