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
     below; the three streaming-CE kernels (forward, dA + dscale, dB) in
     fp32 and bf16 at M = N = 256 and 4096 (D = 512), M = 33, N = 129
     (D = 64), and in bf16 at M = N = 32768, where the dense fp32 logits
     would be 4 GiB: the kernel path's peak memory there is printed and
     bounded, and two runs of the backward must agree bit for bit.
  4. serving slice: ColXLIPService (ViT-B-16-colxlip, full width, random
     init from seed 0, bf16 compute) behind make_server on an ephemeral
     port, driven over HTTP; checks finite unit-norm embeddings, that both
     forward kernels were launched by the requests, and the /v1/score
     matrices against a plain-path recomputation on the same device.
  5. timings (CUDA events, after warm-up): each kernel against its plain
     version, and against the one PyTorch call that computes the same
     function where there is one (scaled_dot_product_attention, forward and
     backward; for the streaming CE the pair torch.matmul + F.cross_entropy
     over the dense logits is timed beside it); encode throughput at batch
     64, request latency. The library calls are timed only: the port never
     calls them.
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
  7. training entry point: colxlip_tpu_torch.main.main([...]) in process,
     ViT-B-16 (full width and depth, clip loss) with --dataset-type
     synthetic --batch-size 256 --precision bf16 --ce-impl fused, 2 epochs
     of 6 steps with fresh batches from the prefetch threads, a checkpoint
     per epoch; checks the return code, that every logged loss is finite and
     the first is near ln 256, that epoch_1, epoch_2, params.txt, out.log and
     metrics.jsonl exist, and that the steps launched the three CE kernels
     (two each a step) and the attention kernels; then --epochs 3 --resume
     latest must go on from epoch_2 and write epoch_3. Prints the step's ms
     and samples/s, data_time, the peak device memory and the device's idle
     share over three profiled steps.

The last line is {"ok": true, "device": {...}}; the line before it is the
nvidia-smi name and power limit, and before that one JSON object with the
per-kernel results: for each kernel its launches on its path (counters set
to 0 just before the path is driven), its largest error against the plain
version, its time beside the plain version's, the library call's (or null)
and the bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak for the input type (989 TFLOP/s bf16, 67
TFLOP/s fp32; NVIDIA's H100 SXM data sheet).
"""
from __future__ import annotations

import base64
import contextlib
import copy
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
# streaming-CE kernels vs their plain versions:
#   loss rows and lse: |got - want| / (1 + |want|) <= 1e-5 (fp32 sums of the
#     products in another order; a bf16 x bf16 product is exact in fp32);
#   dA, dB, dscale: 1e-4 of the largest |grad| (expf against torch.exp at
#     1e-7 relative, summed over up to 32768 terms at logits up to 100).
CE_FWD_TOL = 1e-5
CE_BWD_TOL = 1e-4
CE_CASES = [
    # M, N, D, logit scale, dtypes
    (256, 256, 512, 1 / 0.07, ("float32", "bfloat16")),     # one step of phase 7
    (33, 129, 64, 30.0, ("float32", "bfloat16")),
    (4096, 4096, 512, 100.0, ("float32", "bfloat16")),
    (32768, 32768, 512, 100.0, ("bfloat16",)),              # dense logits: 4 GiB
]
CE_PEAK_LIMIT_GIB = 1.0     # kernel path at 32768, above its inputs
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TRAIN_BATCH = 256
TRAIN_STEPS = 10
MAIN_MODEL = "ViT-B-16"
MAIN_STEPS_PER_EPOCH = 6
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


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    """(least ms the card could take, 'bytes' or 'operations'): each input
    read once and each output written once at the memory rate, against the
    operations at the peak rate for the input type."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_bounds(qkv_fwd, qkv_bwd, heads, maxsim_fwd, maxsim_bwd, ce):
    """bound_ms of every kernel at the shape its ``ms`` is timed at, from the
    tensors themselves: attention (packed QKV [B, N, 3 H D]; 4 B H N^2 D
    flops forward, 10 backward: five products), MaxSim (text [M, Lt, D],
    image [K, Li, D]; the similarities are 2 M K Lt Li D flops, the backward
    adds dT and dI at 2 M K Lt D each), CE (a [M, D], b [N, D]; 2 M N D
    forward, 4 M N D in dA and in dB)."""
    def name(t):
        return str(t.dtype).split(".")[-1]

    out = {}
    for key, qkv, passes, flop_factor in (("fused_attention_fwd", qkv_fwd, 4, 4),
                                          ("fused_attention_bwd", qkv_bwd, 7, 10)):
        b, n, width = qkv.shape
        hd = width // 3
        out[key] = bound_ms(b * n * hd * passes * qkv.element_size(),
                            flop_factor * b * n * n * hd, name(qkv))
    for key, (text, image), backward in (("maxsim_fwd", maxsim_fwd, False),
                                         ("maxsim_bwd", maxsim_bwd, True)):
        (m, lt, d), (k, li, _) = text.shape, image.shape
        feats = (m * lt + k * li) * d * text.element_size()
        flops = 2 * m * k * lt * li * d + (4 * m * k * lt * d if backward else 0)
        out[key] = bound_ms(feats * (2 if backward else 1) + m * k * 4, flops, name(text))
    a, b = ce
    (m, d), n = a.shape, b.shape[0]
    feats = (m + n) * d * a.element_size()
    out["fused_ce_fwd"] = bound_ms(feats + 3 * m * 4, 2 * m * n * d, name(a))
    out["fused_ce_bwd_da"] = bound_ms(feats + 4 * m * 4 + m * d * 4, 4 * m * n * d, name(a))
    out["fused_ce_bwd_db"] = bound_ms(feats + 3 * m * 4 + n * d * 4, 4 * m * n * d, name(a))
    return out


def ce_inputs(m, n, d, scale, dtype, dev, gen):
    import torch

    a, b = (torch.nn.functional.normalize(torch.randn(rows, d, generator=gen), dim=-1)
            .to(dev, dtype) for rows in (m, n))
    labels = torch.randint(0, n, (m,), generator=gen, dtype=torch.int32).to(dev)
    g = (torch.rand(m, generator=gen) / m).to(dev)
    return a, b, labels, torch.tensor(scale, device=dev), g


def check_ce_kernels(dev, gen):
    """Phase 3c: the three streaming-CE kernels against their plain versions.
    Returns (max errors per kernel, bf16 inputs by M for the timings)."""
    import torch

    from colxlip_tpu_torch.ops import fused_ce

    def unit_err(got, want):
        return ((got - want).abs() / (1 + want.abs())).max().item()

    errs = {"fused_ce_fwd": 0.0, "fused_ce_bwd_da": 0.0, "fused_ce_bwd_db": 0.0}
    inputs = {}
    for m, n, d, scale, dtypes in CE_CASES:
        for name in dtypes:
            a, b, labels, s, g = ce_inputs(m, n, d, scale, getattr(torch, name), dev, gen)
            loss, lse = fused_ce._launch_fwd(a, b, labels, s)
            da, ds = fused_ce._launch_bwd_da(a, b, labels, s, lse, g)
            db = fused_ce._launch_bwd_db(a, b, labels, s, lse, g)
            again = (*fused_ce._launch_bwd_da(a, b, labels, s, lse, g),
                     fused_ce._launch_bwd_db(a, b, labels, s, lse, g))
            want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
            # the plain backward starts from the plain lse: only the kernels differ
            want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, want_lse, g)
            want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, want_lse, g)
            torch.cuda.synchronize()
            err = {"fused_ce_fwd": max(unit_err(loss, want_loss), unit_err(lse, want_lse)),
                   "fused_ce_bwd_da": max(max_rel_err(da, want_da), max_rel_err(ds, want_ds)),
                   "fused_ce_bwd_db": max_rel_err(db, want_db)}
            log(f"[3 kernels] fused CE M={m} N={n} D={d} scale={scale:.4g} {name}: fwd "
                f"|err| / (1 + |loss|) {err['fused_ce_fwd']:.3g} (tol {CE_FWD_TOL}); "
                f"max_abs_err / max|grad| dA+dscale {err['fused_ce_bwd_da']:.3g}, dB "
                f"{err['fused_ce_bwd_db']:.3g} (tol {CE_BWD_TOL}); loss mean "
                f"{loss.mean().item():.5f}")
            if not (err["fused_ce_fwd"] <= CE_FWD_TOL and torch.isfinite(loss).all()
                    and err["fused_ce_bwd_da"] <= CE_BWD_TOL
                    and err["fused_ce_bwd_db"] <= CE_BWD_TOL):
                raise RuntimeError(f"fused CE M={m} N={n} {name}: {err}")
            if not all(torch.equal(x, y) for x, y in zip((da, ds, db), again)):
                raise RuntimeError(f"fused CE M={m} N={n} {name}: two runs of the backward "
                                   "kernels differ (they use no atomics)")
            errs = {k: max(v, err[k]) for k, v in errs.items()}
            if name == "bfloat16":
                inputs[m] = (a, b, labels, s, lse, g)
            del loss, da, ds, db, again, want_loss, want_lse, want_da, want_ds, want_db

    # no [M, N] tensor on the kernel path: forward and backward under autograd
    a, b, labels, s, _, _ = inputs[32768]
    a_, b_, s_ = a.clone().requires_grad_(), b.clone().requires_grad_(), \
        s.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fused_ce.fused_contrastive_ce(a_, b_, labels, s_).backward()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    dense = a.shape[0] * b.shape[0] * 4 / 2**30
    log(f"[3 kernels] fused CE M=N=32768 bf16 forward + backward under autograd: peak device "
        f"memory {peak:.3f} GiB above the inputs (limit {CE_PEAK_LIMIT_GIB}; dense fp32 "
        f"logits alone would be {dense:.0f} GiB); two backward runs bit-equal at every shape")
    if not (peak <= CE_PEAK_LIMIT_GIB and torch.isfinite(a_.grad).all()
            and torch.isfinite(b_.grad).all() and torch.isfinite(s_.grad)):
        raise RuntimeError(f"fused CE at 32768: peak {peak} GiB or non-finite gradients")
    return errs, inputs


def time_ce_kernels(inputs, card: str):
    """Phase 5: each CE kernel, its plain version and the dense pair
    (fp32 torch.matmul + F.cross_entropy, forward and forward + backward)."""
    import torch
    import torch.nn.functional as F

    from colxlip_tpu_torch.ops import fused_ce

    timing = {}
    for m, (a, b, labels, s, lse, g) in inputs.items():
        iters, warm = (50, 3) if m <= 256 else (10, 2) if m <= 4096 else (2, 1)
        row = {
            "fwd": (cuda_ms(lambda: fused_ce._launch_fwd(a, b, labels, s), iters, warm),
                    cuda_ms(lambda: fused_ce.fused_ce_fwd_plain(a, b, labels, s), iters, warm)),
            "bwd_da": (
                cuda_ms(lambda: fused_ce._launch_bwd_da(a, b, labels, s, lse, g), iters, warm),
                cuda_ms(lambda: fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, lse, g),
                        iters, warm)),
            "bwd_db": (
                cuda_ms(lambda: fused_ce._launch_bwd_db(a, b, labels, s, lse, g), iters, warm),
                cuda_ms(lambda: fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, lse, g),
                        iters, warm)),
        }
        long_labels = labels.long()
        a_, b_, s_ = a.clone().requires_grad_(), b.clone().requires_grad_(), \
            s.clone().requires_grad_()

        def dense():
            return F.cross_entropy(s_ * torch.matmul(a_.float(), b_.float().T), long_labels)

        def dense_fwd():
            with torch.no_grad():
                dense()

        dense_ms = (cuda_ms(dense_fwd, iters, warm),
                    cuda_ms(lambda: torch.autograd.grad(dense(), (a_, b_, s_)), iters, warm))
        for key, (ker, plain) in row.items():
            timing[f"fused_ce_{key}/{m}"] = (ker, plain)
            log(f"[5 timing] fused_ce_{key} M=N={m} D={a.shape[1]} bf16: kernel {ker:.4f} ms, "
                f"plain {plain:.4f} ms ({card})")
        log(f"[5 timing] dense pair M=N={m} (fp32 torch.matmul + F.cross_entropy, holds "
            f"[M, N]): forward {dense_ms[0]:.4f} ms, forward + backward {dense_ms[1]:.4f} ms; "
            f"the three kernels together {sum(k for k, _ in row.values()):.4f} ms ({card})")
        timing[f"dense_ce/{m}"] = dense_ms
        del a_, b_, s_
        torch.cuda.empty_cache()
    return timing


def time_library_attention(qkv, dout, heads: int, causal: bool):
    """(forward ms, backward ms) of F.scaled_dot_product_attention on the
    same packed QKV (timed only: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    b, n, width = qkv.shape
    d = width // (3 * heads)
    q, k, v = (t.contiguous().requires_grad_()
               for t in qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    with torch.no_grad():
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 10)
    if dout is None:
        return fwd, None
    grad = dout.view(b, n, heads, d).permute(0, 2, 1, 3).contiguous()
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True), 10)
    return fwd, bwd


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


def main_phase(dev, card: str):
    """Phase 7: train ViT-B-16 through the port's training entry point."""
    import torch

    from colxlip_tpu_torch import main as entry
    from colxlip_tpu_torch.ops import attention, fused_ce
    from colxlip_tpu_torch.training.logging_utils import setup_logging

    counters = {"fused_attention_fwd": attention.LAUNCHES,
                "fused_attention_bwd": attention.BWD_LAUNCHES,
                "fused_ce_fwd": fused_ce.FWD_LAUNCHES,
                "fused_ce_bwd_da": fused_ce.BWD_DA_LAUNCHES,
                "fused_ce_bwd_db": fused_ce.BWD_DB_LAUNCHES}
    steps = 2 * MAIN_STEPS_PER_EPOCH
    with tempfile.TemporaryDirectory() as logs:
        argv = ["--model", MAIN_MODEL, "--dataset-type", "synthetic", "--batch-size",
                str(TRAIN_BATCH), "--precision", "bf16", "--ce-impl", "fused", "--epochs", "2",
                "--steps-per-epoch", str(MAIN_STEPS_PER_EPOCH), "--log-every-n-steps", "1",
                "--save-frequency", "1", "--workers", "0", "--seed", "0", "--logs", logs,
                "--name", "smoke"]
        log(f"[7 main] python -m colxlip_tpu_torch.main {' '.join(argv)}")
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        try:
            rc = entry.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {name: c.value for name, c in counters.items()}
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            if rc != 0:
                raise RuntimeError(f"main returned {rc}")
            base = os.path.join(logs, "smoke")
            for rel in ("checkpoints/epoch_1/state.pt", "checkpoints/epoch_2/state.pt",
                        "params.txt", "out.log", "metrics.jsonl"):
                if not os.path.exists(os.path.join(base, rel)):
                    raise RuntimeError(f"main wrote no {rel}")

            def records():
                with open(os.path.join(base, "metrics.jsonl")) as f:
                    return [json.loads(line) for line in f]

            recs = records()
            losses = [r["total_loss"] for r in recs]
            if [r["step"] for r in recs] != list(range(1, steps + 1)) or not all(
                    math.isfinite(x) for x in losses):
                raise RuntimeError(f"main logged {[(r['step'], r['total_loss']) for r in recs]}")
            if abs(losses[0] - math.log(TRAIN_BATCH)) > 0.5:
                raise RuntimeError(f"loss at step 1 is {losses[0]}, not near ln {TRAIN_BATCH}")
            layers = 24   # 12 blocks in each tower
            want = {"fused_attention_fwd": layers * steps, "fused_attention_bwd": layers * steps,
                    "fused_ce_fwd": 2 * steps, "fused_ce_bwd_da": 2 * steps,
                    "fused_ce_bwd_db": 2 * steps}
            log(f"[7 main] rc 0 in {secs:.1f} s; kernel launches over {steps} steps: {launches}")
            if launches != want:
                raise RuntimeError(f"launches {launches}, expected {want}")
            steady = recs[2:]
            step_ms = statistics.median(r["batch_time"] for r in steady) * 1e3
            data_ms = statistics.median(r["data_time"] for r in steady) * 1e3
            log(f"[7 main] {MAIN_MODEL} clip loss, --ce-impl fused, batch {TRAIN_BATCH}, bf16: "
                f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; step median {step_ms:.2f} ms = "
                f"{TRAIN_BATCH / step_ms * 1e3:.1f} samples/s over steps 3..{steps} (metrics "
                f"read every step); data_time median {data_ms:.2f} ms; peak device memory "
                f"{peak:.2f} GiB ({card})")

            resume = [*argv, "--resume", "latest", "--profile-dir", os.path.join(logs, "trace")]
            resume[resume.index("--epochs") + 1] = "3"
            rc = entry.main(resume)
            torch.cuda.synchronize()
            with open(os.path.join(base, "out.log")) as f:
                out_log = f.read()
            recs = records()
            if rc != 0 or not os.path.exists(os.path.join(base, "checkpoints/epoch_3/state.pt")):
                raise RuntimeError(f"--resume latest: rc {rc}, or no epoch_3")
            if ("epoch_2' (epoch 2)" not in out_log
                    or [r["step"] for r in recs] != list(range(1, steps + 7))):
                raise RuntimeError("--resume latest did not go on from epoch_2 at step 13")
            idle = re.findall(r"profiled steps: .*", out_log)
            if not idle:
                raise RuntimeError("the profiled steps logged no device time")
            log(f"[7 main] --epochs 3 --resume latest: went on from epoch_2 at step "
                f"{steps + 1}, wrote epoch_3; loss {recs[-1]['total_loss']:.5f}; {idle[-1]} "
                f"({card})")
        finally:
            setup_logging(None)   # drop the handler on the log file that is going away
    torch.cuda.empty_cache()
    feed_ms = time_host_feed(dev)
    log(f"[7 main] host feed for one batch of {TRAIN_BATCH}: the synthetic generator "
        f"{feed_ms[0]:.1f} ms (one thread), pinned staging + copy to the card "
        f"{feed_ms[1]:.1f} ms the first time, {feed_ms[2]:.1f} ms after ({card})")
    return {"launches": launches, "step_ms": step_ms, "data_ms": data_ms, "peak_gib": peak,
            "device_idle": idle[-1], "feed_ms": feed_ms}


def time_host_feed(dev):
    """Host ms to (generate one synthetic batch, ship it cold, ship it warm)
    at phase 7's size, each stage alone on an idle machine."""
    import torch

    from colxlip_tpu_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from colxlip_tpu_torch.training.train import _PrefetchIterator

    def ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    data = iter(SyntheticDataset(SyntheticConfig(
        batch_size=TRAIN_BATCH, num_sampled_captions=8, seed=0, num_samples=2 * TRAIN_BATCH)))
    batch, gen_ms = ms(lambda: next(data))
    feed = _PrefetchIterator([], device=dev)
    try:
        prepared = feed._prep(*batch)
        _, cold = ms(lambda: feed._ship(*prepared))
        _, warm = ms(lambda: feed._ship(*prepared))
    finally:
        feed.close()
    return gen_ms, cold, warm


def main() -> int:
    import torch

    # ---- phase 1: device -------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from colxlip_tpu_torch.ops import attention, build, fused_ce, maxsim
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
    ce_err, ce_inputs_by_m = check_ce_kernels(dev, gen)

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
        timing.update(time_ce_kernels(ce_inputs_by_m, card))
        qkv, h, causal = attn_inputs["vision"]
        sdpa_fwd, _ = time_library_attention(qkv, None, h, causal)
        sdpa_train = time_library_attention(*bwd_inputs["attention_bwd/vision"])
        log(f"[5 timing] F.scaled_dot_product_attention, vision shape: forward B=64 "
            f"{sdpa_fwd:.4f} ms; B={TRAIN_BATCH} forward {sdpa_train[0]:.4f} ms, backward "
            f"{sdpa_train[1]:.4f} ms ({card})")

        bounds = kernel_bounds(attn_inputs["vision"][0], bwd_inputs["attention_bwd/vision"][0],
                               attn_inputs["vision"][1], (t, img), (tt, ii),
                               ce_inputs_by_m[TRAIN_BATCH][:2])
        for name, (ms, by) in bounds.items():
            log(f"[5 timing] bound {name}: {ms:.5f} ms, by {by} (H100 SXM: 3.35 TB/s, "
                f"989 TFLOP/s bf16, 67 TFLOP/s fp32)")

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
    del svc, bwd_inputs, ce_inputs_by_m
    torch.cuda.empty_cache()

    # ---- phase 6: the train slice -----------------------------------------
    train = train_phase(dev, card)

    # ---- phase 7: the training entry point ----------------------------------
    trainer = main_phase(dev, card)

    tl, ml = train["launches"], trainer["launches"]
    ce_ms = {k: timing[f"fused_ce_{k}/{TRAIN_BATCH}"] for k in ("fwd", "bwd_da", "bwd_db")}
    rows = [
        ("fused_attention_fwd", "colxlip_tpu_torch/csrc/fused_attention.cu",
         "colxlip_tpu/ops/fused_attention.py:103", tl["fused_attention_fwd"], attn_err,
         timing["attention/vision"], bounds["fused_attention_fwd"], sdpa_fwd),
        ("fused_attention_bwd", "colxlip_tpu_torch/csrc/fused_attention_bwd.cu",
         "colxlip_tpu/ops/fused_attention.py:115", tl["fused_attention_bwd"],
         bwd_err["attention_bwd"], timing["attention_bwd/vision"],
         bounds["fused_attention_bwd"], sdpa_train[1]),
        ("maxsim_fwd", "colxlip_tpu_torch/csrc/maxsim.cu",
         "colxlip_tpu/ops/maxsim_pallas.py:86", tl["maxsim_fwd"], maxsim_err,
         timing["maxsim/nonzero"], bounds["maxsim_fwd"], None),
        ("maxsim_bwd", "colxlip_tpu_torch/csrc/maxsim_bwd.cu",
         "colxlip_tpu/ops/maxsim_pallas.py:244", tl["maxsim_bwd"], bwd_err["maxsim_bwd"],
         timing["maxsim_bwd/nonzero"], bounds["maxsim_bwd"], None),
        ("fused_ce_fwd", "colxlip_tpu_torch/csrc/fused_ce.cu",
         "colxlip_tpu/ops/fused_ce.py:45", ml["fused_ce_fwd"], ce_err["fused_ce_fwd"],
         ce_ms["fwd"], bounds["fused_ce_fwd"], None),
        ("fused_ce_bwd_da", "colxlip_tpu_torch/csrc/fused_ce.cu",
         "colxlip_tpu/ops/fused_ce.py:122", ml["fused_ce_bwd_da"], ce_err["fused_ce_bwd_da"],
         ce_ms["bwd_da"], bounds["fused_ce_bwd_da"], None),
        ("fused_ce_bwd_db", "colxlip_tpu_torch/csrc/fused_ce.cu",
         "colxlip_tpu/ops/fused_ce.py:152", ml["fused_ce_bwd_db"], ce_err["fused_ce_bwd_db"],
         ce_ms["bwd_db"], bounds["fused_ce_bwd_db"], None),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}
        for name, source, replaces, n_launches, err, (ms, plain_ms), bound, library_ms in rows],
        "launches_serving": launches, "launches_main": ml,
        "train_step": {"batch": TRAIN_BATCH, "ms": train["step_ms"],
                       "img_per_s": TRAIN_BATCH / train["step_ms"] * 1e3,
                       "peak_gib": train["peak_gib"]},
        "main": {"model": MAIN_MODEL, "batch": TRAIN_BATCH, "step_ms": trainer["step_ms"],
                 "samples_per_s": TRAIN_BATCH / trainer["step_ms"] * 1e3,
                 "data_ms": trainer["data_ms"], "peak_gib": trainer["peak_gib"],
                 "feed_ms": trainer["feed_ms"]}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
