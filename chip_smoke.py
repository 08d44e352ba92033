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
     bounded, and two runs of the backward must agree bit for bit. The
     LayerNorm and MLP kernels (forward and backward each) in fp32 and bf16
     at the training shapes (batch 256, vision and text), the token-head
     LayerNorm shape and one ragged shape each; two runs of each backward
     must agree bit for bit, and at the vision shape neither direction of
     the MLP may hold as much as one [B, N, H] tensor above its inputs.
  4. serving slice: ColXLIPService (ViT-B-16-colxlip, full width, random
     init from seed 0, bf16 compute) behind make_server on an ephemeral
     port, driven over HTTP; checks finite unit-norm embeddings, that both
     forward kernels were launched by the requests, and the /v1/score
     matrices against a plain-path recomputation on the same device.
  5. timings (CUDA events, after warm-up): each kernel against its plain
     version, and against the one PyTorch call that computes the same
     function where there is one (scaled_dot_product_attention, forward and
     backward; for the streaming CE the pair torch.matmul + F.cross_entropy
     over the dense logits is timed beside it; F.layer_norm forward and
     backward beside the LayerNorm kernels; the three calls F.linear,
     F.gelu, F.linear and their autograd backward beside the MLP kernels);
     encode throughput at batch 64, request latency. The library calls are
     timed only: on the paths timed here the port never calls them.
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
  8. the towers through the LayerNorm and MLP kernels: with
     COLXLIP_LN_IMPL=fused and COLXLIP_MLP_IMPL=fused set before the model
     is built, ViT-B-16-colxlip (full width and depth, seed 0, bf16):
     encode_image / encode_text at batch 64 against the same weights through
     the default path, a uint8 batch against the same batch normalised on
     the host, FUSED_STEPS colclip train steps at batch 256 on one fixed
     batch (finite falling losses, the launch counts of all eight kernels on
     the path exact), the batch-64 step through the kernels against the same
     step through the plain versions in fp32 and bf16, and the step's ms,
     img/s and peak device memory beside phase 6's: the peak must fall by
     the hidden tensors the default path keeps for autograd.
  Phases 4, 6 and 7 run the default path and must launch none of the
  LayerNorm and MLP kernels.

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
# encode_image / encode_text through the LayerNorm and MLP kernels vs the
# default path on the same weights, bf16: the compared elements are unit-norm
# 512-d features, typically 1/sqrt(512) = 0.044 and at most a few tenths, so
# the score's bar would be half a typical value. The two paths differ by bf16
# roundings through 12 layers, which read 5e-3 on the largest elements; a
# LayerNorm or MLP wrong by a tenth in one layer moves whole rows by more.
# Two bars: 1e-2 on any element, and 1e-3 on 1 - cosine of any unit-norm row
# (a row whose every element is off by 5e-3 / sqrt(512) rms has 2.5e-5).
ENCODE_TOL = 1e-2
ENCODE_COSINE_TOL = 1e-3
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
# LayerNorm and MLP kernels vs their plain versions:
#   forward, of max(1, largest |out|): fp32 1e-5 (the sums run in another
#     order, 3072 terms deep in the MLP, and rsqrtf / expf / tanhf stand
#     against torch's); bf16 2^-7 (the output is rounded to bf16 once: one
#     step of the largest value);
#   backward, of the largest |grad|: fp32 1e-4 (dscale, dbias, dW and db sum
#     50,432 rows in another order); bf16 2^-7 (dx is rounded to bf16 once,
#     and a dh or a that lands one bf16 step apart moves a weight gradient by
#     far less).
FUSED_FWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
FUSED_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
LN_CASES = [
    # name, leading shape, D
    ("vision", (256, 197), 768),
    ("text", (256, 77), 512),
    ("token-head", (256, 196), 512),
    ("ragged", (197 * 3,), 512),
]
MLP_CASES = [
    # name, B, N, D, H, the GELU branches checked
    ("vision", 256, 197, 768, 3072, (False,)),
    ("text", 256, 77, 512, 2048, (False,)),
    ("ragged", 3, 77, 512, 2048, (False, True)),
]
FUSED_STEPS = 4
# launches of one colclip train step of ViT-B-16-colxlip through the kernels:
# LayerNorm: vision ln_pre + 12 x (ln_1, ln_2) + ln_post + 2 in its token
# head = 28, text 12 x 2 + ln_final + 2 in its head = 27; one MLP and one
# attention call a block, 12 blocks a tower; one MaxSim. Forward and backward
# alike.
STEP_LAUNCHES = {"fused_ln": 55, "fused_mlp": 24, "fused_attention": 24, "maxsim": 1}
ENCODE_LN_LAUNCHES = {"image": 28, "text": 27}
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
    from colxlip_tpu_torch.ops import attention, fused_ln, fused_mlp, maxsim

    mods = (attention, maxsim, fused_ln, fused_mlp)
    saved = [(mod, name, getattr(mod, name)) for mod in mods
             for name in ("_launch_fwd", "_launch_bwd")]
    attention._launch_fwd = attention.fused_mha_plain
    attention._launch_bwd = attention.fused_mha_bwd_plain
    maxsim._launch_fwd = lambda t, i, mode, mask: maxsim.maxsim_plain(
        t, i, mask_mode=mode, text_mask=mask)
    maxsim._launch_bwd = lambda t, i, g, mode, mask: maxsim.maxsim_bwd_plain(
        t, i, g, mask_mode=mode, text_mask=mask)
    fused_ln._launch_fwd = fused_ln.layernorm_plain
    fused_ln._launch_bwd = fused_ln.layernorm_bwd_plain
    fused_mlp._launch_fwd = fused_mlp.fused_mlp_plain
    fused_mlp._launch_bwd = fused_mlp.fused_mlp_bwd_plain
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def fused_towers():
    """COLXLIP_LN_IMPL=fused and COLXLIP_MLP_IMPL=fused while models are built
    (the modules read them once, in their constructors)."""
    names = ("COLXLIP_LN_IMPL", "COLXLIP_MLP_IMPL")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update({k: "fused" for k in names})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fused_counters():
    """The launch counters of the LayerNorm and MLP kernels, by kernel name."""
    from colxlip_tpu_torch.ops import fused_ln, fused_mlp

    return {"fused_ln_fwd": fused_ln.FWD_LAUNCHES, "fused_ln_bwd": fused_ln.BWD_LAUNCHES,
            "fused_mlp_fwd": fused_mlp.FWD_LAUNCHES, "fused_mlp_bwd": fused_mlp.BWD_LAUNCHES}


def check_default_path(counters, phase: str) -> None:
    """The default path (neither variable set) launches none of them."""
    got = {name: c.value for name, c in counters.items()}
    if any(got.values()):
        raise RuntimeError(f"{phase}: the default path launched LayerNorm / MLP kernels: {got}")


def max_rel_err(got, want, floor: float = 1e-30) -> float:
    """max |got - want| over max(floor, largest |want|), both read as fp32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(floor)).item()


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    """(least ms the card could take, 'bytes' or 'operations'): each input
    read once and each output written once at the memory rate, against the
    operations at the peak rate for the input type."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_bounds(qkv_fwd, qkv_bwd, heads, maxsim_fwd, maxsim_bwd, ce, ln_x, mlp_x, mlp_w1):
    """bound_ms of every kernel at the shape its ``ms`` is timed at, from the
    tensors themselves: attention (packed QKV [B, N, 3 H D]; 4 B H N^2 D
    flops forward, 10 backward: five products), MaxSim (text [M, Lt, D],
    image [K, Li, D]; the similarities are 2 M K Lt Li D flops, the backward
    adds dT and dI at 2 M K Lt D each), CE (a [M, D], b [N, D]; 2 M N D
    forward, 4 M N D in dA and in dB), LayerNorm (x [R, D]: 2 R D elements
    forward and 3 R D backward, 8 and 16 operations an element, the counts
    the TPU kernels declare), MLP (x [B, N, D], w1 [H, D]: 4 B N D H flops
    forward, two products; 10 backward, the five products the function
    needs: h recomputed from x, dW2, da, dW1 and dx, where the TPU kernel's
    declared 12 counts one too many; over 2 B N D + 2 D H and
    3 B N D + 6 D H elements)."""
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
    r, d = ln_x.numel() // ln_x.shape[-1], ln_x.shape[-1]
    out["fused_ln_fwd"] = bound_ms(2 * r * d * ln_x.element_size(), 8 * r * d, name(ln_x))
    out["fused_ln_bwd"] = bound_ms(3 * r * d * ln_x.element_size(), 16 * r * d, name(ln_x))
    (h, d), r = mlp_w1.shape, mlp_x.numel() // mlp_x.shape[-1]
    size = mlp_x.element_size()
    out["fused_mlp_fwd"] = bound_ms((2 * r * d + 2 * d * h) * size, 4 * r * d * h, name(mlp_x))
    out["fused_mlp_bwd"] = bound_ms((3 * r * d + 6 * d * h) * size, 10 * r * d * h, name(mlp_x))
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


def mlp_inputs(b, n, d, h, dtype, dev, gen):
    """x, w1 [H, D], b1, w2 [H, D], b2, dy at the scales of a tower at init:
    unit-variance rows (a LayerNorm's output), lecun-normal weights."""
    import torch

    def t(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    return (t((b, n, d), 1.0), t((h, d), d ** -0.5), t((h,), 0.1), t((h, d), h ** -0.5),
            t((d,), 0.1), t((b, n, d), 1.0))


def check_fused_kernels(dev, gen):
    """Phase 3d: the LayerNorm and MLP kernels against their plain versions.
    Returns (max errors per kernel, bf16 inputs by case name for the timings)."""
    import torch

    from colxlip_tpu_torch.ops import fused_ln, fused_mlp

    errs = {"fused_ln_fwd": 0.0, "fused_ln_bwd": 0.0, "fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}
    inputs = {}

    def settle(kind, label, name, fwd_err, bwd_err, got, again):
        f_tol, b_tol = FUSED_FWD_TOL[name], FUSED_BWD_TOL[name]
        log(f"[3 kernels] {label} {name}: forward max_abs_err / max(1, max|out|) "
            f"{fwd_err:.3g} (tol {f_tol:.3g}); backward max_abs_err / max|grad| "
            f"{bwd_err:.3g} (tol {b_tol:.3g})")
        if not (fwd_err <= f_tol and bwd_err <= b_tol):
            raise RuntimeError(f"{label} {name}: forward {fwd_err} > {f_tol} or backward "
                               f"{bwd_err} > {b_tol}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"{label} {name}: two runs of the backward kernel differ "
                               "(it uses no atomics)")
        errs[f"{kind}_fwd"] = max(errs[f"{kind}_fwd"], fwd_err)
        errs[f"{kind}_bwd"] = max(errs[f"{kind}_bwd"], bwd_err)

    for case, lead, d in LN_CASES:
        x32 = torch.randn(*lead, d, generator=gen) * 2 + 0.5
        dy32 = torch.randn(*lead, d, generator=gen)
        scale = (1 + 0.1 * torch.randn(d, generator=gen)).to(dev)
        bias = (0.1 * torch.randn(d, generator=gen)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, dy = x32.to(dev, dtype), dy32.to(dev, dtype)
            y = fused_ln._launch_fwd(x, scale, bias, 1e-5)
            got = fused_ln._launch_bwd(x, scale, dy, 1e-5)
            again = fused_ln._launch_bwd(x, scale, dy, 1e-5)
            want_y = fused_ln.layernorm_plain(x, scale, bias, 1e-5)
            want = fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5)
            torch.cuda.synchronize()
            settle("fused_ln", f"layernorm {case} {tuple(x.shape)}", name,
                   max_rel_err(y, want_y, 1.0), max(max_rel_err(g, w) for g, w in zip(got, want)),
                   got, again)
            if dtype == torch.bfloat16:
                inputs[f"ln/{case}"] = (x, scale, bias, dy)
            del y, got, again, want_y, want

    for case, b, n, d, h, branches in MLP_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x, w1, b1, w2, b2, dy = mlp_inputs(b, n, d, h, dtype, dev, gen)
            for approximate in branches:
                out = fused_mlp._launch_fwd(x, w1, b1, w2, b2, approximate)
                got = fused_mlp._launch_bwd(x, w1, b1, w2, dy, approximate)
                again = fused_mlp._launch_bwd(x, w1, b1, w2, dy, approximate)
                want_out = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, approximate)
                want = fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, approximate)
                torch.cuda.synchronize()
                settle("fused_mlp", f"mlp {case} B={b} N={n} D={d} H={h} "
                       f"gelu={'tanh' if approximate else 'erf polynomial'}", name,
                       max_rel_err(out, want_out, 1.0),
                       max(max_rel_err(g, w) for g, w in zip(got, want)), got, again)
                del out, got, again, want_out, want
            if dtype == torch.bfloat16:
                inputs[f"mlp/{case}"] = (x, w1, b1, w2, b2, dy)

    # no [B, N, H] tensor on the kernel path, either direction, under autograd
    x, w1, b1, w2, b2, dy = inputs["mlp/vision"]
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    hidden = x.numel() // x.shape[-1] * w1.shape[0] * x.element_size() / 2**20
    peaks = []
    out = None
    for direction in ("forward", "backward"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        if direction == "forward":
            out = fused_mlp.fused_mlp(*leaves)
        else:
            out.backward(dy)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated(dev) - base) / 2**20)
    log(f"[3 kernels] mlp vision bf16 under autograd: peak device memory above what was held "
        f"before, forward {peaks[0]:.1f} MiB, backward {peaks[1]:.1f} MiB; one [B, N, H] "
        f"tensor would be {hidden:.1f} MiB; two backward runs bit-equal at every shape")
    if not (max(peaks) < hidden and all(torch.isfinite(t.grad).all() for t in leaves)):
        raise RuntimeError(f"fused MLP: peaks {peaks} MiB reach one hidden tensor ({hidden} "
                           "MiB), or a gradient is not finite")
    return errs, inputs


def time_fused_kernels(inputs, card: str):
    """Phase 5: the LayerNorm and MLP kernels, their plain versions, and the
    library beside them (F.layer_norm forward and backward; F.linear, F.gelu,
    F.linear and their autograd backward), bf16 at the training shapes."""
    import torch
    import torch.nn.functional as F

    from colxlip_tpu_torch.ops import fused_ln, fused_mlp

    timing = {}
    for case in ("vision", "text", "token-head"):
        x, scale, bias, dy = inputs[f"ln/{case}"]
        d = x.shape[-1]
        w, b = scale.to(x.dtype), bias.to(x.dtype)
        x_ = x.clone().requires_grad_()
        w_, b_ = w.clone().requires_grad_(), b.clone().requires_grad_()
        y_ = F.layer_norm(x_, (d,), w_, b_, 1e-5)
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-5), 20)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(y_, (x_, w_, b_), dy, retain_graph=True), 20)
        timing[f"fused_ln_fwd/{case}"] = (
            cuda_ms(lambda: fused_ln._launch_fwd(x, scale, bias, 1e-5), 20),
            cuda_ms(lambda: fused_ln.layernorm_plain(x, scale, bias, 1e-5), 20), lib_fwd)
        timing[f"fused_ln_bwd/{case}"] = (
            cuda_ms(lambda: fused_ln._launch_bwd(x, scale, dy, 1e-5), 20),
            cuda_ms(lambda: fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5), 20), lib_bwd)
        del x_, w_, b_, y_
    for case in ("vision", "text"):
        x, w1, b1, w2, b2, dy = inputs[f"mlp/{case}"]
        w2_out_in = w2.t().contiguous()          # [D, H], the layout F.linear takes
        leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2_out_in, b2)]

        def three_calls(x, w1, b1, w2, b2):
            return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)

        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: three_calls(x, w1, b1, w2_out_in, b2), 5, 2)
        lib_both = cuda_ms(lambda: torch.autograd.grad(three_calls(*leaves), leaves, dy), 5, 2)
        timing[f"fused_mlp_fwd/{case}"] = (
            cuda_ms(lambda: fused_mlp._launch_fwd(x, w1, b1, w2, b2, False), 3, 1),
            cuda_ms(lambda: fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, False), 3, 1), lib_fwd)
        timing[f"fused_mlp_bwd/{case}"] = (
            cuda_ms(lambda: fused_mlp._launch_bwd(x, w1, b1, w2, dy, False), 3, 1),
            cuda_ms(lambda: fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, False), 3, 1),
            lib_both - lib_fwd)
        del leaves
    for key, (ker, plain, lib) in timing.items():
        what = ("F.layer_norm" if key.startswith("fused_ln") else
                "F.linear, F.gelu, F.linear" + (" (autograd backward: forward + backward less "
                                                "forward)" if "bwd" in key else ""))
        log(f"[5 timing] {key} bf16 batch {TRAIN_BATCH}: kernel {ker:.4f} ms, plain "
            f"{plain:.4f} ms, {what} {lib:.4f} ms ({card})")
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


def compare_step(dev, dtype, ref_state, step_cfg, images, texts, tag: str = "[6 train]") -> None:
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
    log(f"{tag} batch {images.shape[0]} step in {dtype}, kernels vs plain versions: "
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
    unused = fused_counters()
    for c in (*counters.values(), *unused.values()):
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
    check_default_path(unused, "phase 6")
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


def fused_phase(dev, card: str, train):
    """Phase 8: both towers through the LayerNorm and MLP kernels, serving
    and training, at full ViT-B-16-colxlip width and depth."""
    import numpy as np
    import torch

    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.ops import attention, maxsim
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training.optim import create_optimizer
    from colxlip_tpu_torch.training.schedules import const_lr

    default_model, cfg = create_model(MODEL, dev, torch.bfloat16, seed=0)
    with fused_towers():
        model, _ = create_model(MODEL, dev, torch.bfloat16, seed=0)
    ref_state = copy.deepcopy(model.state_dict())
    size, ctx = cfg.vision_cfg.image_size, cfg.text_cfg.context_length
    images, texts = synthetic_batch(TRAIN_BATCH, size, ctx, seed=0)
    images = torch.from_numpy(images).to(dev)
    texts = torch.from_numpy(texts).to(dev)
    new = fused_counters()
    counters = {**new, "fused_attention_fwd": attention.LAUNCHES,
                "fused_attention_bwd": attention.BWD_LAUNCHES, "maxsim_fwd": maxsim.LAUNCHES,
                "maxsim_bwd": maxsim.BWD_LAUNCHES}

    def reset():
        for c in counters.values():
            c.reset()

    # (a) serving: the same weights through the kernels and the default path
    with torch.inference_mode():
        for kind, batch in (("image", images[:MAX_BATCH]), ("text", texts[:MAX_BATCH])):
            encode = "encode_image" if kind == "image" else "encode_text"
            reset()
            got = getattr(model, encode)(batch, normalize=True)
            torch.cuda.synchronize()
            launches = {name: c.value for name, c in new.items()}
            want_launches = {"fused_ln_fwd": ENCODE_LN_LAUNCHES[kind], "fused_ln_bwd": 0,
                             "fused_mlp_fwd": 12, "fused_mlp_bwd": 0}
            want = getattr(default_model, encode)(batch, normalize=True)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            # text tokens at and after EOT are zero rows on both paths: they
            # have no direction and are held by the element bar alone
            off = max(((1.0 - torch.nn.functional.cosine_similarity(
                g.float(), w.float(), dim=-1)) * (w.float().norm(dim=-1) > 0.5)).max().item()
                for g, w in zip(got, want))
            log(f"[8 fused] {encode} batch {MAX_BATCH} through the kernels vs the default "
                f"path, unit-norm pooled and token features: max_abs_err {err:.3g} (tol "
                f"{ENCODE_TOL}), largest 1 - cosine of a row {off:.3g} (tol "
                f"{ENCODE_COSINE_TOL}); launches {launches}")
            if launches != want_launches:
                raise RuntimeError(f"{encode}: launches {launches}, expected {want_launches}")
            if not (err <= ENCODE_TOL and off <= ENCODE_COSINE_TOL
                    and all(torch.isfinite(g).all() for g in got)):
                raise RuntimeError(f"{encode} through the kernels: max_abs_err {err} (tol "
                                   f"{ENCODE_TOL}), 1 - cosine {off} (tol {ENCODE_COSINE_TOL})")
        # the uint8 feed: normalised on the device against normalised on the host
        rng = np.random.default_rng(1)
        raw = rng.integers(0, 256, (MAX_BATCH, size, size, 3), dtype=np.uint8)
        mean = np.asarray(cfg.vision_cfg.image_mean, np.float32)
        std = np.asarray(cfg.vision_cfg.image_std, np.float32)
        host = (raw.astype(np.float32) / np.float32(255.0) - mean) / std
        got = model.encode_image(torch.from_numpy(raw).to(dev), normalize=True)
        want = model.encode_image(torch.from_numpy(host).to(dev), normalize=True)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        log(f"[8 fused] encode_image on a uint8 batch of {MAX_BATCH} (normalised on the "
            f"device in fp32) vs the same batch normalised on the host: "
            f"{'equal bit for bit' if same else 'NOT equal'}")
        if not same:
            raise RuntimeError("the uint8 feed disagrees with the host-normalised batch")
    del default_model
    torch.cuda.empty_cache()

    # (b) training: FUSED_STEPS colclip steps at batch 256 on one fixed batch
    model.train()
    step_cfg = TrainStepConfig(loss_type="colclip", alpha=0.5, mask_mode="nonzero")
    schedule = const_lr(1e-4, 0)
    step = make_train_step(model, create_optimizer(model, schedule), schedule, step_cfg)
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    for i in range(FUSED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step(images, texts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        vals = {k: float(v) for k, v in metrics.items()}
        losses.append(vals["total_loss"])
        log(f"[8 fused] step {i}: " + " ".join(f"{k} {v:.5f}" for k, v in vals.items())
            + f" | {secs[-1] * 1e3:.1f} ms")
        if not all(math.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"step {i}: non-finite metrics {vals}")
    launches = {name: c.value for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    want_launches = {name: FUSED_STEPS * STEP_LAUNCHES[name.rsplit("_", 1)[0]]
                     for name in counters}
    log(f"[8 fused] kernel launches over {FUSED_STEPS} steps: {launches}")
    if launches != want_launches:
        raise RuntimeError(f"launches {launches}, expected {want_launches}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall over {FUSED_STEPS} steps: {losses}")
    step_ms = statistics.median(secs[1:]) * 1e3
    # autograd on the default path keeps two [B, N, H] tensors an MLP (the
    # pre-activation for GELU's backward, the activation for c_proj's); the
    # kernels keep none, so the peak must fall by (at least 90% of) their bytes
    vis, txt = cfg.vision_cfg, cfg.text_cfg
    hidden_elements = TRAIN_BATCH * (
        vis.layers * (vis.num_patches + 1) * int(vis.width * vis.mlp_ratio)
        + txt.layers * ctx * int(txt.width * txt.mlp_ratio))
    hidden_gib = 2 * 2 * hidden_elements / 2**30        # two tensors an MLP, bf16
    limit = train["peak_gib"] - 0.9 * hidden_gib
    log(f"[8 fused] loss {losses[0]:.5f} -> {losses[-1]:.5f}; step at batch {TRAIN_BATCH}: "
        f"median {step_ms:.2f} ms over steps 1..{FUSED_STEPS - 1} = "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} img/s (default path, phase 6: "
        f"{train['step_ms']:.2f} ms); peak device memory {peak:.2f} GiB against "
        f"{train['peak_gib']:.2f} GiB in phase 6, whose 48 hidden tensors are {hidden_gib:.2f} "
        f"GiB (limit {limit:.2f} GiB) ({card})")
    if not peak <= limit:
        raise RuntimeError(f"peak {peak} GiB with the fused MLP is above {limit} GiB: a "
                           "[B, N, H] tensor was held")
    del step, model
    torch.cuda.empty_cache()

    # (c) the batch-64 step through the kernels and through the plain versions
    with fused_towers():
        for dtype in (torch.float32, torch.bfloat16):
            compare_step(dev, dtype, ref_state, step_cfg, images[:COMPARE_BATCH],
                         texts[:COMPARE_BATCH], tag="[8 fused]")
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak, "losses": losses}


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
        unused = fused_counters()
        for c in (*counters.values(), *unused.values()):
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
            check_default_path(unused, "phase 7")
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
    fused_err_by_kernel, fused_inputs = check_fused_kernels(dev, gen)

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
        unused = fused_counters()
        for counter in (attention.LAUNCHES, attention.BWD_LAUNCHES, maxsim.LAUNCHES,
                        maxsim.BWD_LAUNCHES, *unused.values()):
            counter.reset()
        results = [http(port, path, body) for path, body in requests]
        torch.cuda.synchronize()
        check_default_path(unused, "phase 4")
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
        timing.update(time_fused_kernels(fused_inputs, card))
        qkv, h, causal = attn_inputs["vision"]
        sdpa_fwd, _ = time_library_attention(qkv, None, h, causal)
        sdpa_train = time_library_attention(*bwd_inputs["attention_bwd/vision"])
        log(f"[5 timing] F.scaled_dot_product_attention, vision shape: forward B=64 "
            f"{sdpa_fwd:.4f} ms; B={TRAIN_BATCH} forward {sdpa_train[0]:.4f} ms, backward "
            f"{sdpa_train[1]:.4f} ms ({card})")

        bounds = kernel_bounds(attn_inputs["vision"][0], bwd_inputs["attention_bwd/vision"][0],
                               attn_inputs["vision"][1], (t, img), (tt, ii),
                               ce_inputs_by_m[TRAIN_BATCH][:2], fused_inputs["ln/vision"][0],
                               *fused_inputs["mlp/vision"][:2])
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
    del svc, bwd_inputs, ce_inputs_by_m, fused_inputs
    torch.cuda.empty_cache()

    # ---- phase 6: the train slice -----------------------------------------
    train = train_phase(dev, card)

    # ---- phase 7: the training entry point ----------------------------------
    trainer = main_phase(dev, card)

    # ---- phase 8: the towers through the LayerNorm and MLP kernels ----------
    fused = fused_phase(dev, card, train)

    tl, ml, fl = train["launches"], trainer["launches"], fused["launches"]
    ce_ms = {k: timing[f"fused_ce_{k}/{TRAIN_BATCH}"] for k in ("fwd", "bwd_da", "bwd_db")}
    attn_fwd = (tl["fused_attention_fwd"], attn_err, timing["attention/vision"],
                bounds["fused_attention_fwd"], sdpa_fwd)
    attn_bwd = (tl["fused_attention_bwd"], bwd_err["attention_bwd"],
                timing["attention_bwd/vision"], bounds["fused_attention_bwd"], sdpa_train[1])
    rows = [
        ("fused_attention_fwd", "colxlip_tpu_torch/csrc/fused_attention.cu",
         "colxlip_tpu/ops/fused_attention.py:103", *attn_fwd),
        ("fused_attention_bwd", "colxlip_tpu_torch/csrc/fused_attention_bwd.cu",
         "colxlip_tpu/ops/fused_attention.py:115", *attn_bwd),
        # the TPU's head-pair grid variants are the same functions: the CUDA
        # kernels grid over heads already and serve them too
        ("fused_attention_fwd_heads", "colxlip_tpu_torch/csrc/fused_attention.cu",
         "colxlip_tpu/ops/fused_attention.py:193", *attn_fwd),
        ("fused_attention_bwd_heads", "colxlip_tpu_torch/csrc/fused_attention_bwd.cu",
         "colxlip_tpu/ops/fused_attention.py:222", *attn_bwd),
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
    # the LayerNorm kernels stand beside F.layer_norm; the MLP has no one call
    # (its three-call path is under "mlp_three_calls_ms")
    for name, source, replaces, has_library in (
            ("fused_ln_fwd", "fused_ln.cu", "fused_ln.py:58", True),
            ("fused_ln_bwd", "fused_ln.cu", "fused_ln.py:68", True),
            ("fused_mlp_fwd", "fused_mlp.cu", "fused_mlp.py:182", False),
            ("fused_mlp_bwd", "fused_mlp.cu", "fused_mlp.py:198", False)):
        ker, plain, lib = timing[f"{name}/vision"]
        rows.append((name, f"colxlip_tpu_torch/csrc/{source}", f"colxlip_tpu/ops/{replaces}",
                     fl[name], fused_err_by_kernel[name], (ker, plain), bounds[name],
                     lib if has_library else None))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}
        for name, source, replaces, n_launches, err, (ms, plain_ms), bound, library_ms in rows],
        "launches_serving": launches, "launches_main": ml, "launches_fused": fl,
        "mlp_three_calls_ms": {"fwd": timing["fused_mlp_fwd/vision"][2],
                               "bwd": timing["fused_mlp_bwd/vision"][2]},
        "fused_train_step": {"batch": TRAIN_BATCH, "steps": FUSED_STEPS, "ms": fused["step_ms"],
                             "img_per_s": TRAIN_BATCH / fused["step_ms"] * 1e3,
                             "peak_gib": fused["peak_gib"]},
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
