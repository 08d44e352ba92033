#!/usr/bin/env python3
"""Time the port's attention kernels on one NVIDIA GPU, beside
F.scaled_dot_product_attention on the same packed QKV.

    python3 scripts/torch_attention_bench.py [--plain] [--iters 20]
        [--dtype float32 --shapes vit-l-b16,vit-l-text-b16,vit-l-336-b16,long-causal]

For each shape (the two towers of ViT-B-16 at batch 64 and 256, ViT-L/14's
vision tower at batch 64, a long causal sequence; or those named by
``--shapes``, among them ViT-L-14's two towers at chip_smoke.py phase 8b's
batch 16 and its vision tower at 336 px, 577 tokens) it first holds the
forward and the backward kernel against their plain versions at batch 2
(the tolerances of chip_smoke.py for the dtype), then times kernel and
library call with CUDA events after a warm-up, in turns (kernel, library,
library, kernel), beside each kernel's bound (chip_smoke.py
``attention_bounds``), and prints one line a shape plus the card's name and
power limit, and each kernel's device time a call (torch.profiler,
chip_smoke.py ``device_ms_by_kernel``: the backward's two passes apart).
Each line also carries a SHA-256 of the full-size forward
output and backward gradient, and whether a second run of each gave the
same bits. ``--dtype float32`` runs the CUDA-core kernels and the library
call in fp32 (TF32 off), as the fp32 ViT-L step does; they take any N, as
bf16 does. ``--plain`` also times the plain versions (slow: they hold
[B, H, N, N] in fp32). The library call is a yardstick only: the port never
calls it.

Two builds are compared in one call by running this script from a copy of
the other tree (``git archive`` into a git-ignored directory, this script
copied in: each run rebuilds, the library is keyed on the sources) and from
this tree in turns, parent, change, change, parent; the digests of the two
trees' outputs then say whether they agree bit for bit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from colxlip_tpu_torch.ops import attention  # noqa: E402

SHAPES = [
    # name, B, N, H, D, causal
    ("vision-b64", 64, 197, 12, 64, False),
    ("vision-b256", 256, 197, 12, 64, False),
    ("text-b256", 256, 77, 8, 64, True),
    ("vit-l-b64", 64, 257, 16, 64, False),
    ("long-causal", 8, 1024, 12, 64, True),
    # chip_smoke.py phase 8b's ViT-L-14-colxlip step at batch 16 (run by --shapes)
    ("vit-l-b16", 16, 257, 16, 64, False),
    ("vit-l-text-b16", 16, 77, 12, 64, True),
    # ViT-L/14 at 336 px: 577 tokens, one live key in the tenth tile
    ("vit-l-336-b16", 16, 577, 16, 64, False),
]
DEFAULT_SHAPES = "vision-b64,vision-b256,text-b256,vit-l-b64,long-causal"


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--shapes", default=DEFAULT_SHAPES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dtype = getattr(torch, args.dtype)
    fwd_tol, bwd_tol = chip_smoke.ATTN_TOL[args.dtype], chip_smoke.BWD_TOL[args.dtype]
    gen = torch.Generator().manual_seed(0)
    for name, b, n, h, d, causal in SHAPES:
        if name not in args.shapes.split(","):
            continue
        qkv = torch.randn(b, n, 3 * h * d, generator=gen).to(dev, dtype)
        dout = torch.randn(b, n, h * d, generator=gen).to(dev, dtype)
        with torch.no_grad():
            small, gsmall = qkv[:2].contiguous(), dout[:2].contiguous()
            err_f = (attention.fused_mha_packed(small, h, causal).float()
                     - attention.fused_mha_plain(small, h, causal).float()).abs().max().item()
            want = attention.fused_mha_bwd_plain(small, gsmall, h, causal).float()
            err_b = ((attention._launch_bwd(small, gsmall, h, causal).float() - want).abs().max()
                     / want.abs().max()).item()
        if not (err_f <= fwd_tol and err_b <= bwd_tol):
            raise RuntimeError(f"{name}: forward error {err_f}, backward error {err_b}")
        q, k, v = (t.contiguous().requires_grad_()
                   for t in qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
        grad = dout.view(b, n, h, d).permute(0, 2, 1, 3).contiguous()
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        def fwd():
            with torch.no_grad():
                attention.fused_mha_packed(qkv, h, causal)

        def lib_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        def bwd():
            attention._launch_bwd(qkv, dout, h, causal)

        def lib_bwd():
            torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)

        with torch.no_grad():
            outs = [attention.fused_mha_packed(qkv, h, causal) for _ in range(2)]
        grads = [attention._launch_bwd(qkv, dout, h, causal) for _ in range(2)]
        digests = {"fwd_sha256": sha256(outs[0]), "bwd_sha256": sha256(grads[0]),
                   "fwd_rerun_equal": torch.equal(*outs), "bwd_rerun_equal": torch.equal(*grads)}
        del outs, grads
        bounds = chip_smoke.attention_bounds(qkv, qkv, causal)
        row = {"shape": name, "B": b, "N": n, "H": h, "D": d, "causal": causal,
               "dtype": args.dtype, "fwd_err": err_f, "bwd_err": err_b,
               "fwd_bound_ms": bounds["fused_attention_fwd"][0],
               "bwd_bound_ms": bounds["fused_attention_bwd"][0],
               "bound_by": bounds["fused_attention_fwd"][1], **digests}
        for key, ker, lib in (("fwd", fwd, lib_fwd), ("bwd", bwd, lib_bwd)):
            t = [cuda_ms(f, args.iters) for f in (ker, lib, lib, ker)]
            row[f"{key}_ms"], row[f"{key}_sdpa_ms"] = min(t[0], t[3]), min(t[1], t[2])
        row["device_ms"] = {
            **chip_smoke.device_ms_by_kernel(fwd, 5, r"(attn_fwd_\w+_kernel)"),
            **chip_smoke.device_ms_by_kernel(bwd, 5, r"(attn_bwd_\w+_kernel)")}
        if args.plain:
            with torch.no_grad():
                row["fwd_plain_ms"] = cuda_ms(
                    lambda: attention.fused_mha_plain(qkv, h, causal), 5)
                row["bwd_plain_ms"] = cuda_ms(
                    lambda: attention.fused_mha_bwd_plain(qkv, dout, h, causal), 5)
        print(json.dumps(row), flush=True)
        del qkv, dout, q, k, v, grad, out
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
