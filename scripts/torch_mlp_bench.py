#!/usr/bin/env python3
"""Check and time the port's fused MLP kernels on one NVIDIA GPU.

    python3 scripts/torch_mlp_bench.py [--iters 20] [--cases vision,text,vit-l]
                                       [--dtype float32]

For each case (the vision tower's MLP at the flagship batch 256, 50,432 x 768
x 3072; the text tower's, 19,712 x 512 x 2048; ViT-L/14's at batch 16, 4,112
x 1024 x 4096; a ragged 231 x 512 x 2048 in both GELU branches) it holds the
bf16 forward to its per-element bar (ops/fused_mlp_check.py: the exact
function within what the kernel's fp32 sums and GELU allow) and the backward
to its plain version (2^-7 of the largest |grad|); beside them, printed
only, the forward's max_abs_err / max(1, max |out|) against the plain
version and the share of out and dx elements whose bits differ from the
plain version's. It checks that two backward runs give the same bits, and
times with CUDA events in turns (kernel, plain, library, library, plain,
kernel): the kernels, their plain versions, and the library path of three
calls (F.linear, F.gelu, F.linear; the backward as their autograd backward,
forward + backward less forward). Beside them: the bound (the larger of the
bytes over 3.35 TB/s and the operations over 989 TFLOP/s, as chip_smoke.py
computes it), and the device time of each product (torch.profiler: the GEMM
tile kernel by layout and epilogue, the column sums and the reduce). Inputs are at a
tower's scales at init (unit rows, lecun-normal weights). Prints the
registers and spills of ``fused_mlp.cu``'s kernels (``nvcc -Xptxas -v``),
one line a case with a SHA-256 of each output (two trees on the same card
and seed can be compared line by line), the card's name and power limit,
and one JSON object. With ``--dtype float32`` the same runs in fp32 on the
CUDA cores (any D: ``--cases vit-l,vision`` are the fp32 ViT-L-14 step's
MLP and the vision tower's; both directions' products are the fp32 GEMM
tile ``mlp_sgemm_kernel`` by layout and epilogue; bars 1e-5 forward of
max(1, max |out|), 1e-4 backward; the bound at 67 TFLOP/s).
``--fp32-plans 1024x4,2048x0`` also times the fp32 forward under each
(chunk rows x K slices of a W2; 0 slices: the wrapper's rule) in place of
the wrapper's plan, each held to the same bar with reruns bit-equal: the
measurement the wrapper's rule (``ops.fused_mlp.fp32_fwd_chunk_rows``,
``fp32_k_splits``) was chosen by.

    python3 scripts/torch_mlp_bench.py --cases none --draws 32

holds the bf16 forward to its per-element bar at the vision shape on the
draws of seeds 1 .. 32 (``inputs(..., seed)``, the erf-polynomial GELU): one
line a draw with the bar's report, and the seeds outside it (the exit code
is 1 if any is).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from colxlip_tpu_torch.ops import build, fused_mlp, fused_mlp_check  # noqa: E402

CASES = [
    # name, B, N, D, H, GELU branches
    ("vision", 256, 197, 768, 3072, (False,)),
    ("text", 256, 77, 512, 2048, (False,)),
    ("vit-l", 16, 257, 1024, 4096, (False,)),
    ("ragged", 3, 77, 512, 2048, (False, True)),
]
BWD_TOL = 2.0 ** -7
FP32_TOL = (1e-5, 1e-4)        # chip_smoke.py FUSED_FWD_TOL / FUSED_BWD_TOL in fp32
PEAK_BYTES_PER_S, PEAK_FLOPS, PEAK_FP32_FLOPS = 3.35e12, 989e12, 67e12
# mlp_gemm_kernel<layout, BN, epilogue>: what each epilogue's product is
PRODUCTS = {0: "x W1^T + gelu", 1: "x W1^T (h)", 2: "dy W2^T (dh)", 3: "a W2 + b2",
            4: "dh W1 (dx)", 5: "a^T dy + dh^T x (dW)"}


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
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


def product_ms(fn, calls: int = 3) -> dict:
    """Device ms a call of each product (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        found = re.search(r"mlp_gemm_kernel<(\d+), (\d+), (\d+)>", e.key)
        fp32 = re.search(r"mlp_sgemm_kernel<(\d+), (\w+), (\d+)>", e.key)
        name = (f"{PRODUCTS[int(found.group(3))]} [{found.group(2)} cols]" if found
                else f"{PRODUCTS[int(fp32.group(3))]} [fp32 tile]" if fp32
                else "colsum" if "colsum" in e.key else "reduce" if "reduce" in e.key
                else e.key[:40])
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def inputs(b, n, d, h, dev, seed=0, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)

    def t(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    return (t((b, n, d), 1.0), t((h, d), d ** -0.5), t((h,), 0.1), t((h, d), h ** -0.5),
            t((d,), 0.1), t((b, n, d), 1.0))


def bound_ms(r, d, h, backward: bool, fp32: bool = False) -> float:
    elements = 3 * r * d + 6 * d * h if backward else 2 * r * d + 2 * d * h
    flops = (10 if backward else 4) * r * d * h
    return max(elements * (4 if fp32 else 2) / PEAK_BYTES_PER_S,
               flops / (PEAK_FP32_FLOPS if fp32 else PEAK_FLOPS)) * 1e3


def rel_err(got, want, floor=1e-30):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(floor)).item()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    ap.add_argument("--draws", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--fp32-plans", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mlp_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kernels = build.load_kernels()
    usage = build.resource_usage(["fused_mlp"])
    print(f"build {kernels.build_seconds:.1f} s; fused_mlp.cu registers / stack / spill stores / "
          "spill loads: " + "; ".join(f"{k} {v}" for k, v in sorted(usage.items())), flush=True)
    dtype, fp32 = getattr(torch, args.dtype), args.dtype == "float32"
    bwd_tol = FP32_TOL[1] if fp32 else BWD_TOL
    wanted = args.cases.split(",")
    results, ok = {"registers": usage}, True
    for name, b, n, d, h, branches in CASES:
        if name not in wanted:
            continue
        x, w1, b1, w2, b2, dy = inputs(b, n, d, h, dev, dtype=dtype)
        errs, same, fwd_ok, bar, digests = [], True, True, {}, {}
        for approximate in branches:
            out = fused_mlp._launch_fwd(x, w1, b1, w2, b2, approximate)
            got = fused_mlp._launch_bwd(x, w1, b1, w2, dy, approximate)
            again = fused_mlp._launch_bwd(x, w1, b1, w2, dy, approximate)
            want_out = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, approximate)
            want = fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, approximate)
            if fp32:
                fwd_ok &= rel_err(out, want_out, 1.0) <= FP32_TOL[0]
            else:
                bar = fused_mlp_check.check_forward(
                    out, fused_mlp_check.forward_bar(x, w1, b1, w2, b2, approximate))
                fwd_ok &= bar["ok"]
                print(f"{name} gelu={'tanh' if approximate else 'erf'} bf16 forward: "
                      + fused_mlp_check.describe(bar), flush=True)
            errs.append((rel_err(out, want_out, 1.0),
                         max(rel_err(g, w) for g, w in zip(got, want)),
                         (out != want_out).float().mean().item(),
                         (got[0] != want[0]).float().mean().item()))
            same &= all(torch.equal(p, q) for p, q in zip(got, again))
            digests["tanh" if approximate else "erf"] = {"out": digest(out), "grads": digest(*got)}
            del out, got, again, want_out, want
        fwd_err, bwd_err, out_off, dx_off = (max(e[i] for e in errs) for i in range(4))

        w2_out_in = w2.t().contiguous()
        leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2_out_in, b2)]

        def three_calls(x, w1, b1, w2, b2):
            return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)

        def lib_fwd():
            with torch.no_grad():
                three_calls(x, w1, b1, w2_out_in, b2)

        fns = {
            "fwd": (lambda: fused_mlp._launch_fwd(x, w1, b1, w2, b2, False),
                    lambda: fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, False), lib_fwd),
            "bwd": (lambda: fused_mlp._launch_bwd(x, w1, b1, w2, dy, False),
                    lambda: fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, False),
                    lambda: torch.autograd.grad(three_calls(*leaves), leaves, dy)),
        }
        ms = {}
        for key, (ker, plain, lib) in fns.items():
            order = [("kernel", ker, args.iters), ("plain", plain, 3), ("library", lib, args.iters)]
            reads = {}
            for label, fn, iters in order + order[::-1]:
                reads.setdefault(label, []).append(cuda_ms(fn, iters))
            ms[key] = {label: min(v) for label, v in reads.items()}
            ms[key]["reads"] = reads
        lib_fwd_ms = ms["fwd"]["library"]
        ms["bwd"]["library"] -= lib_fwd_ms          # forward + backward less forward
        rows = b * n
        for key in ("fwd", "bwd"):
            ms[key]["bound"] = bound_ms(rows, d, h, key == "bwd", fp32)
        products = {"fwd": product_ms(fns["fwd"][0]), "bwd": product_ms(fns["bwd"][0])}
        plans = time_fp32_plans(args.fp32_plans, (x, w1, b1, w2, b2), args.iters) if fp32 else {}
        fwd_ok &= all(v["ok"] for v in plans.values())
        good = fwd_ok and bwd_err <= bwd_tol and same
        ok &= good
        results[name] = {"rows": rows, "d": d, "h": h,
                         "chunk_rows": {"fwd": fused_mlp.chunk_rows(h, False),
                                        "bwd": fused_mlp.chunk_rows(h)},
                         "workspace_bytes": {k: fused_mlp.workspace_bytes(rows, d, h, k == "bwd",
                                                                          dtype)
                                             for k in ("fwd", "bwd")},
                         "digest": digests, "fwd_bar_ok": fwd_ok, "fwd_bar": bar,
                         "fwd_err": fwd_err,
                         "bwd_err": bwd_err, "bit_equal": same,
                         "out_not_equal_to_plain": out_off, "dx_not_equal_to_plain": dx_off,
                         "ms": ms, "products_ms": products, "fp32_plans": plans}
        print(f"{name} {rows} x {d} x {h} {args.dtype}: forward {'held' if fwd_ok else 'FAILED'} "
              f"(max_abs_err / max(1, max|out|) against plain {fwd_err:.3g}), "
              f"backward {bwd_err:.3g} "
              f"of max|grad|, reruns {'bit-equal' if same else 'DIFFER'}, out / dx elements "
              f"not bit-equal to plain {out_off:.3g} / {dx_off:.3g}; "
              + "; ".join(f"{k} kernel {v['kernel']:.4f} ms (plain {v['plain']:.4f}, three calls "
                          f"{v['library']:.4f}, bound {v['bound']:.5f}, "
                          f"{v['bound'] / v['kernel']:.1%} of it)" for k, v in ms.items())
              + "; products " + ", ".join(f"{k} {v:.4f}" for k, v in
                                         {**products["fwd"], **products["bwd"]}.items())
              + "; sha256 " + ", ".join(f"{g}: out {v['out']} grads {v['grads']}"
                                        for g, v in digests.items())
              + ("" if good else "  FAILED"), flush=True)
        del x, w1, b1, w2, b2, dy, leaves, w2_out_in
        torch.cuda.empty_cache()
    if args.draws:
        results["draws"] = survey_draws(args.draws, dev)
        ok &= all(r["ok"] for r in results["draws"].values())
    print(card)
    print(json.dumps({"card": card, "ok": ok, "cases": results}))
    return 0 if ok else 1


def time_fp32_plans(spec: str, args, iters: int) -> dict:
    """The fp32 forward under each plan of ``spec`` ("chunk x slices", comma
    separated) and under the wrapper's own: ms (the faster of two reads),
    max_abs_err / max(1, max |out|) against the plain version, reruns
    bit-equal."""
    plans = {}
    if hasattr(fused_mlp, "fp32_fwd_plan"):
        rows, d, h = args[0].numel() // args[0].shape[-1], args[0].shape[-1], args[1].shape[0]
        chunks, cap = fused_mlp.fp32_fwd_plan(rows, h)
        sms = torch.cuda.get_device_properties(args[0].device).multi_processor_count
        print(f"fp32 forward plan of the wrapper: {chunks} chunks of at most {cap} rows, a W2 in "
              f"{fused_mlp.fp32_k_splits(cap, d, h, sms)} K slices", flush=True)
    want = fused_mlp.fused_mlp_plain(*args, False)
    for item in (s for s in spec.split(",") if s):
        chunk, splits = (int(v) for v in item.split("x"))

        def run():
            return fused_mlp._launch_fwd(*args, False, fp32_plan=(chunk, splits))

        got, again = run(), run()
        err = rel_err(got, want, 1.0)
        plans[item] = {"ms": min(cuda_ms(run, iters), cuda_ms(run, iters)), "err": err,
                       "bit_equal": torch.equal(got, again),
                       "ok": err <= FP32_TOL[0] and torch.equal(got, again)}
        print(f"  fp32 forward plan {item}: {plans[item]['ms']:.4f} ms, error {err:.3g}, reruns "
              f"{'bit-equal' if plans[item]['bit_equal'] else 'DIFFER'}", flush=True)
        del got, again
    return plans


def survey_draws(count: int, dev) -> dict:
    """The bf16 forward against its per-element bar at the vision shape on
    the draws of seeds 1 .. count: {seed: check_forward's report}."""
    _, b, n, d, h, _ = CASES[0]
    out = {}
    for seed in range(1, count + 1):
        x, w1, b1, w2, b2, _ = inputs(b, n, d, h, dev, seed)
        got = fused_mlp._launch_fwd(x, w1, b1, w2, b2, False)
        out[seed] = fused_mlp_check.check_forward(
            got, fused_mlp_check.forward_bar(x, w1, b1, w2, b2, False))
        print(f"draw {seed} vision bf16 forward: {fused_mlp_check.describe(out[seed])}",
              flush=True)
        del x, w1, b1, w2, b2, got
    print("draws outside the bar: " + (", ".join(str(k) for k, v in out.items() if not v["ok"])
                                       or "none"), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
