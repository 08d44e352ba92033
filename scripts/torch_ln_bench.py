#!/usr/bin/env python3
"""Check and time the port's LayerNorm backward kernels on one NVIDIA GPU.

    python3 scripts/torch_ln_bench.py [--iters 50]

Runs kernel #8 of ``csrc/fused_ln.cu`` (the row kernel and the partial-row
reduce behind one call) alone at the fused towers' shapes: vision 256 x 197
x 768, text 256 x 77 x 512, the token heads 256 x 196 x 512, ViT-L-14's
16 x 257 x 1024, and two ragged ones (591 x 512; 15 x 40). At each it holds
the call against ``layernorm_bwd_plain`` under ``chip_smoke.py``'s
``FUSED_BWD_TOL`` (2^-7 of the largest |grad| in bf16, 1e-4 in fp32) and
checks that two runs give the same bits. In bf16 at the first four shapes,
and in fp32 at the vision shape, it then times, with CUDA events in turns (each in order, then each in
reverse order), the call, its plain version, ``F.layer_norm``'s autograd
backward and ``torch.add(x, dy)`` (the same bytes moved with no arithmetic:
what the card's memory gives this access pattern), beside the bound (3 R D
elements at 3.35 TB/s), and reads each
kernel's device time with torch.profiler. It prints the registers and
spills of ``fused_ln.cu``'s kernels (``nvcc -Xptxas -v``), one line a case,
the card's name and power limit, and one JSON object; it exits 1 if a check
fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from colxlip_tpu_torch.ops import build, fused_ln  # noqa: E402

CASES = [
    # name, leading shape, D, timed
    ("vision", (256, 197), 768, True),
    ("text", (256, 77), 512, True),
    ("token-head", (256, 196), 512, True),
    ("vit-l", (16, 257), 1024, True),
    ("ragged", (197 * 3,), 512, False),
    ("d40", (5, 3), 40, False),
]


def inputs(lead, d, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(*lead, d, generator=gen) * 2 + 0.5).to(dev, dtype)
    dy = torch.randn(*lead, d, generator=gen).to(dev, dtype)
    scale = (1 + 0.1 * torch.randn(d, generator=gen)).to(dev)
    return x, scale, dy


def main() -> int:
    import torch.nn.functional as F

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ln_bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    kernels = build.load_kernels()
    usage = build.resource_usage(["fused_ln"])
    print(f"build {kernels.build_seconds:.1f} s; fused_ln.cu registers / stack / spill stores / "
          "spill loads: " + "; ".join(f"{k} {v}" for k, v in sorted(usage.items())), flush=True)
    results, ok = {"registers": usage}, True
    ms = chip_smoke.cuda_ms
    for name, lead, d, timed in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, scale, dy = inputs(lead, d, dtype, dev)
            got = fused_ln._launch_bwd(x, scale, dy, 1e-5)
            again = fused_ln._launch_bwd(x, scale, dy, 1e-5)
            want = fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5)
            torch.cuda.synchronize()
            tname = str(dtype).split(".")[-1]
            err = max(chip_smoke.max_rel_err(g, w) for g, w in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            good = err <= chip_smoke.FUSED_BWD_TOL[tname] and same
            ok &= good
            entry = {"shape": [*lead, d], "err": err, "bit_equal": same, "ok": good}
            line = (f"{name} {tuple(x.shape)} {tname}: max_abs_err / max|grad| {err:.3g} (tol "
                    f"{chip_smoke.FUSED_BWD_TOL[tname]:.3g}); reruns "
                    f"{'bit-equal' if same else 'DIFFER'}{'' if good else '  FAILED'}")
            if timed and (dtype == torch.bfloat16 or name == "vision"):
                w, b = scale.to(dtype), torch.zeros_like(scale).to(dtype)
                x_ = x.clone().requires_grad_()
                w_, b_ = w.clone().requires_grad_(), b.clone().requires_grad_()
                y_ = F.layer_norm(x_, (d,), w_, b_, 1e-5)
                sink = torch.empty_like(x)
                calls = {
                    "kernel": lambda: fused_ln._launch_bwd(x, scale, dy, 1e-5),
                    "plain": lambda: fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5),
                    "library": lambda: torch.autograd.grad(y_, (x_, w_, b_), dy,
                                                           retain_graph=True),
                    # the same bytes with no arithmetic: read x and dy, write one [R, D]
                    "stream": lambda: torch.add(x, dy, out=sink)}
                times = {k: [] for k in calls}
                for key in (*calls, *reversed(calls)):
                    times[key].append(ms(calls[key], args.iters, 5))
                rows = x.numel() // d
                bound, by = chip_smoke.bound_ms(3 * rows * d * x.element_size(), 16 * rows * d,
                                                tname)
                split = chip_smoke.device_ms_by_kernel(
                    calls["kernel"], 20, r"((?:ln|reduce)_\w+_kernel(?:<[^>]*>)?)")
                entry.update(ms=times, bound_ms=bound, bound_by=by, device_ms=split)
                line += (f"\n  kernel {times['kernel'][0]:.4f}/{times['kernel'][1]:.4f} ms, "
                         f"plain {times['plain'][0]:.4f}/{times['plain'][1]:.4f}, "
                         f"F.layer_norm backward {times['library'][0]:.4f}/"
                         f"{times['library'][1]:.4f}, torch.add(x, dy) (the same bytes) "
                         f"{times['stream'][0]:.4f}/{times['stream'][1]:.4f}, bound {bound:.5f} "
                         f"({by}) = "
                         f"{bound / min(times['kernel']):.1%} of it; device ms a call "
                         + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
                del x_, w_, b_, y_
            results[f"{name}/{tname}"] = entry
            print(line, flush=True)
            del x, scale, dy, got, again, want
    print(card)
    print(json.dumps({"card": card, "ok": ok, "cases": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
