#!/usr/bin/env python3
"""Check and time the port's MaxSim kernels on one NVIDIA GPU.

    python3 scripts/torch_maxsim_bench.py [--iters 10]

For each case (the flagship train step's 256 x 256 in bf16 and in fp32, the
serving path's 64 x 64 in fp32, and 577 image tokens against 100 text
tokens, ViT-L/14 at 336 px, in bf16; and 256 x 256 where one image token
of every image collects every text token's max, as one does at random init)
it holds the forward and the backward
kernel against their plain versions (chip_smoke.py's tolerances: scores
1e-5; gradients 1e-5 fp32, 2^-7 bf16 of the largest |grad|), checks that two
backward runs give the same bits, times kernel and plain version with CUDA
events in turns (kernel, plain, plain, kernel), and reads the device time of
each pass (forward: max, mean; backward: route, settle, coef, dt, di) with
torch.profiler. Text tokens past a seeded EOT are zero, as the text tower
leaves them. Prints one line a case, the card's name and power limit, and
one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from colxlip_tpu_torch.ops import maxsim  # noqa: E402

CASES = [
    # name, M (= K), Lt, Li, D, dtype
    ("train-bf16", 256, 77, 196, 512, torch.bfloat16),
    ("train-fp32", 256, 77, 196, 512, torch.float32),
    ("serving-fp32", 64, 77, 196, 512, torch.float32),
    ("long-bf16", 16, 100, 577, 768, torch.bfloat16),
    ("hot-bf16", 256, 77, 196, 512, torch.bfloat16),
]
MAXSIM_TOL = 1e-5
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


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


def pass_ms(fn, calls: int = 3) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(r"maxsim_(?:bwd_)?(\w+?)_kernel", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and found:
            out[found.group(1)] = e.self_device_time_total / 1e3 / calls
    return out


def inputs(m, lt, li, d, dtype, dev, hot=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    t = torch.nn.functional.normalize(torch.randn(m, lt, d, generator=gen), dim=-1)
    img = torch.nn.functional.normalize(torch.randn(m, li, d, generator=gen), dim=-1)
    if hot:   # every text token near one direction, image token 5 on it
        u = torch.nn.functional.normalize(torch.randn(d, generator=gen), dim=0)
        t = torch.nn.functional.normalize(u + 0.5 * t, dim=-1)
        img[:, 5] = u
    eot = torch.randint(3, lt, (m,), generator=gen)
    t = t * (torch.arange(lt)[None, :] < eot[:, None])[:, :, None]
    g = torch.randn(m, m, generator=gen) / m
    return t.to(dev, dtype), img.to(dev, dtype), g.to(dev)


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_maxsim_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    results, ok = {}, True
    for name, m, lt, li, d, dtype in CASES:
        t, img, g = inputs(m, lt, li, d, dtype, dev, hot=name.startswith("hot"))
        fwd_err = (maxsim._launch_fwd(t, img, "nonzero", None)
                   - maxsim.maxsim_plain(t, img)).abs().max().item()
        got = maxsim._launch_bwd(t, img, g, "nonzero", None)
        again = maxsim._launch_bwd(t, img, g, "nonzero", None)
        want = maxsim.maxsim_bwd_plain(t, img, g)
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, want
        fwd = [cuda_ms(lambda: maxsim._launch_fwd(t, img, "nonzero", None), args.iters),
               cuda_ms(lambda: maxsim.maxsim_plain(t, img), args.iters)]
        fwd += [cuda_ms(lambda: maxsim.maxsim_plain(t, img), args.iters),
                cuda_ms(lambda: maxsim._launch_fwd(t, img, "nonzero", None), args.iters)]
        bwd = [cuda_ms(lambda: maxsim._launch_bwd(t, img, g, "nonzero", None), args.iters),
               cuda_ms(lambda: maxsim.maxsim_bwd_plain(t, img, g), args.iters)]
        bwd += [cuda_ms(lambda: maxsim.maxsim_bwd_plain(t, img, g), args.iters),
                cuda_ms(lambda: maxsim._launch_bwd(t, img, g, "nonzero", None), args.iters)]
        passes = {**pass_ms(lambda: maxsim._launch_fwd(t, img, "nonzero", None)),
                  **pass_ms(lambda: maxsim._launch_bwd(t, img, g, "nonzero", None))}
        good = (fwd_err <= MAXSIM_TOL and max(errs) <= BWD_TOL[dtype] and same)
        ok &= good
        results[name] = {"fwd_err": fwd_err, "dt_err": errs[0], "di_err": errs[1],
                         "bit_equal": same, "fwd_ms": [fwd[0], fwd[3]], "fwd_plain_ms": fwd[1:3],
                         "bwd_ms": [bwd[0], bwd[3]], "bwd_plain_ms": bwd[1:3], "passes_ms": passes}
        print(f"{name} M=K={m} Lt={lt} Li={li} D={d}: forward err {fwd_err:.3g}, dT {errs[0]:.3g}, "
              f"dI {errs[1]:.3g} of max|grad|, reruns {'bit-equal' if same else 'DIFFER'}; "
              f"forward {fwd[0]:.4f}/{fwd[3]:.4f} ms (plain {fwd[1]:.4f}/{fwd[2]:.4f}), backward "
              f"{bwd[0]:.4f}/{bwd[3]:.4f} ms (plain {bwd[1]:.4f}/{bwd[2]:.4f}); passes "
              + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
              + ("" if good else "  FAILED"), flush=True)
        del t, img, g
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "ok": ok, "cases": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
