#!/usr/bin/env python3
"""Check and time the port's MaxSim kernels on one NVIDIA GPU.

    python3 scripts/torch_maxsim_bench.py [--iters 10]

For each case (the flagship train step's 256 x 256 in bf16 and in fp32, the
serving path's 64 x 64 in fp32, and 577 image tokens against 100 text
tokens, ViT-L/14 at 336 px, in bf16; 256 x 256 where one image token
of every image collects every text token's max, as one does at random init;
and rows of 4104 and 8192 features, past the backward's one dT slice of
4096, in both dtypes at a small M, K, Lt and Li)
it holds the forward and the backward
kernel against their plain versions (chip_smoke.py's tolerances: scores
1e-5; gradients 1e-5 fp32, 2^-7 bf16 of the largest |grad|), checks that two
backward runs give the same bits, times kernel and plain version with CUDA
events in turns (kernel, plain, plain, kernel), and reads the device time of
each pass (forward: max, mean; backward: route, settle, coef, dt, di) with
torch.profiler. Text tokens past a seeded EOT are zero, as the text tower
leaves them. Prints one line a case with each kernel's bound and a SHA-256
of each output (scores, dT, dI: two trees on the same card compare line by
line), the card's name and power limit, and one JSON object. A case the
kernels refuse (an earlier tree's D limit) prints "refused" and fails
nothing.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from colxlip_tpu_torch.ops import maxsim  # noqa: E402

CASES = [
    # name, M (= K), Lt, Li, D, dtype
    ("train-bf16", 256, 77, 196, 512, torch.bfloat16),
    ("train-fp32", 256, 77, 196, 512, torch.float32),
    ("serving-fp32", 64, 77, 196, 512, torch.float32),
    ("long-bf16", 16, 100, 577, 768, torch.bfloat16),
    ("hot-bf16", 256, 77, 196, 512, torch.bfloat16),
    ("wide-4104-fp32", 8, 16, 40, 4104, torch.float32),
    ("wide-4104-bf16", 8, 16, 40, 4104, torch.bfloat16),
    ("wide-8192-fp32", 8, 16, 40, 8192, torch.float32),
    ("wide-8192-bf16", 8, 16, 40, 8192, torch.bfloat16),
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


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


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
        scores = maxsim._launch_fwd(t, img, "nonzero", None)
        fwd_err = (scores - maxsim.maxsim_plain(t, img)).abs().max().item()
        try:
            got = maxsim._launch_bwd(t, img, g, "nonzero", None)
        except ValueError as refused:
            print(f"{name} M=K={m} Lt={lt} Li={li} D={d}: backward refused ({refused})",
                  flush=True)
            results[name] = {"d": d, "refused": str(refused)}
            continue
        again = maxsim._launch_bwd(t, img, g, "nonzero", None)
        want = maxsim.maxsim_bwd_plain(t, img, g)
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        digests = {"scores": digest(scores), "dt": digest(got[0]), "di": digest(got[1])}
        bounds = {"fwd": chip_smoke.maxsim_bound(t, img, False),
                  "bwd": chip_smoke.maxsim_bound(t, img, True)}
        del got, again, want, scores
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
                         "bwd_ms": [bwd[0], bwd[3]], "bwd_plain_ms": bwd[1:3], "passes_ms": passes,
                         "bound_ms": bounds, "sha256": digests}
        print(f"{name} M=K={m} Lt={lt} Li={li} D={d}: forward err {fwd_err:.3g}, dT {errs[0]:.3g}, "
              f"dI {errs[1]:.3g} of max|grad|, reruns {'bit-equal' if same else 'DIFFER'}; "
              f"forward {fwd[0]:.4f}/{fwd[3]:.4f} ms (plain {fwd[1]:.4f}/{fwd[2]:.4f}), backward "
              f"{bwd[0]:.4f}/{bwd[3]:.4f} ms (plain {bwd[1]:.4f}/{bwd[2]:.4f}); passes "
              + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
              + "; bound forward {:.5f} ms ({}), backward {:.5f} ms ({})".format(
                  *bounds["fwd"], *bounds["bwd"])
              + "; sha256 " + ", ".join(f"{k} {v}" for k, v in digests.items())
              + ("" if good else "  FAILED"), flush=True)
        del t, img, g
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "ok": ok, "cases": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
