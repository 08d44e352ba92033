#!/usr/bin/env python3
"""Check and time the port's LayerNorm kernels (#7 forward, #8 backward) on
one NVIDIA GPU.

    python3 scripts/torch_ln_bench.py [--iters 50]

Runs both kernels of ``csrc/fused_ln.cu`` alone at the fused towers' shapes:
vision 256 x 197 x 768, text 256 x 77 x 512, the token heads 256 x 196 x
512, ViT-L-14's 16 x 257 x 1024, and two ragged ones (591 x 512; 15 x 40),
plus, for the forward's scalar walk, 77 x 36 and rows whose base is not on
16 bytes. At each it holds the forward against ``layernorm_plain`` under
``chip_smoke.py``'s ``FUSED_FWD_TOL`` (2^-7 of max(1, max |y|) in bf16,
1e-5 in fp32) and the backward against ``layernorm_bwd_plain`` under
``FUSED_BWD_TOL`` (2^-7 of the largest |grad| in bf16, 1e-4 in fp32), checks
that two runs give the same bits and that an unaligned copy of x gives the
aligned call's bits, and prints a SHA-256 of each output (two trees on the
same card and seed can be compared line by line). In bf16 at the first four
shapes, and in fp32 at the vision shape, it then times, with CUDA events in
turns (each in order, then each in reverse order): the forward, its plain
version, ``F.layer_norm`` and ``y.copy_(x)`` (the forward's bytes moved with
no arithmetic), beside its bound (2 R D elements at 3.35 TB/s); the
backward, its plain version, ``F.layer_norm``'s autograd backward and
``torch.add(x, dy)`` (the backward's bytes: what the card's memory gives
this access pattern), beside its bound (3 R D elements), and reads each
kernel's device time with torch.profiler. It prints the registers and
spills of ``fused_ln.cu``'s kernels (``nvcc -Xptxas -v``), one line a case,
the card's name and power limit, and one JSON object; it exits 1 if a check
fails.
"""
from __future__ import annotations

import argparse
import hashlib
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
    ("d36", (7, 11), 36, False),      # bf16: not a multiple of 8, the scalar walk
]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def unaligned(x):
    """The same values in a tensor whose base is 2 or 4 bytes past 16."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def inputs(lead, d, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(*lead, d, generator=gen) * 2 + 0.5).to(dev, dtype)
    dy = torch.randn(*lead, d, generator=gen).to(dev, dtype)
    scale = (1 + 0.1 * torch.randn(d, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(d, generator=gen)).to(dev)
    return x, scale, bias, dy


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
    fwd_tol, bwd_tol = chip_smoke.FUSED_FWD_TOL, chip_smoke.FUSED_BWD_TOL
    for name, lead, d, timed in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, scale, bias, dy = inputs(lead, d, dtype, dev)
            tname = str(dtype).split(".")[-1]
            y = fused_ln._launch_fwd(x, scale, bias, 1e-5)
            y_again = fused_ln._launch_fwd(x, scale, bias, 1e-5)
            y_off = fused_ln._launch_fwd(unaligned(x), scale, bias, 1e-5)
            got = fused_ln._launch_bwd(x, scale, dy, 1e-5)
            again = fused_ln._launch_bwd(x, scale, dy, 1e-5)
            want_y = fused_ln.layernorm_plain(x, scale, bias, 1e-5)
            want = fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5)
            torch.cuda.synchronize()
            fwd_err = chip_smoke.max_rel_err(y, want_y, 1.0)
            err = max(chip_smoke.max_rel_err(g, w) for g, w in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            fwd_same = torch.equal(y, y_again) and torch.equal(y, y_off)
            good = (fwd_err <= fwd_tol[tname] and err <= bwd_tol[tname] and same and fwd_same)
            ok &= good
            entry = {"shape": [*lead, d], "fwd_err": fwd_err, "err": err, "bit_equal": same,
                     "fwd_bit_equal": fwd_same, "ok": good,
                     "digest": {"y": digest(y), "grads": digest(*got)}}
            line = (f"{name} {tuple(x.shape)} {tname}: forward max_abs_err / max(1, max|y|) "
                    f"{fwd_err:.3g} (tol {fwd_tol[tname]:.3g}), reruns and unaligned rows "
                    f"{'bit-equal' if fwd_same else 'DIFFER'}; backward max_abs_err / max|grad| "
                    f"{err:.3g} (tol {bwd_tol[tname]:.3g}), reruns "
                    f"{'bit-equal' if same else 'DIFFER'}; sha256 y {entry['digest']['y']} "
                    f"grads {entry['digest']['grads']}{'' if good else '  FAILED'}")
            if timed and (dtype == torch.bfloat16 or name == "vision"):
                w, b = scale.to(dtype), bias.to(dtype)
                x_ = x.clone().requires_grad_()
                w_, b_ = w.clone().requires_grad_(), b.clone().requires_grad_()
                y_ = F.layer_norm(x_, (d,), w_, b_, 1e-5)
                sink = torch.empty_like(x)

                def lib_fwd():
                    with torch.no_grad():
                        F.layer_norm(x, (d,), w, b, 1e-5)

                rows = x.numel() // d
                size = x.element_size()
                for key, calls, bound in (
                        ("fwd", {
                            "kernel": lambda: fused_ln._launch_fwd(x, scale, bias, 1e-5),
                            "plain": lambda: fused_ln.layernorm_plain(x, scale, bias, 1e-5),
                            "library": lib_fwd,
                            # the same bytes with no arithmetic: read x, write one [R, D]
                            "stream": lambda: sink.copy_(x)},
                         chip_smoke.bound_ms(2 * rows * d * size, 8 * rows * d, tname)),
                        ("bwd", {
                            "kernel": lambda: fused_ln._launch_bwd(x, scale, dy, 1e-5),
                            "plain": lambda: fused_ln.layernorm_bwd_plain(x, scale, dy, 1e-5),
                            "library": lambda: torch.autograd.grad(y_, (x_, w_, b_), dy,
                                                                   retain_graph=True),
                            # read x and dy, write one [R, D]
                            "stream": lambda: torch.add(x, dy, out=sink)},
                         chip_smoke.bound_ms(3 * rows * d * size, 16 * rows * d, tname))):
                    times = {k: [] for k in calls}
                    for label in (*calls, *reversed(calls)):
                        times[label].append(ms(calls[label], args.iters, 5))
                    split = chip_smoke.device_ms_by_kernel(
                        calls["kernel"], 20, r"((?:ln|reduce)_\w+_kernel(?:<[^>]*>)?)")
                    entry[key] = {"ms": times, "bound_ms": bound[0], "bound_by": bound[1],
                                  "device_ms": split}
                    line += (f"\n  {key}: kernel {times['kernel'][0]:.4f}/"
                             f"{times['kernel'][1]:.4f} ms, plain {times['plain'][0]:.4f}/"
                             f"{times['plain'][1]:.4f}, F.layer_norm{' backward' * (key == 'bwd')}"
                             f" {times['library'][0]:.4f}/{times['library'][1]:.4f}, "
                             f"{'y.copy_(x)' if key == 'fwd' else 'torch.add(x, dy)'} (the same "
                             f"bytes) {times['stream'][0]:.4f}/{times['stream'][1]:.4f}, bound "
                             f"{bound[0]:.5f} ({bound[1]}) = {bound[0] / min(times['kernel']):.1%}"
                             " of it; device ms a call "
                             + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
                del x_, w_, b_, y_
            results[f"{name}/{tname}"] = entry
            print(line, flush=True)
            del x, scale, bias, dy, y, y_again, y_off, got, again, want, want_y
    print(card)
    print(json.dumps({"card": card, "ok": ok, "cases": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
