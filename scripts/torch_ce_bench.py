#!/usr/bin/env python3
"""Check and time the port's streaming-CE kernels on one NVIDIA GPU.

    python3 scripts/torch_ce_bench.py [--sizes 256,4096,32768] [--iters 10]
                                      [--dtype float32]

Runs the three kernels of ``csrc/fused_ce.cu`` alone in bf16 (forward #11,
dA with the per-row dscale #12, dB #13), or with ``--dtype float32`` on the
CUDA cores, each split across the streamed rows where its row blocks alone
would not fill the card (``ops.fused_ce.fp32_fwd_slices``,
``fp32_da_slices``, ``fp32_db_slices``: at 4096 the forward takes 4 slices,
dA and dB 2; at 8192 the forward 2, dA and dB 1; ``--sizes
4096,8192,32768``), also at D = 1000 and 1024. For each size M = N (D = 512,
the logit scales of ``chip_smoke.py``'s ``CE_CASES``), for "local-loss" (M
256 x N 1024, D 512, labels 768.., rank 3's rows of a 4-rank local-loss clip
step, as ``chip_smoke.py`` phase 12c) and for the extra shapes
below it holds each kernel against its plain version under
``chip_smoke.py``'s bars (loss rows and lse 1e-5 of 1 + |value|; dA, dB and
dscale 1e-4 of the largest |grad|) and checks that two backward runs give
the same bits (bf16 at D = 1000 and 1024 takes the chunked walk, past the
whole tiles' 768 features). At each size it then times, with CUDA events in turns
(kernel, plain, plain, kernel), each kernel and its plain version, the
dense pair (fp32 ``torch.matmul`` + ``F.cross_entropy``, which holds the
[M, N] logits: forward, and forward plus backward) and one direction of the
loss under autograd through the kernels (forward + dA + dB), beside each
kernel's bound and the slices it takes, and reads the device time of each
kernel and of its second pass apart (the forward's merge, dA's and dB's
reduce) with torch.profiler. It prints the registers and spills of
``fused_ce.cu``'s kernels (``nvcc -Xptxas -v``), one line a case with a
SHA-256 of each output (loss, lse, dA, dscale, dB: two trees on the same
card can be compared line by line), the card's name and power limit, and
one JSON object; it exits 1 if a check fails. A case the kernels refuse
(an earlier tree's D limit) prints "refused" and fails nothing. With
``--unsplit`` every float32 kernel takes one slice (the wrapper's slice
rules held to 1), so the digests compare with an earlier tree's unsplit
kernels bit for bit.

The case "tied-100" (b = a at logit scale 100) is held to the same bars:
there each row's own column has a logit of about 100, so a few fp32 steps
between the forward's and the backward's sums of <a_i, a_i> would move p by
100 times as much; all three bf16 kernels take raw from one logit tile
(``logit_tile``), so their sums agree bit for bit.
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
from colxlip_tpu_torch.ops import build, fused_ce  # noqa: E402

SCALES = {256: 1 / 0.07}          # chip_smoke.CE_CASES: 100 at the larger sizes
EXTRA = [
    # name, M, N, D, logit scale, b = a, label offset (None: random labels), timed, dtypes
    ("local-loss", 256, 1024, 512, 1 / 0.07, False, 768, True, ("bfloat16", "float32")),
    ("vit-l-768", 4096, 4096, 768, 100.0, False, None, True, ("bfloat16", "float32")),
    ("ragged-64", 33, 129, 64, 30.0, False, None, False, ("bfloat16", "float32")),
    ("d36", 130, 200, 36, 20.0, False, None, False, ("bfloat16", "float32")),
    ("tied", 1024, 1024, 512, 1 / 0.07, True, None, False, ("bfloat16", "float32")),
    ("tied-100", 1024, 1024, 512, 100.0, True, None, False, ("bfloat16",)),
    ("wide-1000", 300, 1000, 1000, 30.0, False, None, False, ("bfloat16", "float32")),
    ("wide-1024", 4096, 4096, 1024, 100.0, False, None, True, ("bfloat16", "float32")),
    ("wide-1000-4096", 4096, 4096, 1000, 100.0, False, None, True, ("bfloat16",)),
]


def inputs(m, n, d, scale, tied, dev, seed=0, dtype=torch.bfloat16, offset=None):
    gen = torch.Generator().manual_seed(seed)
    a, b, labels, s, g = chip_smoke.ce_inputs(m, n, d, scale, dtype, dev, gen)
    if offset is not None:
        labels = (torch.arange(m, dtype=torch.int32) + offset).to(dev)
    return a, (a.clone() if tied else b), labels, s, g


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check(a, b, labels, s, g):
    """Errors of the three kernels against their plain versions, and whether
    two runs of each agree bit for bit."""
    loss, lse = fused_ce._launch_fwd(a, b, labels, s)
    da, ds = fused_ce._launch_bwd_da(a, b, labels, s, lse, g)
    db = fused_ce._launch_bwd_db(a, b, labels, s, lse, g)
    again = (*fused_ce._launch_fwd(a, b, labels, s),
             *fused_ce._launch_bwd_da(a, b, labels, s, lse, g),
             fused_ce._launch_bwd_db(a, b, labels, s, lse, g))
    want_loss, want_lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, want_lse, g)
    want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, want_lse, g)
    torch.cuda.synchronize()

    def unit(got, want):
        return ((got - want).abs() / (1 + want.abs())).max().item()

    err = {"fwd": max(unit(loss, want_loss), unit(lse, want_lse)),
           "da": chip_smoke.max_rel_err(da, want_da), "dscale": chip_smoke.max_rel_err(ds, want_ds),
           "db": chip_smoke.max_rel_err(db, want_db)}
    same = all(torch.equal(x, y) for x, y in zip((loss, lse, da, ds, db), again))
    good = (err["fwd"] <= chip_smoke.CE_FWD_TOL and torch.isfinite(loss).all().item()
            and max(err["da"], err["dscale"], err["db"]) <= chip_smoke.CE_BWD_TOL and same)
    digests = {"loss": digest(loss), "lse": digest(lse), "da": digest(da), "dscale": digest(ds),
               "db": digest(db)}
    return err, same, good, lse, digests


def slices_of(m, n, d, dtype, dev) -> dict:
    """Slices of the streamed rows each kernel takes (1 where a tree has no
    split for it)."""
    if dtype != torch.float32:
        return {"fwd": 1, "bwd_da": 1, "bwd_db": 1}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def rule(name, *args):
        return getattr(fused_ce, name)(*args, sms) if hasattr(fused_ce, name) else 1

    return {"fwd": rule("fp32_fwd_slices", m, n), "bwd_da": rule("fp32_da_slices", m, n, d),
            "bwd_db": rule("fp32_db_slices", m, n, d)}


def time_size(m, a, b, labels, s, lse, g, iters):
    import torch.nn.functional as F

    ms = chip_smoke.cuda_ms
    warm = 1 if m > 4096 else 2
    calls = {
        "fwd": (lambda: fused_ce._launch_fwd(a, b, labels, s),
                lambda: fused_ce.fused_ce_fwd_plain(a, b, labels, s)),
        "bwd_da": (lambda: fused_ce._launch_bwd_da(a, b, labels, s, lse, g),
                   lambda: fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, lse, g)),
        "bwd_db": (lambda: fused_ce._launch_bwd_db(a, b, labels, s, lse, g),
                   lambda: fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, lse, g)),
    }
    row = {}
    for key, (kernel, plain) in calls.items():
        k1, p1 = ms(kernel, iters, warm), ms(plain, iters, warm)
        p2, k2 = ms(plain, iters, warm), ms(kernel, iters, warm)
        row[key] = {"kernel_ms": [k1, k2], "plain_ms": [p1, p2]}
    long_labels = labels.long()
    a_, b_, s_ = (x.clone().requires_grad_() for x in (a, b, s))

    def dense():
        return F.cross_entropy(s_ * torch.matmul(a_.float(), b_.float().T), long_labels)

    def dense_fwd():
        with torch.no_grad():
            dense()

    def fused_step():
        torch.autograd.grad(fused_ce.fused_contrastive_ce(a_, b_, labels, s_), (a_, b_, s_))

    dense_ms = {"fwd": ms(dense_fwd, iters, warm),
                "fwd_bwd": ms(lambda: torch.autograd.grad(dense(), (a_, b_, s_)), iters, warm)}
    autograd_ms = ms(fused_step, iters, warm)
    bounds = chip_smoke.ce_bounds(a, b)
    for key in row:
        row[key]["bound_ms"], row[key]["bound_by"] = bounds[f"fused_ce_{key}"]
    passes = {key: chip_smoke.device_ms_by_kernel(
        kernel, 2 if m > 4096 else 5, r"(ce_\w+_kernel(?:<[^>]*>)?|reduce_partials\w*)")
        for key, (kernel, _) in calls.items()}
    return row, dense_ms, autograd_ms, passes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="256,4096,32768")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--unsplit", action="store_true",
                    help="hold every float32 kernel to one slice of the streamed rows")
    args = ap.parse_args()
    if args.unsplit:
        for rule in ("fp32_fwd_slices", "fp32_da_slices", "fp32_db_slices"):
            if hasattr(fused_ce, rule):
                setattr(fused_ce, rule, lambda *_: 1)
    if not torch.cuda.is_available():
        print("torch_ce_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    kernels = build.load_kernels()
    usage = build.resource_usage(["fused_ce"])
    print(f"build {kernels.build_seconds:.1f} s; fused_ce.cu registers / stack / spill stores / "
          "spill loads: " + "; ".join(f"{k} {v}" for k, v in sorted(usage.items())), flush=True)
    results, ok = {"registers": usage, "dtype": args.dtype, "unsplit": args.unsplit}, True
    dtype = getattr(torch, args.dtype)
    cases = [(f"{m}", m, m, 512, SCALES.get(m, 100.0), False, None, True)
             for m in (int(x) for x in args.sizes.split(","))]
    cases += [case[:-1] for case in EXTRA if args.dtype in case[-1]]
    for name, m, n, d, scale, tied, offset, timed in cases:
        a, b, labels, s, g = inputs(m, n, d, scale, tied, dev, dtype=dtype, offset=offset)
        try:
            err, same, good, lse, digests = check(a, b, labels, s, g)
        except ValueError as refused:
            print(f"{name} M={m} N={n} D={d} {args.dtype}: refused ({refused})", flush=True)
            results[name] = {"m": m, "n": n, "d": d, "refused": str(refused)}
            continue
        ok &= good
        slices = slices_of(m, n, d, dtype, dev)
        entry = {"m": m, "n": n, "d": d, "scale": scale, "tied": tied, "label_offset": offset,
                 "errors": err, "bit_equal": same, "ok": good, "slices": slices,
                 "sha256": digests}
        line = (f"{name} M={m} N={n} D={d} scale={scale:.4g}{' b=a' if tied else ''}"
                + (f" labels {offset}.." if offset is not None else "")
                + f" {args.dtype} (slices of the streamed rows: fwd {slices['fwd']}, dA "
                f"{slices['bwd_da']}, dB {slices['bwd_db']}): errors "
                + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
                + f"; reruns {'bit-equal' if same else 'DIFFER'}; sha256 "
                + ", ".join(f"{k} {v}" for k, v in digests.items())
                + ("" if good else "  FAILED"))
        if timed:
            iters = max(2, args.iters // 5) if m > 4096 else args.iters
            row, dense_ms, autograd_ms, passes = time_size(m, a, b, labels, s, lse, g, iters)
            entry.update(timing=row, dense_ms=dense_ms, autograd_ms=autograd_ms,
                         device_ms=passes)
            line += "".join(
                f"\n  {key}: kernel {v['kernel_ms'][0]:.4f}/{v['kernel_ms'][1]:.4f} ms, plain "
                f"{v['plain_ms'][0]:.4f}/{v['plain_ms'][1]:.4f} ms, bound {v['bound_ms']:.5f} ms "
                f"({v['bound_by']})" for key, v in row.items())
            line += (f"\n  dense pair forward {dense_ms['fwd']:.4f} ms, forward + backward "
                     f"{dense_ms['fwd_bwd']:.4f} ms; one direction through the kernels under "
                     f"autograd {autograd_ms:.4f} ms; device ms a call: "
                     + "; ".join(f"{key} " + ", ".join(f"{k} {v:.4f}" for k, v in p.items())
                                 for key, p in passes.items()))
        results[name] = entry
        print(line, flush=True)
        del a, b, labels, s, g, lse
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "ok": ok, "cases": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
