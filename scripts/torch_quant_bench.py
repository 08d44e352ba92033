#!/usr/bin/env python3
"""Check and time the port's int8 quantizer kernel on one NVIDIA GPU.

    python3 scripts/torch_quant_bench.py [--iters 50] [--ablate]

At the Dense shapes the kernel is for (ViT-B-16's [768, 3072] in fp32 and
bf16 and [3072, 768]; ViT-L-14's c_proj [4096, 1024]; a K of 16,384) it holds
the kernel's values and scales equal to ``quantize_int8_plain``'s bit for
bit (seed 0) and times a call three ways: the call (CUDA events around
``--iters`` back-to-back calls), its host side (the host clock around 200
calls that never wait for the card: two allocations and one ctypes call)
and its device side (torch.profiler: the sum of the device operations of 20
calls, and how many there are a call), beside the bound (the weight read
once, K N int8 and N scales written, at 3.35 TB/s). Then every Dense weight
of ViT-B-16-colxlip (seed 0, 99 weights) through the kernel as
``chip_smoke.py`` phase 9 does it (``chip_smoke.stochastic_tree``), the
median of three, host clock to ``synchronize()``. Prints one line a shape,
the card's name and power limit, and one JSON object; exits 1 if a check
fails. Without ``--ablate`` it runs unchanged in a tree of an earlier
version of the port, for before and after in one call.

``--ablate`` also builds edited copies of ``csrc/quantize_int8.cu`` alone
(``ABLATIONS``: the strip width forced either way, the loads unrolled 8
deep, and, for timing only since their values are wrong, no cluster
barrier, no noise, a multiply by 1 / scale for the division, no stores) and
times each beside the kernel as built and two PyTorch passes over the same
bytes (``w.to(torch.int8)``: one read, one int8 write; ``w.clone()``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from colxlip_tpu_torch.ops import quantization as q  # noqa: E402

SHAPES = [(768, 3072, torch.float32), (768, 3072, torch.bfloat16), (3072, 768, torch.float32),
          (4096, 1024, torch.float32), (16384, 512, torch.float32)]
PEAK_BYTES_PER_S = 3.35e12
SOURCE = pathlib.Path(ROOT) / "colxlip_tpu_torch" / "csrc" / "quantize_int8.cu"
# name: (text of the source, its replacement, values still right)
ABLATIONS = {
    "narrow strips only": ("kWideBlocks = 256;", "kWideBlocks = 1 << 30;", True),
    "wide strips only": ("kWideBlocks = 256;", "kWideBlocks = 0;", True),
    "loads unrolled 8": ("#pragma unroll 4\n    for (int r = ty",
                         "#pragma unroll 8\n    for (int r = ty", True),
    "no cluster barrier": ("  cluster.sync();\n  if (threadIdx.x < W) {",
                           "  __syncthreads();\n  if (threadIdx.x < W) {", False),
    "no noise": ("philox4x32_10(uint32_t(row), uint32_t(col >> 2), 0u, 0u, seed_lo, seed_hi, "
                 "bits);", "bits[0] = bits[1] = bits[2] = bits[3] = uint32_t(row) ^ uint32_t(col);",
                 False),
    "multiply by 1 / scale": ("__fdiv_rn(x, scale)", "(x * (1.0f / scale))", False),
    "no stores": ("*reinterpret_cast<char4*>(out) = make_char4(",
                  "if (k < 0) *reinterpret_cast<char4*>(out) = make_char4(", False),
}


def profile_calls(fn, calls: int = 20):
    """(device ms a call, device operations a call) over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = {e.key[:40]: e.count / calls for e in device}
    return sum(e.self_device_time_total for e in device) / calls / 1e3, ops


def host_ms(fn, calls: int = 200) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def requant_ms(dev) -> tuple:
    """(median ms, launches) of every Dense weight of ViT-B-16-colxlip through
    the kernel, three times."""
    from colxlip_tpu_torch.factory import create_model
    from colxlip_tpu_torch.serving import quantize_text_params, quantize_vision_params

    model, _ = create_model(chip_smoke.MODEL, dev, torch.bfloat16, seed=0)
    trees = {"vision": quantize_vision_params(model), "text": quantize_text_params(model)}
    reads, launches = [], 0
    for _ in range(4):                           # the first warms the allocator
        torch.cuda.synchronize()
        before = q.LAUNCHES.value
        t0 = time.perf_counter()
        for tower, tree in trees.items():
            chip_smoke.stochastic_tree(model, tree, tower)
        torch.cuda.synchronize()
        reads.append((time.perf_counter() - t0) * 1e3)
        launches = q.LAUNCHES.value - before
    return statistics.median(reads[1:]), launches, reads[1:]


def build_variant(source: str, directory: pathlib.Path):
    """csrc/quantize_int8.cu as ``source`` alone in a library under
    ``directory``: its entry point."""
    from colxlip_tpu_torch.ops.build import NVCC_FLAGS, find_nvcc

    d = directory
    d.mkdir()
    for header in SOURCE.parent.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    (d / "quantize_int8.cu").write_text(source)
    lib = d / "libquantize.so"
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(d / "quantize_int8.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).colxlip_quantize_int8
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_uint32] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ablate(dev, card: str) -> dict:
    """Device us a call of each ABLATIONS variant, the source as it is and
    two PyTorch passes over the same bytes, at every shape of SHAPES."""
    source = SOURCE.read_text()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        variants = {"as built": (build_variant(source, pathlib.Path(tmp) / "0"), True)}
        for i, (name, (old, new, right)) in enumerate(ABLATIONS.items(), 1):
            if old not in source:
                raise RuntimeError(f"ablation '{name}': its text is not in {SOURCE.name}")
            variants[name] = (build_variant(source.replace(old, new), pathlib.Path(tmp) / str(i)),
                              right)
        gen = torch.Generator().manual_seed(1)
        for k, n, dtype in SHAPES:
            w = (torch.randn(k, n, generator=gen) * k ** -0.5).to(dev, dtype)
            values = torch.empty((k, n), dtype=torch.int8, device=dev)
            scales = torch.empty((1, n), device=dev)
            want = q.quantize_int8_plain(w, 0)[0]
            key = f"{k}x{n}/{str(dtype).split('.')[-1]}"
            row = {"w.to(int8)": profile_calls(lambda: w.to(torch.int8))[0] * 1e3,
                   "w.clone()": profile_calls(lambda: w.clone())[0] * 1e3}
            stream = torch.cuda.current_stream(dev).cuda_stream
            for name, (fn, right) in variants.items():
                def call(fn=fn):
                    err = fn(w.data_ptr(), values.data_ptr(), scales.data_ptr(), k, n, 0, 0,
                             0 if dtype == torch.float32 else 1, stream)
                    if err:
                        raise RuntimeError(f"ablation '{name}': cudaError_t {err}")
                row[name] = profile_calls(call)[0] * 1e3
                if right and not torch.equal(values, want):
                    raise RuntimeError(f"ablation '{name}' at {key}: values differ")
            out[key] = row
            print(f"ablation {key} device us a call: "
                  + ", ".join(f"{name} {us:.2f}" for name, us in row.items()) + f" ({card})",
                  flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_quant_bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    results, ok = {}, True
    for k, n, dtype in SHAPES:
        w = (torch.randn(k, n, generator=gen) * k ** -0.5).to(dev, dtype)
        values, scales = q._launch(w, 0)
        want_values, want_scales = q.quantize_int8_plain(w, 0)
        equal = torch.equal(values, want_values) and torch.equal(scales, want_scales)
        ok &= equal
        call = chip_smoke.cuda_ms(lambda: q._launch(w, 0), args.iters)
        host = host_ms(lambda: q._launch(w, 0))
        device, ops = profile_calls(lambda: q._launch(w, 0))
        bound = (k * n * w.element_size() + k * n + 4 * n) / PEAK_BYTES_PER_S * 1e3
        key = f"{k}x{n}/{str(dtype).split('.')[-1]}"
        results[key] = {"bit_equal": equal, "call_ms": call, "host_ms": host,
                        "device_ms": device, "device_ops_a_call": ops, "bound_ms": bound}
        print(f"{key}: {'bit-equal' if equal else 'DIFFERS FROM'} the plain version; call "
              f"{call:.4f} ms, host side {host:.4f} ms, device {device:.5f} ms "
              f"({bound / device:.1%} of the bound {bound:.5f}; device operations a call "
              f"{ops}) ({card})", flush=True)
        del w, values, scales, want_values, want_scales
    ms, launches, reads = requant_ms(dev)
    results["requant"] = {"median_ms": ms, "launches": launches, "reads_ms": reads}
    print(f"ViT-B-16-colxlip, every Dense weight through the kernel: {launches} launches, "
          f"median {ms:.2f} ms of {[round(r, 2) for r in reads]} ({card})", flush=True)
    if args.ablate:
        results["ablation_device_us"] = ablate(dev, card)
    print(card)
    print(json.dumps({"card": card, "ok": ok, "results": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
