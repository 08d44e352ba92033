"""Build and load the port's CUDA kernels (``colxlip_tpu_torch/csrc/*.cu``).

The kernels have a plain C interface and no PyTorch headers, so they build
in seconds with ``nvcc``: one ``nvcc -c`` per source, all started together,
then one link into a shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c csrc/<name>.cu -o <name>.o                       # each source at once
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o \\
         colxlip_tpu_torch/build/libcolxlip_kernels-<hash>.so *.o

The build runs at first use, keyed on a hash of the sources and headers
(``csrc/*.cu``, ``csrc/*.cuh``) and the flags,
into ``colxlip_tpu_torch/build/`` (listed in ``.gitignore``). A missing
``nvcc`` or a failed build raises ``RuntimeError``: there is no fallback, so a
CUDA tensor either runs the hand-written kernel or the call fails.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # qkv, out, B, N, H, D, causal, dtype, scale, stream
    "colxlip_attention_fwd": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # qkv, dout, dqkv, stats, B, N, H, D, causal, dtype, scale, stream
    "colxlip_attention_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # a, b, c_abt, c_pb, c_tn, rows, stream
    "colxlip_mma_tile_check": [_P, _P, _P, _P, _P, _I, _P],
    # text, image, mask, max_sim, out, M, K, Lt, Li, D, mask_mode, dtype, stream
    "colxlip_maxsim_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # text, image, mask, g, max_sim, coef, ties, route_q, dtext, dimage, M, K, Lt,
    # Li, D, mask_mode, dtype, stream
    "colxlip_maxsim_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    # a, b, labels, scale, loss, lse, scratch, M, N, D, slices, dtype, stream
    "colxlip_fused_ce_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # a, b, labels, scale, lse, g, da, dscale, scratch, M, N, D, slices, dtype, stream
    "colxlip_fused_ce_bwd_da": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # a, b, labels, scale, lse, g, db, scratch, M, N, D, slices, dtype, stream
    "colxlip_fused_ce_bwd_db": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, gamma, beta, y, rows, D, eps, dtype, stream
    "colxlip_fused_ln_fwd": [_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P],
    # x, gamma, dy, dx, partials, dgb, rows, D, eps, blocks, dtype, stream
    "colxlip_fused_ln_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P],
    # x, w1, b1, w2, b2, out, workspace, scratch, rows, D, H, approximate, chunk_rows,
    # splits, dtype, stream
    "colxlip_fused_mlp_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w1, b1, w2, dy, dx, dw1, db1, dw2, db2, scratch, workspace, rows, D, H,
    # approximate, splits, colsum_blocks, chunk_rows, dtype, stream
    "colxlip_fused_mlp_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # w, values, scales, K, N, seed low word, seed high word, dtype, stream
    "colxlip_quantize_int8": [_P, _P, _P, _I, _I, ctypes.c_uint32, ctypes.c_uint32, _I, _P],
}


class LaunchCounter:
    """Thread-safe count of kernel launches (the serving path launches from
    two batcher threads at once)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "colxlip_tpu_torch CUDA kernels cannot be built, and CUDA tensors "
        "have no fallback")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcolxlip_kernels-{h.hexdigest()[:16]}.so"


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns the library path; raises RuntimeError on any failure."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # objects and the library under a temporary directory, then rename:
    # concurrent builders never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        with ThreadPoolExecutor(len(objs)) as pool:
            for fut in [pool.submit(_run, [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj])
                        for src, obj in zip(_sources(), objs)]:
                fut.result()
        out = os.path.join(tmp, lib.name)
        _run([nvcc, *ARCH_FLAGS, "-shared", "-o", out, *objs])
        os.replace(out, lib)
    return lib


def resource_usage(stems) -> dict:
    """Registers and spills of every kernel in ``csrc/<stem>.cu``, as ``nvcc
    -Xptxas -v`` reports them: {kernel<template arguments>: (registers, stack
    bytes, spill-store bytes, spill-load bytes)}, the name without its
    namespaces. One nvcc per source, all started together, into a temporary
    directory that keeps nothing; for reports only, no path needs it."""
    nvcc = find_nvcc()
    out = {}
    stems = list(stems)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(max(1, len(stems))) as pool:
        procs = [pool.submit(subprocess.run, [
            nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC_DIR / f"{stem}.cu"),
            "-o", os.path.join(tmp, f"{stem}.o")], capture_output=True, text=True)
            for stem in stems]
        for fut in procs:
            proc = fut.result()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
            text = proc.stderr
            if shutil.which("c++filt"):     # readable names; mangled ones otherwise
                text = subprocess.run(["c++filt"], input=text, capture_output=True,
                                      text=True, check=True).stdout
            # three lines a kernel: the entry's name, its stack frame and spills,
            # its registers
            for name, stack, stores, loads, regs in re.findall(
                    r"Compiling entry function '(?:void )?(?:\(anonymous namespace\)::)?"
                    r"(?:\w+::)*(\w+(?:<[^>]*>)?)[^']*'.*?(\d+) bytes stack frame, "
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) registers",
                    text, flags=re.S):
                out[name] = (int(regs), int(stack), int(stores), int(loads))
    return out


class Kernels:
    """The loaded kernel library: one ctypes function per C entry point, each
    returning a cudaError_t (0 = launched)."""

    def __init__(self, path: pathlib.Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)
        self._err_str = self._lib.colxlip_cuda_error_string
        self._err_str.argtypes = [ctypes.c_int]
        self._err_str.restype = ctypes.c_char_p

    def check(self, err: int, name: str) -> None:
        """Raise on a non-zero cudaError_t returned by a kernel entry point:
        a refused launch never runs, and synchronize() would not report it."""
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {err} "
                               f"({self._err_str(err).decode()})")


_LOAD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load() -> Kernels:
    t0 = time.perf_counter()
    path = build()
    return Kernels(path, time.perf_counter() - t0)


def load_kernels() -> Kernels:
    """Build (at first use) and load the kernel library. Raises RuntimeError
    when nvcc is missing or the build fails; never returns a stand-in. The
    serving path's two batcher threads may both make the first call: the
    lock keeps it to one build."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def multiprocessors(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once: the
    wrappers size their grids and K slices by it."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
