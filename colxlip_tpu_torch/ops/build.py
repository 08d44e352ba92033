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
    # text, image, mask, out, M, K, Lt, Li, D, mask_mode, dtype, stream
    "colxlip_maxsim_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # text, image, mask, g, coef, ties, dtext, dimage, M, K, Lt, Li, D,
    # mask_mode, dtype, stream
    "colxlip_maxsim_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
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
