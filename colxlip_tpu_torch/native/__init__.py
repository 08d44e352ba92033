"""ctypes bindings for the port's native C++ data-loader core: port of
``colxlip_tpu/native/__init__.py``.

Two plain-C shared libraries, built from this package's own sources with
``g++`` at first use into ``colxlip_tpu_torch/build/`` (git-ignored), keyed
on a hash of the source and the command, written to a temporary name and
renamed, so concurrent builds (test workers, loader threads) never load a
half-written library:

  ``dataloader.cc``    fused JPEG decode -> crop -> resize (-> normalize) over
                       a thread pool (needs ``jpeglib.h`` and ``-ljpeg``),
                       and the batch RGB -> planar YUV420 conversion;
  ``bpe_tokenizer.cc`` the CLIP byte-BPE for printable-ASCII captions.

Unlike the JAX package, which quietly reports ``available() == False`` and
decodes with PIL when the build fails, a failed build here raises
``RuntimeError`` with the compiler's output: a caller that asks for the core
(``--native-decode``, the native tokenizer) gets it or an error.
``libjpeg_present()`` is the probe a caller may run first to decide, without
an exception, whether to ask for the decoder at all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

NATIVE_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "build"
CXX = "g++"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIBS: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dataloader": {
        "cx_jpeg_info": (_I, [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.POINTER(_I), ctypes.POINTER(_I)]),
        # jpegs, lens, n, out, out_h, out_w, crops, mean, std, threads
        "cx_process_batch": (_I, [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.POINTER(ctypes.c_size_t), _I, _P, _I, _I, _P, _P,
                                  _P, _I]),
        # jpegs, lens, n, out, out_h, out_w, crops, threads
        "cx_process_batch_u8": (_I, [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.POINTER(ctypes.c_size_t), _I, _P, _I, _I, _P,
                                     _I]),
        # in, n, h, w, out, threads
        "cx_rgb_to_yuv420": (_I, [_P, _I, _I, _I, _P, _I]),
    },
    "bpe_tokenizer": {
        "cx_bpe_init": (_I, [ctypes.c_char_p, ctypes.c_size_t]),
        # handle, texts, n, ctx, out
        "cx_bpe_encode_batch": (_I, [_I, ctypes.POINTER(ctypes.c_char_p), _I, _I, _P]),
        "cx_bpe_free": (None, [_I]),
    },
}
_LINK = {"dataloader": ("-ljpeg", "-pthread"), "bpe_tokenizer": ()}


def _compile(src: pathlib.Path, out: str, link: Sequence[str]) -> None:
    cmd = [CXX, *_CXX_FLAGS, str(src), "-o", out, *link]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native core: cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native core: {CXX} failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def library_path(name: str) -> pathlib.Path:
    src = NATIVE_DIR / f"{name}.cc"
    h = hashlib.sha256(" ".join((CXX, *_CXX_FLAGS, *_LINK[name])).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``native/<name>.cc`` unless its library exists; raises
    RuntimeError (with the compiler's output) on any failure."""
    lib = library_path(name)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = os.path.join(tmp, lib.name)
        _compile(NATIVE_DIR / f"{name}.cc", out, _LINK[name])
        os.replace(out, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` ('dataloader' or 'bpe_tokenizer'), typed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn_name, (restype, argtypes) in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIBS[name] = lib
        return lib


def libjpeg_present() -> bool:
    """Whether this machine can build the decoder: a one-line program that
    includes ``jpeglib.h`` compiles and links with ``-ljpeg``."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cc")
        with open(src, "w") as f:
            f.write("#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n"
                    "int main() { jpeg_decompress_struct c; jpeg_error_mgr e;\n"
                    "  c.err = jpeg_std_error(&e); jpeg_create_decompress(&c);\n"
                    "  jpeg_destroy_decompress(&c); return 0; }\n")
        try:
            proc = subprocess.run([CXX, src, "-o", os.path.join(tmp, "probe"), "-ljpeg"],
                                  capture_output=True, timeout=120)
        except OSError:   # no compiler at all: nothing can be built
            return False
        return proc.returncode == 0


def jpeg_info(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from a JPEG header, or None when it is not a readable JPEG."""
    lib = load("dataloader")
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.cx_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def process_batch(jpegs: Sequence[bytes], out_size: Tuple[int, int],
                  mean: Sequence[float], std: Sequence[float],
                  crops: Optional[np.ndarray] = None, num_threads: int = 8,
                  normalize: bool = True) -> Tuple[np.ndarray, int]:
    """Decode and transform a batch of JPEG byte strings in one call.

    ``crops``: int32 [n, 4] boxes (x, y, w, h) in original image coordinates
    (the caller's RandomResizedCrop draws), or None for the eval-style
    shortest-side resize and center crop. ``normalize=True`` returns float32
    (x/255 - mean)/std; False returns raw uint8 RGB for the device-side
    normalisation. Returns ([n, H, W, 3], failures); a failed slot is zeros."""
    lib = load("dataloader")
    n = len(jpegs)
    out_h, out_w = out_size
    arr = (ctypes.c_char_p * n)(*jpegs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in jpegs])
    crops_ptr = None
    if crops is not None:
        crops = np.ascontiguousarray(crops, np.int32)
        if crops.shape != (n, 4):
            raise ValueError(f"crops must be int32 [{n}, 4]; got {crops.shape}")
        crops_ptr = crops.ctypes.data
    if not normalize:
        out = np.empty((n, out_h, out_w, 3), np.uint8)
        failures = lib.cx_process_batch_u8(arr, lens, n, out.ctypes.data, out_h, out_w,
                                           crops_ptr, num_threads)
        return out, int(failures)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    mean_arr = np.asarray(mean, np.float32)
    std_arr = np.asarray(std, np.float32)
    failures = lib.cx_process_batch(arr, lens, n, out.ctypes.data, out_h, out_w, crops_ptr,
                                    mean_arr.ctypes.data, std_arr.ctypes.data, num_threads)
    return out, int(failures)


def rgb_to_yuv420(rgb: np.ndarray, num_threads: int = 4) -> np.ndarray:
    """uint8 RGB [n, h, w, 3] -> planar YUV420 [n, h*3//2, w], bit-equal to
    the numpy ``ops.yuv420.rgb_to_yuv420``."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"expected uint8 [n, h, w, 3], got {rgb.dtype} {rgb.shape}")
    lib = load("dataloader")
    n, h, w = rgb.shape[:3]
    out = np.empty((n, h + h // 2, w), np.uint8)
    if lib.cx_rgb_to_yuv420(rgb.ctypes.data, n, h, w, out.ctypes.data, num_threads) != 0:
        raise ValueError(f"YUV420 needs even H, W; got {h}x{w}")
    return out


def bpe_init(merges_blob: bytes) -> int:
    """A native tokenizer over the merge table ('first second' lines, UTF-8;
    empty = the zero-merges layout); the handle for ``bpe_encode_batch``."""
    handle = load("bpe_tokenizer").cx_bpe_init(merges_blob, len(merges_blob))
    if handle < 0:
        raise RuntimeError("native tokenizer: cx_bpe_init refused the merge table")
    return int(handle)


def bpe_free(handle: Optional[int]) -> None:
    """Release a handle; a no-op when the library was never loaded (as at
    interpreter shutdown)."""
    lib = _LIBS.get("bpe_tokenizer")
    if lib is not None and handle is not None:
        lib.cx_bpe_free(handle)


def bpe_encode_batch(handle: int, texts: Sequence[bytes], context_length: int) -> np.ndarray:
    """ASCII byte strings -> [n, ctx] int32 (SOT ... EOT, zero-padded, EOT
    forced into the last slot on truncation: the tokenizer's layout)."""
    n = len(texts)
    out = np.zeros((n, context_length), np.int32)
    if n == 0:
        return out
    arr = (ctypes.c_char_p * n)(*texts)
    rc = load("bpe_tokenizer").cx_bpe_encode_batch(handle, arr, n, context_length,
                                                   out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"native tokenizer: encode failed (rc={rc})")
    return out
