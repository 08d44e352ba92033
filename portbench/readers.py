"""Arithmetic the per-layer readers share: kernel-name patterns of the
program's hand-written kernels and of the libraries, and the roofline share
of a kernel over a traced train window.

A reader returns None where it finds nothing to read (no launch of its
kernel in the window), never 0 for a share of a roofline or a peak.
"""
from __future__ import annotations

import re
from typing import Optional

from .yardstick import bounds, flops
from .yardstick.peaks import PEAK_FLOPS

# the program's kernels, as the trace names them (csrc/*.cu)
ATTN_FWD = r"attn_fwd_(mma|fp32)_kernel"
ATTN_BWD = r"attn_bwd_(dq|dkv)_(mma|fp32)_kernel"
MAXSIM_FWD = r"maxsim_(max|mean)_kernel"
MAXSIM_BWD = r"maxsim_bwd_\w+_kernel"
LN_FWD = r"ln_fwd_kernel"
LN_BWD = r"ln_bwd_kernel"
# the MLP tiles' last template argument is the epilogue: 0 and 3 forward
MLP_FWD = r"mlp_s?gemm_kernel<[^<>]*,\s*[03]>"
MLP_BWD = r"mlp_s?gemm_kernel<[^<>]*,\s*[1245]>|colsum_kernel"
SHARED_REDUCE = r"reduce_partials"
# cuBLAS / CUTLASS products, not the MLP tiles
LIBRARY_GEMM = r"gemm|nvjet|xmma|cutlass"
PROGRAM_GEMM = r"mlp_s?gemm_kernel"
OPTIMIZER = r"multi_tensor_apply"


def per_step(window) -> Optional[int]:
    steps = window.units.get("steps", 0)
    return steps or None


def step_bounds_s(cell, key: str) -> float:
    return sum(bounds.train_step_bounds(cell.geometry, cell.params["batch"],
                                        cell.config["dtype"])[key])


def roofline(view, window, cell, key: str, seconds: float) -> Optional[float]:
    """100 x the least time the step's launches of ``key`` could take, over
    the device seconds its kernels took, in the traced steps."""
    steps = per_step(window)
    if not steps or seconds <= 0 or window.counters.get(key, 0) == 0:
        return None
    return 100.0 * step_bounds_s(cell, key) * steps / seconds


def library_gemm_seconds(view) -> float:
    program = re.compile(PROGRAM_GEMM)
    return sum(s for n, s in view.kernels(LIBRARY_GEMM) if not program.search(n))


def mfu(view, window, cell) -> Optional[float]:
    steps = per_step(window)
    if not steps or view.window_s <= 0 or not view.device:
        return None
    work = flops.train_step_flops(cell.geometry, cell.params["batch"]) * steps
    return 100.0 * work / view.window_s / PEAK_FLOPS[cell.config["dtype"]]


def idle_share(view) -> Optional[float]:
    if view.window_s <= 0 or not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
