"""The check of the bf16 fused-MLP forward (``fused_mlp``, kernel #9): a
per-element bar derived from the function's own roundings.

With T the rounding to bfloat16 (to nearest, ties to even) the function is

    h = T(T(x W1^T) + b1);   a = T(gelu(h));   y = T(T(a W2) + b2)

(the JAX reference ``fused_mlp_reference``'s rounding points; gelu is the
kernels' formula, ``fused_mlp.kernel_gelu``). ``forward_bar`` evaluates it in
float64 from the same bf16 inputs, so every sum and the GELU are exact to
about 1e-15, and bounds what a correct kernel may give instead: one whose
fp32 sums and fp32 GELU differ from the exact ones by no more than

  - a sum: the GEMM tile adds K in k-steps of 16, one ``mma.sync`` each: the
    16 exact bf16 x bf16 products and the accumulator, rounded (or
    truncated) once to fp32's 24 bits. A step's error is below 2^-23 of its
    result, whose magnitude is at most |C_{s-1}| + the step's sum of
    |products| (C_s the exact partial sum after step s). So

        |sum - exact| <= E = SUM_UNIT * (sum over steps of |C_{s-1}| + S),

    S the sum of |products|, SUM_UNIT = 2^-23 (``sum_error_bound``);
  - the GELU: the fp32 formula's own roundings, bounded in
    ``gelu_error_bound``.

Every rounding is monotone, so each bound is carried through them as an
interval (``through_roundings``):

    h_lo, h_hi = T(T(p1 -+ E1) + b1)           dh = max |h_lo,hi - h|
    a_lo, a_hi = T(g -+ (GELU_SLOPE dh + Eg))  da = max |a_lo,hi - a|
    D          = sum_j da_j |w2_jk| + E2
    y_lo, y_hi = T(T(q -+ D) + b2)

and a correct kernel's y lies in [y_lo, y_hi]. Nothing else moves an
output: where q lies farther than D from a rounding midpoint of T(q), the
kernel's output equals the exact one bit for bit. Where it lies closer,
T(q) may land one step of q's binade away, which the bias add and the
second rounding (ties to even) can make two steps of y's binade. The
hidden term D counts the hidden elements that may round one step apart
(their p1 within E1 of a midpoint), each through its W2 weight.

``check_forward`` holds an output to the bar and reports, beside it, the
numbers the bar replaces: the aggregate max |out - ref| / max(1, max |ref|)
of the former bar (2^-7 against the plain version), the share of elements
not bit-equal to the reference and the worst element in bf16 steps of its
own binade. Two controls must fail the bar: ``bf16_sum_forward`` (the same
function with its K sums kept in bf16, rounded every k-step of 16) and
``moved_three_steps`` (one output element three steps off).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .fused_mlp import kernel_gelu

SUM_UNIT = 2.0 ** -23        # a k-step's rounding, relative to its result's magnitude
K_STEP = 16                  # k of one mma.sync.m16n8k16
# |gelu'| <= 1.1289 (the exact GELU and its tanh form; the polynomial's erf is
# 1.5e-7 from erf)
GELU_SLOPE = 1.13
# the old bar's numbers, printed beside the new one: the JAX package holds
# its bf16 Pallas forward to this (tests/test_fused_mlp.py)
JAX_BF16_ATOL = 3e-2


class Bar(NamedTuple):
    """The exact output and the interval a correct kernel's output lies in,
    as bf16 values (float32 tensors of the output's shape)."""
    ref: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def round_bf16(v: torch.Tensor) -> torch.Tensor:
    """float64 values rounded to bfloat16 (8 significant bits, to nearest,
    ties to even), in float64; exact for the normal range."""
    m, e = torch.frexp(v)                          # v = m 2^e, 0.5 <= |m| < 1
    return torch.ldexp(torch.round(m * 256.0), e - 8)


def bf16_step(v: torch.Tensor) -> torch.Tensor:
    """The bf16 grid spacing of the binade v lies in: 2^(e - 8) for |v| in
    [2^(e-1), 2^e); that of the smallest normal for 0."""
    v = v.double()
    _, e = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), torch.where(v == 0, -133, e - 8))


def gelu_error_bound(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Bound of |fp32 GELU - exact GELU| at h (g the exact value), u = 2^-24.
    erf branch 0.5 h (1 + erf_poly(h / sqrt 2)): the argument's rounding moves
    erf by <= 1.13 u |h| / sqrt 2; t = 1 / (1 + p |z|), the degree-5
    polynomial and expf(-z^2) (z^2's rounding enters the exponent) give
    e = t P(t) exp(-z^2) <= 1 to (30 + h^2) u; 1 - e and 1 + erf one u each;
    0.5 h (.) 2 u of |g|: together 0.5 |h| (0.8 |h| + 32 + h^2) u + 2 u |g|.
    tanh branch: the cubic's argument to 4 u of itself, tanhf 2 u, 1 + t one u:
    0.5 |h| (3.2 |h| + 0.15 |h|^3 + 4) u + 2 u |g|. Both below
    u (|h| (17 + h^2 (1 + |h| / 8)) + 2 |g|); doubled for contracted fmas."""
    a = h.abs()
    return 2.0 ** -23 * (a * (17.0 + h * h * (1.0 + a / 8.0)) + 2.0 * g.abs())


def sum_error_bound(a: torch.Tensor, b: torch.Tensor, a_abs: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """E [r, n] bounding |the tile's fp32 sum - the exact sum| of a [r, K] @
    b [K, n] (float64): SUM_UNIT times the sum over k-steps of 16 of
    |C_{s-1}| (the exact partial sums) plus S = |a| @ |b| (``a_abs`` in place
    of |a| where the caller widens it)."""
    r, k = a.shape
    s = (a.abs() if a_abs is None else a_abs) @ b.abs()
    pad = -k % K_STEP
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    steps = a.shape[1] // K_STEP
    parts = torch.bmm(a.reshape(r, steps, K_STEP).transpose(0, 1),
                      b.reshape(steps, K_STEP, b.shape[1]))             # [steps, r, n]
    partial = parts.cumsum_(0)[:-1].abs_().sum(0)
    return SUM_UNIT * (partial + s)


def through_roundings(v: torch.Tensor, err: torch.Tensor, bias: torch.Tensor):
    """(T(T(v) + bias), T(T(v - err) + bias), T(T(v + err) + bias)): the
    exact value's two roundings and those of the ends of v's interval."""
    def both(u):
        return round_bf16(round_bf16(u) + bias)
    return both(v), both(v - err), both(v + err)


def _rows_at_once(k: int, n: int, budget: int) -> int:
    return max(1, budget // (max(1, math.ceil(k / K_STEP)) * n))


def forward_bar(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor, approximate: bool = False, *,
                budget: int = 2 ** 24) -> Bar:
    """The bar of ``fused_mlp(x, w1, b1, w2, b2, approximate)`` in bf16 (w1,
    w2 hidden-major [H, D]), on x's device, in row chunks whose float64
    k-step sums hold about ``budget`` elements."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    w1d, w2d = w1.double(), w2.double()
    b1d, b2d = b1.double(), b2.double()
    h_dim = w1.shape[0]
    ref = torch.empty(x2.shape, dtype=torch.float32, device=x.device)
    lo, hi = torch.empty_like(ref), torch.empty_like(ref)
    rows = min(_rows_at_once(d, h_dim, budget), _rows_at_once(h_dim, d, budget))
    for r0 in range(0, x2.shape[0], rows):
        xs = x2[r0:r0 + rows].double()
        p1 = xs @ w1d.T
        h, h_lo, h_hi = through_roundings(p1, sum_error_bound(xs, w1d.T), b1d)
        dh = torch.maximum(h_hi - h, h - h_lo)
        g = kernel_gelu(h, approximate)                 # float64
        a = round_bf16(g)
        g_err = GELU_SLOPE * dh + gelu_error_bound(h, g)
        da = torch.maximum(round_bf16(g + g_err) - a, a - round_bf16(g - g_err))
        q = a @ w2d
        hidden = da @ w2d.abs()
        steps = math.ceil(h_dim / K_STEP)
        # the sums of the kernel's a: |a| widened by da, partial sums moved by
        # at most `hidden` a step
        err = hidden + sum_error_bound(a, w2d, a.abs() + da) + SUM_UNIT * steps * hidden
        y, y_lo, y_hi = through_roundings(q, err, b2d)
        ref[r0:r0 + rows], lo[r0:r0 + rows], hi[r0:r0 + rows] = y, y_lo, y_hi
    shape = x.shape
    return Bar(ref.view(shape), lo.view(shape), hi.view(shape))


def check_forward(out: torch.Tensor, bar: Bar) -> dict:
    """``out`` (the forward's bf16 output) against ``bar``: ``ok`` (every
    element finite and in [lo, hi]), ``outside`` (how many are not), and
    printed only: ``max_allowance`` (the largest of hi - ref, ref - lo) and
    ``over_jax_atol`` (allowances above 3e-2), ``worst_steps`` (the largest
    |out - ref| in bf16 steps of the larger one's binade), ``not_equal``
    (the share of elements not bit-equal to ref), ``old_aggregate`` (max
    |out - ref| / max(1, max |ref|), the former bar's measure)."""
    got = out.float().reshape(bar.ref.shape)
    off = (got - bar.ref).abs()
    outside = int((~((got >= bar.lo) & (got <= bar.hi))).sum())      # NaN is outside
    allowance = torch.maximum(bar.hi - bar.ref, bar.ref - bar.lo)
    return {"ok": outside == 0,
            "outside": outside,
            "max_allowance": allowance.max().item(),
            "over_jax_atol": int((allowance > JAX_BF16_ATOL).sum()),
            "worst_steps": (off.double() / bf16_step(torch.maximum(got.abs(), bar.ref.abs()))
                            ).max().item(),
            "not_equal": (off > 0).float().mean().item(),
            "old_aggregate": (off.max() / bar.ref.abs().max().clamp_min(1.0)).item()}


def describe(report: dict) -> str:
    """One line of a ``check_forward`` report."""
    return (f"{'inside' if report['ok'] else 'OUTSIDE'} the per-element bar "
            f"({report['outside']} elements outside; largest allowance "
            f"{report['max_allowance']:.5g}, "
            f"{report['over_jax_atol']} above {JAX_BF16_ATOL}); worst element "
            f"{report['worst_steps']:.3g} bf16 steps from the exact value, "
            f"{report['not_equal']:.3g} of the elements not bit-equal to it; "
            f"max_abs_err / max(1, max|ref|) {report['old_aggregate']:.5g}")


def _bf16_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [r, K] @ b [K, n] in fp32 k-steps of 16, the running sum rounded to
    bf16 after each."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[1], K_STEP):
        acc = (acc + a[:, k0:k0 + K_STEP].float() @ b[k0:k0 + K_STEP].float()).bfloat16().float()
    return acc


def bf16_sum_forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """Control (i): the forward with its K sums kept in bf16 (rounded every
    k-step of 16), every other rounding as the function's. It must fail the
    bar."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    h = (_bf16_sums(x2, w1.T).bfloat16() + b1).float()
    a = kernel_gelu(h, approximate).bfloat16()
    return (_bf16_sums(a, w2).bfloat16() + b2).reshape(x.shape)


def moved_three_steps(out: torch.Tensor, bar: Bar) -> torch.Tensor:
    """Control (ii): ``out`` with its element of the largest |ref| moved three
    bf16 steps of its binade toward zero (onto the grid below). It must fail
    the bar."""
    moved = out.clone().reshape(-1)
    ref = bar.ref.reshape(-1)
    i = int(ref.abs().argmax())
    v = ref[i].double()
    moved[i] = (v - torch.sign(v) * 3 * bf16_step(v)).to(moved.dtype)
    return moved.reshape(out.shape)
