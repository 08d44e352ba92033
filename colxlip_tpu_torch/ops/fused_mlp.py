"""Fused transformer MLP: c_fc -> GELU -> c_proj in one kernel with a
recompute backward; no [B, N, H] tensor in device memory, forward or backward.

Port of ``colxlip_tpu/ops/fused_mlp.py`` (``fused_mlp``; the TPU kernels are
``_fwd_call`` and ``_bwd_call``). With T the compute dtype and every product
summed in fp32:

    h   = T(T(x @ w1.T) + b1);  a = T(gelu_fp32(h));  out = T(T(a @ w2) + b2)
    da  = dy @ w2.T (fp32);  dh = T(gelu'(h) * da);  dx = T(dh @ w1)
    dw1 = dh.T @ x,  db1 = sum_rows dh,  dw2 = a.T @ dy,  db2 = sum_rows dy

h, a and gelu'(h) are recomputed from x in the backward; the four weight
gradients are summed in fp32. The exact GELU is the TPU kernel's: the
Abramowitz-Stegun 7.1.26 erf polynomial (1.5e-7 from erf), not ``erf``; the
tanh branch is the closed form (``kernel_gelu``, ``kernel_gelu_and_grad``).

**Weight layout.** Both weights are hidden-major: ``w1`` is [H, D], the
``c_fc.weight`` of the port's ``Linear`` as it is (the JAX kernel's W1
transposed), and ``w2`` is [H, D], the JAX kernel's W2 as it is
(``c_proj.weight`` transposed). ``models.layers.MLP`` makes that one
transpose, with the cast to the compute dtype, outside the
``autograd.Function``, so the gradients pass back through both. ``dw1`` and
``dw2`` come back in the same layout.

Two C entry points (``csrc/fused_mlp.cu``: forward; backward, counted as one
launch each however many CUDA launches sit behind them), each beside a plain
PyTorch version that walks the rows in chunks, so it too runs at batch 256
(its hidden chunk is [chunk, H]). bfloat16 runs every product on the tensor
cores through one hand-written ``mma.sync`` GEMM tile (``csrc/mlp_gemm.cuh``)
over the rows in chunks of ``chunk_rows(H)``, whose [chunk, H] hidden tiles
(one forward, two backward) stay in the card's L2: that workspace is the
design's whole memory cost (24.0 MiB forward, 25.0 backward at the vision
shape). The tile sums K in its own order, so its bf16 forward is held to the
exact function by a per-element bar derived from the roundings
(``ops/fused_mlp_check.py``), not to the plain version's sgemm order.
float32 runs on the CUDA cores, any D: both directions are the bf16
schedule on an fp32 GEMM tile (``csrc/sgemm_tile.cuh``), the function's own
4 and 10 R D H. The forward goes over near-equal chunks of at most
``fp32_fwd_chunk_rows(H)`` rows (``fp32_fwd_plan``), whose one fp32
[chunk, H] tile stays in L2; the backward over chunks of
``fp32_chunk_rows(H)`` rows, whose two tiles do. Their kNN products (a W2,
dh W1) are cut into K slices where the chunk's tiles would leave the card
half idle (``fp32_k_splits``; more in a short chunk: ``fp32_chunk_splits``),
added in slice order with b2 after the whole sum.
CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. There is no fallback.

``COLXLIP_MLP_IMPL`` (``fused`` or ``xla``, default ``xla``) chooses the path
in ``models.layers.MLP`` through ``resolve_mlp_impl``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .build import LaunchCounter, load_kernels, multiprocessors
from .fused_ln import resolve_impl

# kernel launches (plain-version calls do not count), one count per kernel
FWD_LAUNCHES = LaunchCounter()
BWD_LAUNCHES = LaunchCounter()
PLAIN_CHUNK = 4096
_COLSUM_BLOCKS = 264             # partial rows of db2: two blocks a multiprocessor
GEMM_ROWS = 128                  # csrc/mlp_gemm.cuh kBM: rows of a C tile
DB1_ROWS = 64                    # rows a warp sums into one row of db1 partials
# bfloat16: a call's [chunk, H] bf16 tiles (two backward, one forward) fit in this much of the
# H100's 50 MB L2, beside the weights and their fp32 gradients
L2_WORKSPACE_BYTES = 24 * 2**20
# float32 (csrc/sgemm_tile.cuh): a chunk's [chunk, H] fp32 tiles (two backward) fit in this much
# of L2
FP32_L2_WORKSPACE_BYTES = 32 * 2**20
SGEMM_ROWS = 128                 # kBM = kBN: rows and columns of a C tile
SGEMM_K_STEP = 16                # kBK: k a stage
FP32_DB1_ROWS = 32               # rows a warp sums into one row of db1 partials (kWM)
FP32_MAX_DX_SPLITS = 4           # K slices of a kNN product (a W2, dh W1) at most
_BLOCKS_PER_SM = 2               # the tile's __launch_bounds__
_MAX_CHUNK_SPLITS = 32           # stream_tile.cuh kRedGroups: slices reduce_partials adds in order
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_SQRT1_2 = 0.7071067811865476
_SQRT_2_OVER_PI = 0.7978845608028654
_INV_SQRT_2PI = 0.3989422804014327


def resolve_mlp_impl(impl: str = "auto") -> str:
    """'auto' -> ``COLXLIP_MLP_IMPL`` or 'xla' (the library path); an
    explicit 'fused' / 'xla' beats the environment; anything else raises."""
    return resolve_impl(impl, "COLXLIP_MLP_IMPL")


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 in fp32, |error| <= 1.5e-7."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
           + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def kernel_gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """The kernels' GELU value in fp32 (float64 for a float64 x)."""
    return kernel_gelu_and_grad(x, approximate)[0]


def kernel_gelu_and_grad(x: torch.Tensor, approximate: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, d/dx) in fp32 (float64 for a float64 x: the forward's check):
    the exact derivatives of the kernels' formulas."""
    x32 = x if x.dtype == torch.float64 else x.float()
    if approximate:
        t = torch.tanh(_SQRT_2_OVER_PI * (x32 + 0.044715 * x32 * x32 * x32))
        du = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * x32 * x32)
        return 0.5 * x32 * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * x32 * (1.0 - t * t) * du
    cdf = 0.5 * (1.0 + erf_poly(x32 * _SQRT1_2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * x32 * x32)
    return x32 * cdf, cdf + x32 * pdf


def _check_args(x, w1, b1, w2, b2=None) -> Tuple[int, int, int]:
    """(rows, D, H) of a call; ``b2`` is None in the backward."""
    if x.ndim < 2 or w1.ndim != 2 or w1.shape[1] != x.shape[-1] or 0 in x.shape + w1.shape:
        raise ValueError("fused_mlp needs x [..., D] and w1 [H, D]; got "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    h, d = w1.shape
    rest = (w1, b1, w2) if b2 is None else (w1, b1, w2, b2)
    if w2.shape != (h, d) or b1.shape != (h,) or (b2 is not None and b2.shape != (d,)):
        raise ValueError(f"fused_mlp: w2 must be [{h}, {d}] (hidden-major), b1 [{h}], b2 "
                         f"[{d}]; got {[tuple(t.shape) for t in rest[1:]]}")
    if any(t.dtype != x.dtype for t in rest):
        raise ValueError("fused_mlp: x, w1, b1, w2 and b2 must share the compute dtype; got "
                         f"{[str(t.dtype) for t in (x, *rest)]}")
    return x.numel() // d, d, h


def _hidden(x2: torch.Tensor, w1f: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """The pre-activation in the compute dtype: the product rounded first,
    the bias added in that dtype."""
    return torch.matmul(x2.float(), w1f.T).to(x2.dtype) + b1


def fused_mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, approximate: bool = False, *,
                    chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain PyTorch forward with the kernel's arithmetic, ``chunk`` rows at
    a time."""
    _, d, _ = _check_args(x, w1, b1, w2, b2)
    x2 = x.reshape(-1, d)
    out = torch.empty_like(x2)
    w1f, w2f = w1.float(), w2.float()
    for r0 in range(0, x2.shape[0], chunk):
        h = _hidden(x2[r0:r0 + chunk], w1f, b1)
        a = kernel_gelu(h, approximate).to(x.dtype)
        out[r0:r0 + chunk] = torch.matmul(a.float(), w2f).to(x.dtype) + b2
    return out.reshape(x.shape)


def fused_mlp_bwd_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        dy: torch.Tensor, approximate: bool = False, *,
                        chunk: int = PLAIN_CHUNK):
    """Plain PyTorch backward: (dx in x's dtype, dw1 [H, D], db1 [H], dw2
    [H, D], db2 [D], the four in fp32), h recomputed from x chunk by chunk."""
    h_dim, d = w1.shape
    x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
    dx = torch.empty_like(x2)
    w1f, w2f = w1.float(), w2.float()
    dw1 = torch.zeros((h_dim, d), dtype=torch.float32, device=x.device)
    dw2 = torch.zeros_like(dw1)
    db1 = torch.zeros(h_dim, dtype=torch.float32, device=x.device)
    db2 = torch.zeros(d, dtype=torch.float32, device=x.device)
    for r0 in range(0, x2.shape[0], chunk):
        xs, do = x2[r0:r0 + chunk].float(), dy2[r0:r0 + chunk].float()
        a32, g32 = kernel_gelu_and_grad(_hidden(x2[r0:r0 + chunk], w1f, b1), approximate)
        dw2 += torch.matmul(a32.to(x.dtype).float().T, do)
        db2 += do.sum(dim=0)
        dh = (g32 * torch.matmul(do, w2f.T)).to(x.dtype).float()
        dw1 += torch.matmul(dh.T, xs)
        db1 += dh.sum(dim=0)
        dx[r0:r0 + chunk] = torch.matmul(dh, w1f).to(x.dtype)
    return dx.reshape(x.shape), dw1, db1, dw2, db2


def chunk_rows(h: int, backward: bool = True) -> int:
    """Rows of one bfloat16 chunk: a multiple of 128 such that its [chunk, H]
    bf16 tiles, two backward (h then a, and dh) and one forward, fit in
    L2_WORKSPACE_BYTES (backward 2048 at H = 3072, 3072 at 2048, 1536 at
    4096; forward twice as many). More rows a chunk, more tiles a launch: the
    forward's products fill the card's waves better at 4096 than at 2048."""
    tiles = 2 if backward else 1
    return max(GEMM_ROWS, L2_WORKSPACE_BYTES // (tiles * 2 * h) // GEMM_ROWS * GEMM_ROWS)


def fp32_chunk_rows(h: int) -> int:
    """Rows of one float32 backward chunk: a multiple of 128 such that its
    two fp32 [chunk, H] tiles (h then a, and dh) fit in
    FP32_L2_WORKSPACE_BYTES (1024 at H = 4096, 1280 at 3072, 2048 at 2048)."""
    return max(SGEMM_ROWS, FP32_L2_WORKSPACE_BYTES // (2 * 4 * h) // SGEMM_ROWS * SGEMM_ROWS)


def fp32_fwd_chunk_rows(h: int) -> int:
    """Most rows of one float32 forward chunk: a multiple of 128 such that
    its one fp32 [chunk, H] tile (a) fits in FP32_L2_WORKSPACE_BYTES, twice
    the backward's rows (2048 at H = 4096, 2688 at 3072)."""
    return max(SGEMM_ROWS, FP32_L2_WORKSPACE_BYTES // (4 * h) // SGEMM_ROWS * SGEMM_ROWS)


def fp32_fwd_plan(rows: int, h: int, chunk: int = 0) -> Tuple[int, int]:
    """(chunks, cap) of a float32 forward, as ``csrc/fused_mlp.cu``
    ``fp32_fwd`` cuts the rows: the fewest chunks of whole 128-row tiles that
    keep each within ``chunk`` rows (``fp32_fwd_chunk_rows(h)`` by default),
    near-equal (chunk c is tiles [c T / n, (c + 1) T / n) of the T tiles);
    ``cap`` is the longest, which sizes the workspace. ViT-L's 4,112 rows at
    H = 4096: three chunks of 11 tiles (1408, 1408, 1296 rows)."""
    tiles = -(-rows // SGEMM_ROWS)
    per = (chunk or fp32_fwd_chunk_rows(h)) // SGEMM_ROWS
    chunks = -(-tiles // per)
    return chunks, min(rows, -(-tiles // chunks) * SGEMM_ROWS)


def fp32_k_splits(cap: int, d: int, h: int, sms: int) -> int:
    """K slices of a float32 kNN product (K = H: the forward's a W2, the
    backward's dh W1) over a chunk of ``cap`` rows: enough that its
    [cap, D] tiles times the slices fill two blocks a multiprocessor, at
    most FP32_MAX_DX_SPLITS, each slice whole k-steps of 16 and none empty
    (the kernel cuts K into ceil(steps / splits) steps a slice)."""
    tiles = -(-cap // SGEMM_ROWS) * -(-d // SGEMM_ROWS)
    want = max(1, min(FP32_MAX_DX_SPLITS, _BLOCKS_PER_SM * sms // tiles))
    steps = -(-h // SGEMM_K_STEP)
    return -(-steps // -(-steps // want))


def fp32_dx_splits(rows: int, d: int, h: int, sms: int) -> int:
    """``fp32_k_splits`` of the float32 backward's dh W1: ``rows`` is the
    call's row count, its chunk the smaller of it and
    ``fp32_chunk_rows(h)``."""
    return fp32_k_splits(min(rows, fp32_chunk_rows(h)), d, h, sms)


def fp32_chunk_splits(rc: int, cap: int, d: int, h: int, splits: int, sms: int) -> int:
    """K slices of one chunk's dh W1 (``rc`` rows), as ``csrc/fused_mlp.cu``
    ``chunk_splits`` takes them: ``splits`` (``fp32_dx_splits``, sized for
    a chunk of ``cap`` rows) unless the chunk is short, whose dx tiles then
    take more slices, as many as fill two blocks a multiprocessor, within
    the scratch (``splits`` slices of ``cap`` rows), one k-step a slice and
    32 slices at most, none empty."""
    if splits <= 1:
        return 1
    tiles = -(-rc // SGEMM_ROWS) * -(-d // SGEMM_ROWS)
    steps = -(-h // SGEMM_K_STEP)
    want = splits
    if tiles * splits < _BLOCKS_PER_SM * sms:
        want = max(splits, min(-(-(_BLOCKS_PER_SM * sms) // tiles), splits * cap // rc, steps,
                               _MAX_CHUNK_SPLITS))
    return -(-steps // -(-steps // want))


def _fp32_fwd_workspace(rows: int, d: int, h: int, sms: int, chunk: int = 0,
                        splits: int = 0) -> Tuple[int, int, int]:
    """(tile, partials, splits) elements of a float32 forward: the [cap, H]
    tile of a, and where a W2 is cut into K slices each slice's [cap, D].
    ``chunk`` and ``splits`` (0: the rules) stand in for ``fp32_fwd_plan``'s
    chunk and ``fp32_k_splits``."""
    cap = fp32_fwd_plan(rows, h, chunk)[1]
    splits = splits or fp32_k_splits(cap, d, h, sms)
    return cap * h, (splits * cap * d if splits > 1 else 0), splits


def _fp32_workspace(rows: int, d: int, h: int, sms: int) -> Tuple[int, int]:
    """(tile, sum) fp32 elements a float32 backward allocates beside its
    outputs: the two [min(rows, chunk), H] tiles; the db1 sums (one row a
    warp's 32 rows of a chunk), db2's partial rows and, where dh W1 is cut
    into K slices, each slice's [min(rows, chunk), D]."""
    cap = min(rows, fp32_chunk_rows(h))
    splits = fp32_dx_splits(rows, d, h, sms)
    sums = (-(-cap // SGEMM_ROWS) * (SGEMM_ROWS // FP32_DB1_ROWS) * h
            + min(rows, _COLSUM_BLOCKS) * d + (splits * cap * d if splits > 1 else 0))
    return 2 * cap * h, sums


def _bf16_workspace(rows: int, d: int, h: int, backward: bool) -> Tuple[int, int]:
    """(bf16, fp32) elements a bfloat16 call allocates beside its outputs: the
    [min(rows, chunk), H] hidden tiles (one forward, two backward) and,
    backward, the partial sums of db1 (one row a warp's 64 rows of a chunk)
    and db2."""
    chunk = chunk_rows(h, backward)
    if not backward:
        return min(rows, chunk) * h, 0                # the chunk's a
    return (2 * min(rows, chunk) * h,
            chunk // DB1_ROWS * h + min(rows, _COLSUM_BLOCKS) * d)


def workspace_bytes(rows: int, d: int, h: int, backward: bool,
                    dtype: torch.dtype = torch.bfloat16, sms: int = 132) -> int:
    """Device memory a call allocates beside its outputs."""
    if dtype == torch.float32:
        if backward:
            return 4 * sum(_fp32_workspace(rows, d, h, sms))
        return 4 * sum(_fp32_fwd_workspace(rows, d, h, sms)[:2])
    tiles, sums = _bf16_workspace(rows, d, h, backward)
    return 2 * tiles + 4 * sums


def _check_cuda(name: str, x, w1, b1, w2, b2=None, dy=None) -> Tuple[int, int, int]:
    rows, d, h = _check_args(x, w1, b1, w2, b2)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dtype == torch.bfloat16 and (d % 8 or h % 8):
        raise ValueError(f"{name}: bfloat16 needs D and H multiples of 8 (16-byte rows for "
                         f"the tensor-core tiles); got D={d}, H={h}")
    for label, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2), ("dy", dy)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous on {x.device}; got "
                             f"{t.device}, contiguous={t.is_contiguous()}")
        # the tiles' operands go by 16-byte cp.async (the biases are read by element)
        if x.dtype == torch.bfloat16 and label in ("x", "w1", "w2", "dy") and t.data_ptr() % 16:
            raise ValueError(f"{name}: bfloat16 {label} must start on 16 bytes (cp.async)")
    return rows, d, h


def _launch_fwd(x, w1, b1, w2, b2, approximate: bool,
                fp32_plan: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The forward kernel on CUDA tensors (checks, never falls back).
    ``fp32_plan``, (chunk rows, K slices), stands in for the float32 rules
    where it is not 0 (``scripts/torch_mlp_bench.py --fp32-plans``)."""
    rows, d, h = _check_cuda("fused_mlp", x, w1, b1, w2, b2)
    kernels = load_kernels()
    out = torch.empty_like(x)
    scratch, splits = None, 1
    if x.dtype == torch.bfloat16:
        chunk = chunk_rows(h, backward=False)
        ws = torch.empty(_bf16_workspace(rows, d, h, False)[0], dtype=x.dtype, device=x.device)
    else:
        chunk = fp32_plan[0] or fp32_fwd_chunk_rows(h)
        tile, partials, splits = _fp32_fwd_workspace(
            rows, d, h, multiprocessors(x.device.index), chunk, fp32_plan[1])
        ws = torch.empty(tile, dtype=x.dtype, device=x.device)
        if partials:
            scratch = torch.empty(partials, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = kernels.colxlip_fused_mlp_fwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), ws.data_ptr(), None if scratch is None else scratch.data_ptr(), rows, d,
        h, int(approximate), chunk, splits, _DTYPE_CODES[x.dtype], stream)
    kernels.check(err, "colxlip_fused_mlp_fwd")
    FWD_LAUNCHES.add()
    return out


def _launch_bwd(x, w1, b1, w2, dy, approximate: bool):
    """The backward kernels on CUDA tensors: (dx, dw1, db1, dw2, db2), the
    last four fp32."""
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"fused_mlp backward: dy must be {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}; got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous()
    rows, d, h = _check_cuda("fused_mlp backward", x, w1, b1, w2, dy=dy)
    kernels = load_kernels()
    dev = x.device
    dx = torch.empty_like(x)
    dw1 = torch.empty((h, d), dtype=torch.float32, device=dev)
    dw2 = torch.empty_like(dw1)
    db1 = torch.empty(h, dtype=torch.float32, device=dev)
    db2 = torch.empty(d, dtype=torch.float32, device=dev)
    colsum_blocks = min(rows, _COLSUM_BLOCKS)
    if x.dtype == torch.bfloat16:
        splits, chunk = 1, chunk_rows(h)
        tiles, sums = _bf16_workspace(rows, d, h, True)
    else:
        sms = multiprocessors(dev.index)
        splits, chunk = fp32_dx_splits(rows, d, h, sms), fp32_chunk_rows(h)
        tiles, sums = _fp32_workspace(rows, d, h, sms)
    ws = torch.empty(tiles, dtype=x.dtype, device=dev)
    scratch = torch.empty(sums, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.colxlip_fused_mlp_bwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
        scratch.data_ptr(), ws.data_ptr(), rows, d, h, int(approximate), splits,
        colsum_blocks, chunk, _DTYPE_CODES[x.dtype], stream)
    kernels.check(err, "colxlip_fused_mlp_bwd")
    BWD_LAUNCHES.add()
    return dx, dw1, db1, dw2, db2


def _on_cpu(*tensors: torch.Tensor) -> bool:
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda") or any(t.device != tensors[0].device for t in tensors):
        raise ValueError("fused_mlp: unsupported devices "
                         f"{[str(t.device) for t in tensors]} (the CPU or one CUDA device)")
    return kind == "cpu"


def _forward(x, w1, b1, w2, b2, approximate):
    if _on_cpu(x, w1, b1, w2, b2):
        return fused_mlp_plain(x, w1, b1, w2, b2, approximate)
    return _launch_fwd(x, w1, b1, w2, b2, approximate)


class _FusedMLP(torch.autograd.Function):
    """Saves x, w1, b1 and w2; the backward recomputes h, a and gelu'(h)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, approximate):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.approximate, ctx.b2_dtype = approximate, b2.dtype
        return _forward(x, w1, b1, w2, b2, approximate)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        if _on_cpu(x, w1, b1, w2, dy):
            grads = fused_mlp_bwd_plain(x, w1, b1, w2, dy, ctx.approximate)
        else:
            grads = _launch_bwd(x, w1, b1, w2, dy, ctx.approximate)
        dx, dw1, db1, dw2, db2 = grads
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), None)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """gelu-MLP over x [..., D]: ``gelu(x @ w1.T + b1) @ w2 + b2`` with the
    roundings above. w1 [H, D] and w2 [H, D] are hidden-major (see the module
    docstring), b1 [H], b2 [D], all in x's dtype (the compute dtype);
    differentiable in all five.

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (contiguous; bfloat16 with D and H multiples of 8, float32 any D) or
    raise."""
    _check_args(x, w1, b1, w2, b2)
    x = x.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _FusedMLP.apply(x, w1, b1, w2, b2, approximate)
    return _forward(x, w1, b1, w2, b2, approximate)
