"""Streaming contrastive cross-entropy: mean over rows of
``CE(scale * a @ b.T, labels)`` without the [M, N] logit matrix.

Port of ``colxlip_tpu/ops/fused_ce.py`` (``fused_contrastive_ce``; the TPU
kernels are ``_fwd_call``, and ``_bwd_call`` with its ``_bwd_da_kernel`` and
``_bwd_db_kernel`` bodies):

    loss_i   = logsumexp_j(scale * <a_i, b_j>) - scale * <a_i, b_label_i>
    dz_ij    = (exp(scale * <a_i, b_j> - lse_i) - [j == label_i]) * g_i
    dA       = scale * dz @ B,  dB = scale * dz^T @ A   (fp32)
    dscale   = sum_ij dz_ij * <a_i, b_j>

Three kernels (``csrc/fused_ce.cu``: forward, dA with the per-row dscale,
dB; in bf16 all three run on the tensor cores through one logit tile, the
backward with dz split into two bf16 halves), each beside a plain PyTorch
version that walks the columns in chunks with the same online max / sum
recurrence and an explicit backward, so its memory is O((M + N) D + M chunk)
and it runs at M = N = 32768 as the oracle. In float32 each kernel also
splits the streamed rows where its row blocks alone would leave the card
idle: the forward b's rows into ``fp32_fwd_slices`` slices (M = 256,
N = 1024: 4 blocks, 16 slices), each slice's (max, sum, label logit) merged
in slice order by a second pass; dA b's rows into ``fp32_da_slices`` (8
blocks, 16 slices) and dB a's rows into ``fp32_db_slices`` (32 blocks, 4
slices), each slice's partial rows added in slice order by a second pass.
Both dtypes take any D: past 768 features the bf16 kernels stream the
features through the logit tile in chunks of 256 and write dA and dB in
feature slices of at most 768, each slice recomputing the logits.
CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. There is no fallback.

``logit_scale`` stays a tensor on the tensors' device all the way into the
kernels (they read it from device memory), so the loss costs no host sync.
Labels are not checked against N on the card (that would be one): a label
outside [0, N) matches no column, and its row's loss is its logsumexp.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .build import LaunchCounter, load_kernels, multiprocessors

# kernel launches (plain-version calls do not count), one count per kernel
FWD_LAUNCHES = LaunchCounter()
BWD_DA_LAUNCHES = LaunchCounter()
BWD_DB_LAUNCHES = LaunchCounter()
PLAIN_CHUNK = 1024
FP32_OWN_ROWS = 32               # stream_tile.cuh kOwn: rows a float32 dA or dB block owns
FP32_FWD_ROWS = 64               # fused_ce.cu kFwdRows: rows of a a float32 forward block owns
FP32_STREAM_ROWS = 64            # kStream: rows of the streamed matrix a tile, a slice's unit
FP32_MAX_DA_SLICES = 32          # kRedGroups: slices reduce_partials adds in order
FP32_DA_SCRATCH_BYTES = 32 * 2**20   # a split's partials at most (each of the three kernels)
_BLOCKS_PER_SM = 2
_NEG = -1e30     # the running max starts here, not at -inf: exp(-inf - -inf) is NaN
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(a: torch.Tensor, b: torch.Tensor, labels: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1] or 0 in a.shape + b.shape:
        raise ValueError("fused_contrastive_ce needs a [M, D] and b [N, D]; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if labels.shape != (a.shape[0],) or labels.dtype.is_floating_point:
        raise ValueError(f"fused_contrastive_ce: labels must be [{a.shape[0]}] integers; "
                         f"got {labels.dtype} {tuple(labels.shape)}")


def _raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a_i, b_j> accumulated in fp32 from the input dtype."""
    return torch.matmul(a.float(), b.float().T)


def fused_ce_fwd_plain(a: torch.Tensor, b: torch.Tensor, labels: torch.Tensor,
                       scale: torch.Tensor, *, chunk: int = PLAIN_CHUNK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward: (loss rows [M], lse [M]) in fp32, ``chunk``
    columns at a time with the kernel's online max / sum recurrence."""
    m, n = a.shape[0], b.shape[0]
    scale = scale.float()
    labels = labels.long()
    mx = torch.full((m,), _NEG, dtype=torch.float32, device=a.device)
    total = torch.zeros_like(mx)
    label_logit = torch.zeros_like(mx)
    for j0 in range(0, n, chunk):
        z = scale * _raw(a, b[j0:j0 + chunk])
        new = torch.maximum(mx, z.amax(dim=1))
        total = total * torch.exp(mx - new) + torch.exp(z - new[:, None]).sum(dim=1)
        mx = new
        here = (labels >= j0) & (labels < j0 + z.shape[1])
        picked = z.gather(1, (labels - j0).clamp(0, z.shape[1] - 1)[:, None])[:, 0]
        label_logit = label_logit + torch.where(here, picked, torch.zeros_like(picked))
    lse = mx + torch.log(total)
    return lse - label_logit, lse


def _dz_chunk(a, b_chunk, labels, scale, lse, g, j0):
    """(dz, raw) for columns j0 .. j0 + len(b_chunk) - 1, both [M, chunk] fp32."""
    raw = _raw(a, b_chunk)
    dz = torch.exp(scale * raw - lse[:, None])
    here = (labels >= j0) & (labels < j0 + raw.shape[1])
    rows = torch.nonzero(here)[:, 0]
    dz[rows, labels[rows] - j0] -= 1.0
    return dz * g[:, None], raw


def fused_ce_bwd_da_plain(a: torch.Tensor, b: torch.Tensor, labels: torch.Tensor,
                          scale: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                          chunk: int = PLAIN_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch dA kernel: (dA [M, D], per-row dscale [M]) in fp32 for
    the loss-row cotangent ``g`` [M]."""
    scale, labels, g = scale.float(), labels.long(), g.float()
    da = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    dscale = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for j0 in range(0, b.shape[0], chunk):
        bj = b[j0:j0 + chunk]
        dz, raw = _dz_chunk(a, bj, labels, scale, lse, g, j0)
        da += torch.matmul(dz, bj.float())
        dscale += (dz * raw).sum(dim=1)
    return scale * da, dscale


def fused_ce_bwd_db_plain(a: torch.Tensor, b: torch.Tensor, labels: torch.Tensor,
                          scale: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                          chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """Plain PyTorch dB kernel: dB [N, D] in fp32."""
    scale, labels, g = scale.float(), labels.long(), g.float()
    db = torch.empty(b.shape, dtype=torch.float32, device=b.device)
    a32 = a.float()
    for j0 in range(0, b.shape[0], chunk):
        dz, _ = _dz_chunk(a, b[j0:j0 + chunk], labels, scale, lse, g, j0)
        db[j0:j0 + chunk] = torch.matmul(dz.T, a32)
    return scale * db


def fp32_da_slices(m: int, n: int, d: int, sms: int) -> int:
    """Slices of b's rows a float32 dA call is cut into (its grid.y): as
    many as bring its ceil(M / 32) row blocks to two blocks a multiprocessor,
    at most one 64-row tile of b a slice and FP32_MAX_DA_SLICES, within
    FP32_DA_SCRATCH_BYTES of partials (S M (D + 1) fp32), none empty (the
    kernel gives each slice ceil(tiles / S) tiles). 1 wherever the row
    blocks fill the card on their own (M > 32 x 132 on the H100): there the
    kernel is the unsplit walk. 16 at M = 256, N = 1024, D 512 (8 MiB)."""
    blocks = -(-m // FP32_OWN_ROWS)
    tiles = -(-n // FP32_STREAM_ROWS)
    return _slices(blocks, tiles, sms, 4 * m * (d + 1))


def fp32_fwd_slices(m: int, n: int, sms: int) -> int:
    """Slices of b's rows a float32 forward call is cut into (its grid.y),
    by fp32_da_slices' rule from its ceil(M / 64) row blocks, within
    FP32_DA_SCRATCH_BYTES of partials (3 S M fp32: max, sum, label logit).
    1 wherever the row blocks fill the card (M > 64 x 132 on the H100).
    16 at M = 256, N = 1024; 4 at 4096 x 4096."""
    return _slices(-(-m // FP32_FWD_ROWS), -(-n // FP32_STREAM_ROWS), sms, 12 * m)


def fp32_db_slices(m: int, n: int, d: int, sms: int) -> int:
    """Slices of a's rows a float32 dB call is cut into (its grid.y), by
    fp32_da_slices' rule from its ceil(N / 32) row blocks of b, within
    FP32_DA_SCRATCH_BYTES of partials (S N D fp32). 1 wherever the row
    blocks fill the card (N > 32 x 132 on the H100). 4 at M = 256,
    N = 1024; 2 at 4096 x 4096, D 512."""
    return _slices(-(-n // FP32_OWN_ROWS), -(-m // FP32_STREAM_ROWS), sms, 4 * n * d)


def _slices(blocks: int, tiles: int, sms: int, slice_bytes: int) -> int:
    """Slices of `tiles` streamed tiles that bring `blocks` row blocks to
    two blocks a multiprocessor: at most one tile a slice and
    FP32_MAX_DA_SLICES, their partials (slice_bytes each) within
    FP32_DA_SCRATCH_BYTES, none empty (the kernels give each slice
    ceil(tiles / S) tiles)."""
    want = min(_BLOCKS_PER_SM * sms // blocks, tiles, FP32_MAX_DA_SLICES,
               FP32_DA_SCRATCH_BYTES // slice_bytes)
    if want <= 1:
        return 1
    return -(-tiles // -(-tiles // want))


def _check_cuda(a, b, labels, scale, *more) -> Tuple[int, int, int]:
    dev = a.device
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_contrastive_ce: dtypes {a.dtype}/{b.dtype} not supported "
                         "(both float32 or both bfloat16)")
    d = a.shape[1]
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("fused_contrastive_ce: a and b must be contiguous")
    if labels.dtype != torch.int32 or not labels.is_contiguous():
        raise ValueError("fused_contrastive_ce: the kernels take contiguous int32 labels")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError("fused_contrastive_ce: logit_scale must be one float32 value")
    for name, t in (("b", b), ("labels", labels), ("logit_scale", scale), *more):
        if t.device != dev:
            raise ValueError(f"fused_contrastive_ce: {name} on {t.device}, a on {dev}; all "
                             "must be on one CUDA device (or all on the CPU)")
    return a.shape[0], b.shape[0], d


def _scratch(slices: int, elems: int, device) -> Tuple[Optional[torch.Tensor], Optional[int]]:
    """A split's scratch for its partials and the pointer to pass (both None
    without a split)."""
    if slices == 1:
        return None, None
    scratch = torch.empty(slices * elems, dtype=torch.float32, device=device)
    return scratch, scratch.data_ptr()


def _launch_fwd(a, b, labels, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors (checks, never falls back); the
    float32 call takes ``fp32_fwd_slices`` slices of b and scratch for their
    partials."""
    m, n, _ = _check_cuda(a, b, labels, scale)
    slices = 1
    if a.dtype == torch.bfloat16:
        a, b = mma_operands(a, b)
    else:
        slices = fp32_fwd_slices(m, n, multiprocessors(a.device.index))
    kernels = load_kernels()
    loss = torch.empty(m, dtype=torch.float32, device=a.device)
    lse = torch.empty_like(loss)
    scratch, scratch_ptr = _scratch(slices, 3 * m, a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = kernels.colxlip_fused_ce_fwd(
        a.data_ptr(), b.data_ptr(), labels.data_ptr(), scale.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), scratch_ptr, m, n, a.shape[1], slices, _DTYPE_CODES[a.dtype], stream)
    kernels.check(err, "colxlip_fused_ce_fwd")
    FWD_LAUNCHES.add()
    return loss, lse


def _check_bwd(a, lse, g) -> None:
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (a.shape[0],) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_contrastive_ce backward: {name} must be contiguous "
                             f"float32 [{a.shape[0]}]; got {t.dtype} {tuple(t.shape)}")


def mma_operands(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a and b as the bf16 kernels take them: rows of a multiple of
    8 features (zero-padded, which is exact for every product and costs
    O((M + N) D)) on 16-byte aligned bases (copied where they are not)."""
    pad = -a.shape[1] % 8
    if pad:
        return (torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, pad)))
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in (a, b))


def _launch_bwd(entry, a, b, labels, scale, lse, g, rows: int, with_dscale: bool):
    """One backward kernel on CUDA tensors: fp32 [rows, D] (and dscale rows
    fp32 [M] with the dA kernel). The float32 call takes ``fp32_da_slices``
    slices of b (dA) or ``fp32_db_slices`` slices of a (dB) and scratch for
    their partials."""
    m, n, d = _check_cuda(a, b, labels, scale, ("lse", lse), ("g", g))
    _check_bwd(a, lse, g)
    slices = 1
    if a.dtype == torch.bfloat16:
        a, b = mma_operands(a, b)
    else:
        sms = multiprocessors(a.device.index)
        slices = fp32_da_slices(m, n, d, sms) if with_dscale else fp32_db_slices(m, n, d, sms)
    width = a.shape[1]
    kernels = load_kernels()
    out = torch.empty((rows, width), dtype=torch.float32, device=a.device)
    outs = (out.data_ptr(),)
    if with_dscale:
        dscale = torch.empty(m, dtype=torch.float32, device=a.device)
        outs += (dscale.data_ptr(),)
    scratch, scratch_ptr = _scratch(slices, m * (width + 1) if with_dscale else n * width,
                                    a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = getattr(kernels, entry)(
        a.data_ptr(), b.data_ptr(), labels.data_ptr(), scale.data_ptr(), lse.data_ptr(),
        g.data_ptr(), *outs, scratch_ptr, m, n, width, slices, _DTYPE_CODES[a.dtype], stream)
    kernels.check(err, entry)
    out = out if width == d else out[:, :d].contiguous()
    return (out, dscale) if with_dscale else out


def _launch_bwd_da(a, b, labels, scale, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dA kernel on CUDA tensors: (dA fp32 [M, D], dscale rows fp32 [M])."""
    out = _launch_bwd("colxlip_fused_ce_bwd_da", a, b, labels, scale, lse, g, a.shape[0], True)
    BWD_DA_LAUNCHES.add()
    return out


def _launch_bwd_db(a, b, labels, scale, lse, g) -> torch.Tensor:
    """The dB kernel on CUDA tensors: dB fp32 [N, D]."""
    out = _launch_bwd("colxlip_fused_ce_bwd_db", a, b, labels, scale, lse, g, b.shape[0], False)
    BWD_DB_LAUNCHES.add()
    return out


def _on_cpu(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.device.type == "cpu" and b.device.type == "cpu":
        return True
    if a.device.type != "cuda":
        raise ValueError(f"fused_contrastive_ce: a on {a.device}, b on {b.device}; both "
                         "must be on one CUDA device (or both on the CPU)")
    return False


def _forward(a, b, labels, scale):
    if _on_cpu(a, b):
        return fused_ce_fwd_plain(a, b, labels, scale)
    return _launch_fwd(a, b, labels, scale)


def _backward(a, b, labels, scale, lse, g):
    """(dA fp32, dB fp32, dscale fp32 scalar) for the loss-row cotangent g."""
    g = g.float().contiguous()
    if _on_cpu(a, b):
        da, dscale_rows = fused_ce_bwd_da_plain(a, b, labels, scale, lse, g)
        db = fused_ce_bwd_db_plain(a, b, labels, scale, lse, g)
    else:
        da, dscale_rows = _launch_bwd_da(a, b, labels, scale, lse, g)
        db = _launch_bwd_db(a, b, labels, scale, lse, g)
    return da, db, dscale_rows.sum()


class _FusedCE(torch.autograd.Function):
    """Loss rows [M] fp32; saves only the inputs and the per-row lse."""

    @staticmethod
    def forward(ctx, a, b, labels, scale):
        loss, lse = _forward(a, b, labels, scale)
        ctx.save_for_backward(a, b, labels, scale, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        a, b, labels, scale, lse = ctx.saved_tensors
        da, db, dscale = _backward(a, b, labels, scale, lse, g)
        return da.to(a.dtype), db.to(b.dtype), None, dscale.reshape(scale.shape)


def fused_contrastive_ce(a: torch.Tensor, b: torch.Tensor, labels: torch.Tensor,
                         logit_scale) -> torch.Tensor:
    """Mean over rows of CE(logit_scale * a @ b.T, labels), fp32, without the
    [M, N] matrix. a [M, D], b [N, D], labels [M] integer column indices;
    differentiable in a, b and logit_scale (a tensor or a number).

    CPU tensors take the plain versions; CUDA tensors launch the kernels
    (float32 or bfloat16 at any D; contiguous) or raise."""
    _check_args(a, b, labels)
    scale = torch.as_tensor(logit_scale, device=a.device)
    scale = scale.to(torch.float32) if scale.dtype != torch.float32 else scale
    labels = labels.to(torch.int32).contiguous()
    needs_grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                              or scale.requires_grad)
    if needs_grad:
        return _FusedCE.apply(a, b, labels, scale).mean()
    return _forward(a, b, labels, scale)[0].mean()
