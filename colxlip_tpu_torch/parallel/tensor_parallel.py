"""Megatron tensor parallelism over the mesh's 'model' axis: the autograd
collectives around the column- and row-parallel halves of the attention and
the MLP (``models/layers.py`` calls them when ``parallel/gspmd.py`` gave a
module a ``ModelAxis``).

The parameters keep the JAX layout (``colxlip_tpu/parallel/gspmd.py``
``_spec_for``): the [out, in] weights of ``in_proj`` and ``c_fc`` are
row-sharded (JAX's ``P(None, 'model')`` on the [in, out] kernel), those of
``out_proj`` and ``c_proj`` column-sharded, every bias and every 1-D leaf
replicated. The compute runs on the local shards as plain tensors, so the
kernels' wrappers take them as they take the one-device tensors:

- ``enter``: the input of a column-parallel product; identity forward,
  all-reduce-sum backward (each rank's input gradient covers its own
  columns of the product).
- ``leave``: the output of a row-parallel product; all-reduce-sum forward,
  identity backward. The caller adds the replicated bias once, after it.
- ``take_rows``: the slices of a replicated tensor that this rank's columns
  use (``c_fc.bias``, ``in_proj_bias``); its backward all-gathers every
  rank's slice gradient, so the replicated tensor's gradient is the same on
  every rank of the model group. Slicing in autograd alone would leave each
  rank a different "replicated" gradient, and nothing would raise.
- ``regroup_qkv``: the packed ``in_proj_weight`` [3D, D] row-sharded over P
  ranks is not aligned to heads (at P = 2 rank 0 holds all of q and half of
  k). One all-to-all of weight rows gives rank m the q, k and v rows of
  heads [m H / P, (m + 1) H / P); its backward is the inverse all-to-all.
  The weight stays stored in the JAX layout: a stored permutation would bind
  a checkpoint to one P.
- ``int8_row_parallel_linear``: ``c_proj`` under ``COLXLIP_MLP_INT8=fwd``.
  The int8 forward scales each activation row and each weight row by its
  absmax over the contracted dimension, which is the one split here: each
  rank takes the model group's maximum of both before it quantizes, and the
  int32 partial products are summed over the group before the one rescale,
  so the forward equals the one-device forward bit for bit. Quantizing each
  shard with its own scales would give a different result that nothing
  flags. The backward is the straight-through one of the plain row-parallel
  product.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch
import torch.distributed as dist

from ..ops.quantization import absmax_scale, int8_mm, straight_through_grads


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model group of this rank: ``size`` ranks, this one at ``index``."""
    group: dist.ProcessGroup
    size: int
    index: int


def _all_reduce(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Identity forward, the model group's sum of the gradient backward."""
    return _Enter.apply(x, axis)


def leave(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The model group's sum forward, identity backward."""
    return _Leave.apply(x, axis)


def _gather_rows(x: torch.Tensor, axis: ModelAxis) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return parts


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, full, axis, starts_by_rank, length):
        ctx.axis, ctx.starts, ctx.length, ctx.shape = axis, starts_by_rank, length, full.shape
        return torch.cat([full[s:s + length] for s in starts_by_rank[axis.index]])

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        for starts, part in zip(ctx.starts, _gather_rows(g, ctx.axis)):
            for j, s in enumerate(starts):
                full[s:s + ctx.length] = part[j * ctx.length:(j + 1) * ctx.length]
        return full, None, None, None


def take_rows(full: torch.Tensor, axis: ModelAxis, sections: int) -> torch.Tensor:
    """The rows of the replicated ``full`` [n, ...] that this rank's shard of
    a row-sharded weight of ``sections`` packed parts uses: part s's slice
    [s n / k + m c, s n / k + (m + 1) c), c = n / (k P), concatenated (k =
    ``sections``; 3 for the packed q, k, v)."""
    part = full.shape[0] // sections
    length = part // axis.size
    starts = tuple(tuple(s * part + m * length for s in range(sections))
                   for m in range(axis.size))
    return _TakeRows.apply(full, axis, starts, length)


def _qkv_plan(size: int, index: int):
    """The all-to-all plan of the packed rows in chunks of D / P rows: chunk
    g (of 3P) is part g // P (q, k, v) of head group g % P, stored on rank
    g // 3. Returns (this rank's local chunk order by destination, chunks
    sent to each rank, chunks received from each rank)."""
    mine = [3 * index + j for j in range(3)]
    order = sorted(range(3), key=lambda j: (mine[j] % size, mine[j]))
    send = [sum(1 for g in mine if g % size == d) for d in range(size)]
    recv = [sum(1 for g in range(3 * q, 3 * q + 3) if g % size == index) for q in range(size)]
    return order, send, recv


def _all_to_all_rows(x: torch.Tensor, axis: ModelAxis, send: Sequence[int],
                     recv: Sequence[int], rows: int) -> torch.Tensor:
    out = x.new_empty((sum(recv) * rows, *x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), [n * rows for n in recv],
                           [n * rows for n in send], group=axis.group)
    return out


class _RegroupQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axis):
        rows = w.shape[0] // 3
        order, send, recv = _qkv_plan(axis.size, axis.index)
        ctx.axis, ctx.plan, ctx.rows = axis, (order, send, recv), rows
        chunks = w.split(rows)
        return _all_to_all_rows(torch.cat([chunks[j] for j in order]), axis, send, recv, rows)

    @staticmethod
    def backward(ctx, g):
        order, send, recv = ctx.plan
        back = _all_to_all_rows(g, ctx.axis, recv, send, ctx.rows).split(ctx.rows)
        out = [None] * 3
        for pos, j in enumerate(order):
            out[j] = back[pos]
        return torch.cat(out), None


def regroup_qkv(w: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """This rank's stored rows of the packed in_proj weight (rows [m 3D / P,
    (m + 1) 3D / P) of [3D, D]) -> the q, k and v rows of its head group, in
    the packed order the attention takes ([3 D / P, D])."""
    return _RegroupQKV.apply(w, axis)


def _group_max(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out


def _quantize_rows(t: torch.Tensor, axis: ModelAxis):
    """Round-to-nearest int8 of t [R, K / P] fp32 with one scale a row, the
    absmax taken over the whole K of the model group."""
    scale = absmax_scale(_group_max(t.abs().amax(dim=1, keepdim=True), axis), 1e-8)
    return torch.round(t / scale).clamp(-127, 127).to(torch.int8), scale


class _Int8RowParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, axis):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        xq, xs = _quantize_rows(x.reshape(-1, x.shape[-1]).float(), axis)
        wq, ws = _quantize_rows(weight.float(), axis)          # [out, in / P], [out, 1]
        acc = int8_mm(xq, wq)
        dist.all_reduce(acc, group=axis.group)                 # exact: int32 sums
        y = acc.float() * xs * ws.T + bias.float()
        return y.reshape(*x.shape[:-1], -1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return (*straight_through_grads(x, weight, g, ctx.bias_dtype), None)


def int8_row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             axis: ModelAxis) -> torch.Tensor:
    """``ops.quantization.int8_st_linear`` over the model group, as a
    row-parallel product: x [..., K / P] and weight [out, K / P] are this
    rank's columns of the contraction, ``bias`` [out] is replicated; the
    result [..., out] is the whole product on every rank of the group."""
    return _Int8RowParallel.apply(x, weight, bias, axis)
