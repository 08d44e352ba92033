"""Cross-rank feature gathering for global-batch contrastive losses: port of
``colxlip_tpu/parallel/collectives.py`` onto ``torch.distributed``.

``axis_name`` is None (one device: every function is the identity), the
name ``mesh.DATA_AXIS`` or a process group (``parallel/mesh.py``).

- ``gather_features(gather_with_grad=True)``: all-gather whose backward is
  the sum-scatter of the cotangent over the ranks, the VJP of
  ``lax.all_gather`` (NCCL ``reduce_scatter_tensor``; gloo has none, so an
  all-reduce of the sum keeps this rank's rows).
- ``gather_with_grad=False``: gather detached copies and splice this rank's
  differentiable shard back in at ``rank * b``, so gradients reach only the
  local features; with ``local_loss`` the gathered copy carries no gradient
  at all.
- ``ring_shift``: this rank's tensor to ``(rank + shift) % n`` and the one of
  ``(rank - shift) % n`` back, one ``batch_isend_irecv``; its backward is
  the same shift run the other way.
- ``all_reduce_sum``: ``lax.psum`` (the sum over the ranks on every rank);
  its backward all-reduces the cotangent, as psum's transpose does.
- ``all_gather_stacked``: ``lax.all_gather(axis=0)`` without ``tiled``,
  [b, ...] -> [world, b, ...]; its backward is the sum-scatter of
  ``gather_features(gather_with_grad=True)``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from .mesh import AxisName, is_nccl, resolve_group


def axis_rank(axis_name: AxisName) -> int:
    return dist.get_rank(resolve_group(axis_name))


def all_gather_rows(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """[b, ...] on every rank -> [n b, ...], rank-major; no gradient."""
    x = x.detach().contiguous()
    n = dist.get_world_size(group)
    if is_nccl(group):
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def sum_scatter_rows(g: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """[n b, ...] on every rank -> this rank's b rows of the sum over ranks."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b = g.shape[0] // n
    g = g.contiguous()
    if is_nccl(group):
        out = g.new_empty((b, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, group=group)
        return out
    g = g.clone()
    dist.all_reduce(g, group=group)
    return g[r * b:(r + 1) * b]


def shift_rows(x: torch.Tensor, group: dist.ProcessGroup, shift: int) -> torch.Tensor:
    """Send ``x`` to rank ``(r + shift) % n`` and receive the tensor of rank
    ``(r - shift) % n``; no gradient. At one rank the tensor stays."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _GatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return sum_scatter_rows(g, ctx.group), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return shift_rows(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return shift_rows(g, ctx.group, -ctx.shift), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank (``lax.psum``)."""
    return _AllReduceSum.apply(x, resolve_group(axis_name))


def all_gather_stacked(x: torch.Tensor, axis_name: AxisName) -> torch.Tensor:
    """[b, ...] on every rank -> [world, b, ...], rank-major, differentiable
    (``lax.all_gather`` without ``tiled``): the cotangent of every rank's copy
    is summed onto the rank that sent the rows."""
    group = resolve_group(axis_name)
    n = dist.get_world_size(group)
    return _GatherWithGrad.apply(x, group).reshape(n, *x.shape)


def ring_shift(x: torch.Tensor, axis_name: AxisName, shift: int = 1) -> torch.Tensor:
    """Move each rank's ``x`` to ``(rank + shift) % world``."""
    return _RingShift.apply(x, resolve_group(axis_name), shift)


def gather_features(features: torch.Tensor, *, axis_name: AxisName,
                    gather_with_grad: bool = False, local_loss: bool = False
                    ) -> torch.Tensor:
    """All-gather [b, ...] -> [world b, ...] along the leading axis (the
    identity at ``axis_name=None``). Without ``gather_with_grad`` and without
    ``local_loss`` this rank's rows are its own differentiable ``features``;
    with ``local_loss`` no row carries a gradient."""
    group = resolve_group(axis_name)
    if group is None:
        return features
    if gather_with_grad:
        return _GatherWithGrad.apply(features, group)
    gathered = all_gather_rows(features, group)
    if local_loss:
        return gathered
    r, b = dist.get_rank(group), features.shape[0]
    return torch.cat([gathered[:r * b], features, gathered[(r + 1) * b:]])


def gather_pair(image_features: torch.Tensor, text_features: torch.Tensor, *,
                axis_name: AxisName, gather_with_grad: bool = False,
                local_loss: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather both feature tensors."""
    kw = dict(axis_name=axis_name, gather_with_grad=gather_with_grad, local_loss=local_loss)
    return gather_features(image_features, **kw), gather_features(text_features, **kw)


def rank_offset(num_rows: int, axis_name: AxisName) -> int:
    """``num_rows * rank`` (0 at ``axis_name=None``): where this rank's rows
    start in the gathered batch."""
    return 0 if axis_name is None else num_rows * axis_rank(axis_name)
