"""The communication that XLA inserts for the JAX package's mesh, written
out as autograd functions over process groups.

Built from ``all_reduce`` (and, for ``broadcast_``, ``broadcast``), which
gloo (CPU and CUDA tensors) and NCCL both provide. A ``group`` of ``None``
means "no group": every function is then the identity, so a model without
a mesh runs no collective. (In
``torch.distributed`` ``None`` names the default group; here it never
does.)

  * ``all_reduce_sum``: the sum over the group, on every rank; its gradient
    is the all-reduce of the gradient (each rank's loss reads the sum).
    Masked BatchNorm's statistics over the global batch use it.
  * ``copy_to_group``: the identity forward, the all-reduce of the
    gradient backward. It stands before a projection whose output rows are
    split over the model group: each rank's product gives only its share of
    the input's gradient.
  * ``gather_last``: the concatenation of every rank's slice along the last
    axis, on every rank (an all-reduce of a zero-filled buffer into which
    each rank writes its slice). Everything downstream of it is replicated
    across the group, so each rank's gradient of the whole is already the
    gradient: the backward returns the rank's own slice of it, with no
    reduction (summing there would multiply the gradients by the group's
    size).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        w = x.shape[-1]
        ctx.slice = (r * w, (r + 1) * w)
        buf = x.new_zeros((*x.shape[:-1], n * w))
        buf[..., r * w:(r + 1) * w] = x
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.slice
        return g[..., lo:hi].contiguous(), None


def all_reduce_sum(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank (differentiable)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``group``."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


def gather_last(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last axis, in rank order
    (differentiable; the backward returns this rank's slice)."""
    if group is None:
        return x
    return _GatherLast.apply(x, group)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (no autograd); returns ``x``."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


@torch.no_grad()
def broadcast_(x: torch.Tensor, src: int, group: Optional[object]):
    """Overwrite ``x`` with global rank ``src``'s copy, over ``group``
    (no autograd); returns ``x``."""
    if group is not None:
        dist.broadcast(x, src=src, group=group)
    return x
