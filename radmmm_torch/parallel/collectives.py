"""Collectives over a process group, with their gradients and a tally.

Each wrapper issues one ``torch.distributed`` call and adds one to its
kind's count and its bytes to ``STATS`` (the port's counterpart of reading
the collectives out of a compiled program's HLO, which PyTorch does not
have). The bytes are those of the logical result: an all-reduce's tensor,
an all-gather's output, a reduce-scatter's input. ``STATS`` ticks where a
collective is issued, so while a CUDA graph is captured and never while it
replays: it is one of the tallies of ``utils/launches.py``, whose counts
the graphs' ledger (``utils/graphs.py``) takes back from a capture and adds
at each replay, as it does the kernels' launches.

Under NCCL the all-gather and the reduce-scatter are NCCL's own. Under
gloo both are written from the one collective every gloo build takes on
CPU and CUDA tensors alike (its all-gather and reduce-scatter on CUDA
tensors depend on the build; ``chip_smoke.py``'s ddp phase prints which
the installed one takes): an all-gather is an all-reduce of a zero-padded
stack (each rank fills its slot; adding zeros is exact) and a
reduce-scatter an all-reduce of the stack, then one's own slot. On one
card the ranks then talk through host memory, which proves the
arithmetic, not NCCL's bandwidth. Every tensor handed to a collective is
contiguous, as NCCL requires.

The autograd functions are the four a data- and tensor-parallel step
needs:

* ``all_reduce_sum``: sum over the group forward and backward (batch
  statistics that every rank's share of the loss reads);
* ``copy_to_group``: identity forward, sum of the gradients backward (the
  replicated input of a column-parallel layer);
* ``reduce_from_group``: sum forward, identity backward (the output of a
  row-parallel layer, read alike by every rank);
* ``gather``: concatenation along a dim forward, sum then one's own slice
  backward (a reduce-scatter).
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.distributed as dist

from radmmm_torch.utils.launches import TALLIES, tally

# (kind, "count") and (kind, "bytes") of the collectives issued since the
# last ``reset_stats``
STATS: collections.Counter = collections.Counter()
TALLIES.append(STATS)


def reset_stats() -> None:
    STATS.clear()


def _record(kind: str, t: torch.Tensor) -> None:
    tally(STATS, (kind, "count"))
    tally(STATS, (kind, "bytes"), t.numel() * t.element_size())


class Group:
    """A process group as the collectives take it: the group, its size,
    this process's index in it and the backend's name. A group of one
    makes every collective the identity."""

    def __init__(self, group, size: int, index: int, backend: str):
        self.group, self.size, self.index = group, size, index
        self.nccl = backend == "nccl"


def fresh(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` (NCCL takes contiguous tensors only)."""
    return x.clone(memory_format=torch.contiguous_format)


def all_reduce_(x: torch.Tensor, g: Group) -> torch.Tensor:
    """Sum the contiguous ``x`` over the group in place; returns ``x``."""
    if g.size > 1:
        _record("all_reduce", x)
        dist.all_reduce(x, group=g.group)
    return x


def all_reduce_max_(x: torch.Tensor, g: Group) -> torch.Tensor:
    """The elementwise max of the contiguous ``x`` over the group, in
    place; returns ``x``."""
    if g.size > 1:
        _record("all_reduce_max", x)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g.group)
    return x


def _gather_stack(x: torch.Tensor, g: Group) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x``, in group order."""
    x = x.contiguous()
    if g.nccl:
        out = x.new_empty((g.size,) + tuple(x.shape))
        _record("all_gather", out)
        dist.all_gather_into_tensor(out, x, group=g.group)
        return out
    out = x.new_zeros((g.size,) + tuple(x.shape))
    out[g.index] = x
    _record("all_gather", out)
    dist.all_reduce(out, group=g.group)
    return out


def _reduce_scatter_stack(stack: torch.Tensor, g: Group) -> torch.Tensor:
    """The sum over the group of ``stack`` (size, ...), this rank's slot."""
    stack = stack.contiguous()
    _record("reduce_scatter", stack)
    if g.nccl:
        out = stack.new_empty(stack.shape[1:])
        dist.reduce_scatter_tensor(out, stack, group=g.group)
        return out
    dist.all_reduce(stack, group=g.group)
    return stack[g.index].clone()


def gather_along(x: torch.Tensor, g: Group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (no gradient)."""
    if g.size == 1:
        return x
    return torch.cat(list(_gather_stack(x, g).unbind(0)), dim=dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_reduce_(fresh(x), g)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(fresh(dy), ctx.g), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(fresh(dy), ctx.g), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce_(fresh(x), g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return gather_along(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        stack = torch.stack(dy.chunk(ctx.g.size, dim=ctx.dim))
        return _reduce_scatter_stack(stack, ctx.g), None, None


def all_reduce_sum(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    return x if g is None or g.size == 1 else _AllReduceSum.apply(x, g)


def copy_to_group(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    return x if g is None or g.size == 1 else _CopyToGroup.apply(x, g)


def reduce_from_group(x: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    return x if g is None or g.size == 1 else _ReduceFromGroup.apply(x, g)


def gather(x: torch.Tensor, g: Optional[Group], dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``; the gradient of a
    rank's slice is the sum over the group of the gradients of that slice
    (each rank's downstream reads all of it)."""
    return x if g is None or g.size == 1 else _Gather.apply(x, g, dim)
