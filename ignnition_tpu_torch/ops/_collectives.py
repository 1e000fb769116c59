"""Collectives of the sharded steps (the JAX package's `psum`, `pmax`,
`pmin`, `all_gather` and `all_to_all` inside its shard_map), over
`torch.distributed` process groups.

`psum` is an autograd Function: its forward all-reduces the partials and
its backward all-reduces the cotangent. Under the step's gradient scheme
(`parallel/steps.py`: every rank's loss scaled by 1/(n_data * n_model),
every parameter gradient all-reduced over the mesh) that gives the JAX
step's gradients exactly: each rank's replica of a replicated value
receives its own share of the cotangent, and the backward sum hands each
partial the whole of it. `pmax` is detached, as the JAX package's
`stop_gradient` before its `pmax` makes it. A group of None is no group:
every function then returns its input.

Partials of a low-precision dtype (bf16, f16) are summed in f32 and cast
back, for the sum's accuracy: a segment sum's partials overlap, and a sum
of bf16 partials in bf16 rounds at every addition (the sequence scatter's
partials are disjoint, exact either way). The widening is not for the
backends: gloo and NCCL both take bf16 tensors.

`all_to_all` is the halo exchange of destination sharding (v2,
`parallel/edgeshard.py`): rows move, nothing is summed, so no dtype is
widened. Its backward is the same exchange of the cotangent (in the tiled
layout the exchange is its own transpose). `all_to_all_start` /
`all_to_all_wait` split it around other work: the first issues the
exchange asynchronously, the second waits for it, and only the second's
output may be read.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

_LOW = (torch.bfloat16, torch.float16)


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """`dist.all_reduce` of `t` in place (through an f32 copy for bf16 and
    f16); returns `t`."""
    if t.dtype in _LOW:
        wide = t.to(torch.float32)
        dist.all_reduce(wide, op=op, group=group)
        t.copy_(wide)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_(ct.contiguous().clone(), group=ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, on every rank; its
    cotangent is summed over them too."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise largest `x` over the ranks of `group`, detached."""
    if group is None:
        return x.detach()
    return all_reduce_(x.detach().contiguous().clone(), op=dist.ReduceOp.MAX, group=group)


def all_true(flag: torch.Tensor, groups: Iterable[Optional[object]]) -> torch.Tensor:
    """A boolean scalar true on every rank of `groups` only where it is true
    on all of them (the JAX `pmin` over each named axis)."""
    out = flag.to(torch.int32).reshape(1)
    for group in groups:
        if group is not None:
            dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out[0] > 0


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` of `group`, concatenated along `dim` in rank order
    (the JAX `all_gather(..., tiled=True)`); not differentiated."""
    if group is None:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _exchange(x: torch.Tensor, group, async_op: bool = False):
    """`dist.all_to_all_single` of `x` (its leading dimension split into one
    equal block per rank of `group`, block j sent to rank j, the block
    received from rank j stored at j); returns (output, work or None)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x, group=group, async_op=async_op)
    return out, work


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)[0]

    @staticmethod
    def backward(ctx, ct):
        return _exchange(ct, ctx.group)[0], None


class PendingExchange:
    """An exchange in flight (`all_to_all_start`): `all_to_all_wait(p)`
    returns its output once it has arrived."""

    def __init__(self):
        self.work = None
        self.out = None


class _AllToAllStart(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        out, pending.work = _exchange(x, group, async_op=True)
        return out

    @staticmethod
    def backward(ctx, ct):
        return _exchange(ct, ctx.group)[0], None, None


class _AllToAllWait(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, pending):
        pending.work.wait()
        pending.work = None
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The JAX `all_to_all(x, split_axis=0, concat_axis=0, tiled=True)` over
    the ranks of `group`: `x` holds one block of rows for each rank (the
    leading dimension divides by the group's size), block j goes to rank j,
    and the output holds at block j what rank j sent this rank.
    Differentiable: the cotangent takes the way back."""
    return _AllToAll.apply(x, group)


def all_to_all_start(x: torch.Tensor, group) -> PendingExchange:
    """`all_to_all(x, group)` issued asynchronously: work placed between this
    call and `all_to_all_wait` runs while the rows travel."""
    pending = PendingExchange()
    pending.out = _AllToAllStart.apply(x, group, pending)
    return pending


def all_to_all_wait(pending: PendingExchange) -> torch.Tensor:
    """The output of an exchange begun by `all_to_all_start`, once it has
    arrived (the backward's exchange runs synchronously)."""
    return _AllToAllWait.apply(pending.out, pending)
