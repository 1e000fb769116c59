"""Collectives of the edge-partitioned step (the JAX package's `psum`,
`pmax`, `pmin` and `all_gather` inside its shard_map), over
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
