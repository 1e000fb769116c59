"""Kernel A: sorted-COO segment sum with CSR row pointers, and the id-keyed
sum over it.

Replaces the TPU kernel `ignnition_tpu/ops/pallas/segment_kernels.py`,
`_packed_impl` / `_make_packed_kernel` (reached through
`sorted_segment_sum_csr`). The CUDA source is `csrc/segment_sum.cu`; its
header comment gives what bounds the kernel on an H100 (device-memory bytes)
and what its design does about that.

Contract, the TPU kernel's: `out[n] = sum(data[row_ptr[n]:row_ptr[n+1]])`
for `n < len(row_ptr) - 1`; edges outside `[row_ptr[0], row_ptr[-1])` are
padding and never read; bf16 or f32 in, accumulated in f32, **f32 out**.
The backward is the TPU function's (`_csr_bwd`): a row gather of the
cotangent by segment id, cast to the data's dtype, plain tensor code.

`sorted_segment_sum_ids` replaces the TPU kernel `_sorted_segment_sum_impl`
of the same file (reached through `sorted_segment_sum_pallas`, and through
`sorted_segment_sum_csr` where the width does not divide 128). That function
takes its row pointers from a `searchsorted` over the sorted ids outside the
kernel body and sums in the body; its f32 id column and lane padding are
Mosaic workarounds. Here it is `torch.searchsorted` for the row pointers and
kernel A for the sum, at any width. Its contract differs from kernel A's in
one point, kept: every edge whose id is below `num_segments` is summed,
padding edges included, so callers zero those first.
"""

from __future__ import annotations

import torch

from . import _build

launch_count = 0  # launches of the CUDA kernel in this process
ids_launch_count = 0  # those of them made for `sorted_segment_sum_ids`


def sorted_segment_sum_csr_plain(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the reference of the kernel)."""
    n = row_ptr.shape[0] - 1
    rp = row_ptr.to(torch.int64)
    counts = rp[1:] - rp[:-1]
    ids = torch.repeat_interleave(torch.arange(n, device=data.device), counts)
    rows = data[int(rp[0]) : int(rp[0]) + ids.shape[0]].to(torch.float32)
    out = torch.zeros((n, data.shape[1]), dtype=torch.float32, device=data.device)
    return out.index_add_(0, ids, rows)


def _launch(data: torch.Tensor, row_ptr: torch.Tensor, by_ids: bool = False) -> torch.Tensor:
    """The kernel on a CUDA tensor. `by_ids`: the launch is made for the
    id-keyed sum and counts there too."""
    global launch_count, ids_launch_count
    _build.check_device(data, "sorted_segment_sum_csr")
    if data.dim() != 2 or data.dtype not in _build.DTYPE_CODES:
        raise ValueError(
            f"sorted_segment_sum_csr takes 2-D bf16/f32 data, got "
            f"{tuple(data.shape)} {data.dtype}"
        )
    if row_ptr.dtype != torch.int32 or row_ptr.dim() != 1 or row_ptr.device != data.device:
        raise ValueError(
            "sorted_segment_sum_csr takes a 1-D int32 row_ptr on the data's device"
        )
    data = data.contiguous()
    row_ptr = row_ptr.contiguous()
    n, d = row_ptr.shape[0] - 1, data.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=data.device)
    if n == 0 or d == 0:
        return out
    code = _build.library().ign_csr_segment_sum(
        data.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n, d,
        _build.DTYPE_CODES[data.dtype], _build.stream_handle(data.device),
    )
    _build.check(code, "csr_segment_sum")
    launch_count += 1
    ids_launch_count += by_ids
    return out


def _segment_ids(row_ptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """The segment of each of `num_edges` edges under `row_ptr`; edges outside
    [row_ptr[0], row_ptr[-1]) (padding) get -1."""
    e = torch.arange(num_edges, device=row_ptr.device, dtype=row_ptr.dtype)
    ids = torch.searchsorted(row_ptr[1:].contiguous(), e, right=True)
    live = (e >= row_ptr[0]) & (e < row_ptr[-1])
    return torch.where(live, ids, torch.full_like(ids, -1))


class _CsrSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, row_ptr):
        ctx.save_for_backward(row_ptr)
        ctx.data_dtype, ctx.num_edges = data.dtype, data.shape[0]
        return _launch(data, row_ptr)

    @staticmethod
    def backward(ctx, ct):
        (row_ptr,) = ctx.saved_tensors
        ids = _segment_ids(row_ptr, ctx.num_edges)
        grad = ct[ids.clamp_min(0)] * (ids >= 0)[:, None].to(ct.dtype)
        return grad.to(ctx.data_dtype), None


def sorted_segment_sum_csr(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """[E, D] bf16/f32 rows summed into len(row_ptr) - 1 segments -> f32.
    Differentiable in `data`: the backward gathers the cotangent row of each
    edge's segment (ids derived from `row_ptr`); padding edges get zero.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and raises if it cannot)."""
    if data.device.type == "cpu":
        return sorted_segment_sum_csr_plain(data, row_ptr)
    return _CsrSegmentSum.apply(data, row_ptr)


def sorted_segment_sum_ids_plain(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The id-keyed sum in plain PyTorch (its reference): f32 sums of every
    row whose id lies in [0, num_segments)."""
    ids = segment_ids.to(torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32, device=data.device)
    return out.index_add_(0, ids[keep], data[keep].to(torch.float32))


def _ids_row_ptr(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR pointers of non-decreasing ids: row_ptr[k] is the first edge whose
    id reaches k."""
    bounds = torch.arange(num_segments + 1, device=segment_ids.device, dtype=segment_ids.dtype)
    return torch.searchsorted(segment_ids.contiguous(), bounds).to(torch.int32)


class _IdsSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        ctx.data_dtype = data.dtype
        return _launch(data, _ids_row_ptr(segment_ids, num_segments), by_ids=True)

    @staticmethod
    def backward(ctx, ct):
        (segment_ids,) = ctx.saved_tensors
        return ct[segment_ids.to(torch.int64)].to(ctx.data_dtype), None, None


def sorted_segment_sum_ids(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """[E, D] bf16/f32 rows summed by non-decreasing `segment_ids` [E] into
    `num_segments` rows -> f32, at any width D. Every edge whose id is below
    `num_segments` counts, padding included. Differentiable in `data`: the
    backward is `ct[segment_ids]` in the data's dtype (the TPU function's
    `_sss_bwd`).

    A CPU tensor takes the plain version; a CUDA tensor takes its row
    pointers from `torch.searchsorted` and launches kernel A (and raises if
    it cannot)."""
    if segment_ids.dim() != 1 or segment_ids.shape[0] != data.shape[0]:
        raise ValueError(
            f"sorted_segment_sum_ids: {tuple(segment_ids.shape)} ids for data "
            f"{tuple(data.shape)}"
        )
    if data.device.type == "cpu":
        return sorted_segment_sum_ids_plain(data, segment_ids, num_segments)
    return _IdsSegmentSum.apply(data, segment_ids, num_segments)
