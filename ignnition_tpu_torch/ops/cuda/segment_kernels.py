"""Kernel A (sorted-COO segment sum with CSR row pointers), its windowed
form, and the id-keyed segment sum.

They replace the TPU kernels of `ignnition_tpu/ops/pallas/segment_kernels.py`:
`_packed_impl` / `_make_packed_kernel` (reached through
`sorted_segment_sum_csr`) and `_sorted_segment_sum_impl` (reached through
`sorted_segment_sum_pallas`, and through `sorted_segment_sum_csr` where the
width does not divide 128). The CUDA source is `csrc/segment_sum.cu`: one
kernel body behind two C entries (row pointers of one or several windows;
sorted ids), one launch per call.

What bounds them on an H100 depends on the shape (the source's header has
the reckoning): device-memory bytes are the floor, but at the models' small
shapes (2,048 rows of ~64 edges) the time is memory latency and the launch,
not bytes, so the design is about bytes in flight: 16-byte loads whatever
the width, eight of them per lane before the first add, and a CTA that deals
the batches of its rows to its warps in turn, so that a long row gets all
of them. No float atomics: two calls agree bit for bit.

Contracts, the TPU kernels':

* `sorted_segment_sum_csr`: `out[n] = sum(data[row_ptr[n]:row_ptr[n+1]])`
  for `n < len(row_ptr) - 1`; edges outside `[row_ptr[0], row_ptr[-1])` are
  padding and never read; bf16 or f32 in, accumulated in f32, **f32 out**.
  The backward is the TPU function's (`_csr_bwd`): a row gather of the
  cotangent by segment id, cast to the data's dtype, plain tensor code.
* `sorted_segment_sum_csr_windows`: the same over the row pointers of
  several windows laid one after another (the windowed slice sort of the
  data layer), `out[n]` adding row `n` of every window. The TPU function
  sums `windows * n_rows` segments and reduces `[windows, n_rows, D]`; here
  it is one launch.
* `sorted_segment_sum_ids`: the sum keyed by non-decreasing `segment_ids`
  at any width. That TPU function takes its row pointers from a
  `searchsorted` outside the kernel body; its f32 id column and lane padding
  are Mosaic workarounds. Here the kernel finds each row's edge range itself
  (a 32-way search of the sorted ids by one warp per bound), so a call is
  one launch with no `searchsorted`, `arange` or cast before it. Its
  contract differs from kernel A's in one point, kept: every edge whose id
  lies in `[0, num_segments)` is summed, padding edges included, so callers
  zero those first.
"""

from __future__ import annotations

import torch

from . import _build, takes_plain

# launches made from Python in this process, eager or recorded into a CUDA
# graph; a graph's replays launch again uncounted (`ops.cuda`)
launch_count = 0  # launches of kernel A
windows_launch_count = 0  # those of them over more than one window
ids_launch_count = 0  # launches of the id-keyed kernel


def sorted_segment_sum_csr_plain(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the reference of the kernel): f32
    sums, f64 for f64 data."""
    n = row_ptr.shape[0] - 1
    rp = row_ptr.to(torch.int64)
    counts = rp[1:] - rp[:-1]
    ids = torch.repeat_interleave(torch.arange(n, device=data.device), counts)
    acc = torch.promote_types(data.dtype, torch.float32)
    rows = data[int(rp[0]) : int(rp[0]) + ids.shape[0]].to(acc)
    out = torch.zeros((n, data.shape[1]), dtype=acc, device=data.device)
    return out.index_add_(0, ids, rows)


def sorted_segment_sum_csr_windows_plain(
    data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The windowed sum in plain PyTorch: one sum over every window's rows,
    then the windows added (the TPU function's form)."""
    flat = sorted_segment_sum_csr_plain(data, row_ptr)
    return flat.reshape(-1, num_segments, data.shape[1]).sum(dim=0)


def _check_data(data: torch.Tensor, name: str) -> torch.Tensor:
    _build.check_device(data, name)
    if data.dim() != 2 or data.dtype not in _build.DTYPE_CODES:
        raise ValueError(
            f"{name} takes 2-D bf16/f32 data, got {tuple(data.shape)} {data.dtype}"
        )
    if data.shape[0] >= 2**31:
        raise ValueError(f"{name}: {data.shape[0]} edges do not fit an int32 row pointer")
    return data.contiguous()


def _launch(data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Kernel A on a CUDA tensor: `row_ptr` holds `windows * num_segments + 1`
    pointers, one launch whatever the number of windows."""
    global launch_count, windows_launch_count
    name = "sorted_segment_sum_csr"
    data = _check_data(data, name)
    if row_ptr.dtype != torch.int32 or row_ptr.dim() != 1 or row_ptr.device != data.device:
        raise ValueError(f"{name} takes a 1-D int32 row_ptr on the data's device")
    windows = (row_ptr.shape[0] - 1) // num_segments if num_segments else 0
    if num_segments and windows * num_segments + 1 != row_ptr.shape[0]:
        raise ValueError(
            f"{name}: {row_ptr.shape[0]} row pointers are not windows of {num_segments} rows"
        )
    row_ptr = row_ptr.contiguous()
    e, d = data.shape
    out = torch.empty((num_segments, d), dtype=torch.float32, device=data.device)
    if num_segments == 0 or d == 0:
        return out
    code = _build.library().ign_csr_segment_sum(
        data.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), e, num_segments, windows, d,
        _build.DTYPE_CODES[data.dtype], _build.stream_handle(data.device),
    )
    _build.check(code, "csr_segment_sum")
    launch_count += 1
    windows_launch_count += windows > 1
    return out


def _launch_ids(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The id-keyed kernel on a CUDA tensor: one launch, the ids as they are."""
    global ids_launch_count
    name = "sorted_segment_sum_ids"
    data = _check_data(data, name)
    if segment_ids.dtype not in (torch.int32, torch.int64) or segment_ids.device != data.device:
        raise ValueError(f"{name} takes int32 or int64 ids on the data's device")
    segment_ids = segment_ids.contiguous()
    e, d = data.shape
    out = torch.empty((num_segments, d), dtype=torch.float32, device=data.device)
    if num_segments == 0 or d == 0:
        return out
    code = _build.library().ign_segment_sum_ids(
        data.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), e, num_segments, d,
        _build.DTYPE_CODES[data.dtype], int(segment_ids.dtype == torch.int64),
        _build.stream_handle(data.device),
    )
    _build.check(code, "segment_sum_ids")
    ids_launch_count += 1
    return out


def _segment_ids(row_ptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """The segment of each of `num_edges` edges under `row_ptr`; edges outside
    [row_ptr[0], row_ptr[-1]) (padding) get -1. Over the pointers of several
    windows the segment counts on through the windows."""
    e = torch.arange(num_edges, device=row_ptr.device, dtype=row_ptr.dtype)
    ids = torch.searchsorted(row_ptr[1:].contiguous(), e, right=True)
    live = (e >= row_ptr[0]) & (e < row_ptr[-1])
    return torch.where(live, ids, torch.full_like(ids, -1))


def sorted_segment_sum_ids_plain(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The id-keyed sum in plain PyTorch (its reference): f32 sums (f64 for
    f64 data) of every row whose id lies in [0, num_segments)."""
    ids = segment_ids.to(torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    acc = torch.promote_types(data.dtype, torch.float32)
    out = torch.zeros((num_segments, data.shape[1]), dtype=acc, device=data.device)
    return out.index_add_(0, ids[keep], data[keep].to(acc))


def _ids_row_ptr(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR pointers of non-decreasing ids: row_ptr[k] is the first edge whose
    id reaches k. What the kernel's search finds per row; tests hold the two
    keyed forms to each other with it."""
    bounds = torch.arange(num_segments + 1, device=segment_ids.device, dtype=segment_ids.dtype)
    return torch.searchsorted(segment_ids.contiguous(), bounds).to(torch.int32)


def sorted_segment_sum_ids_transpose(ct: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """The id-keyed sum's backward: each edge's cotangent is its segment's
    row of `ct`, and zero for an id outside [0, len(ct)), which the sum
    does not count (the plain version's autograd gives the same)."""
    ids = segment_ids.to(torch.int64)
    keep = (ids >= 0) & (ids < ct.shape[0])
    return ct[ids.clamp(0, max(ct.shape[0] - 1, 0))] * keep[:, None].to(ct.dtype)


# --------------------------------------------------------------------------
# the kernels as operators (`torch.ops.ignnition_tpu_torch.*`): a CUDA body
# that launches the kernel, a CPU body that is the plain version, a fake that
# gives the output's shape without building or launching anything (what
# `torch.export` traces); the public entries differentiate
# --------------------------------------------------------------------------

_lib = _build.op_library()
_lib.define("csr_segment_sum(Tensor data, Tensor row_ptr, int num_segments) -> Tensor")
_lib.define(
    "csr_segment_sum_windows(Tensor data, Tensor row_ptr, int num_segments) -> Tensor")
_lib.define("segment_sum_ids(Tensor data, Tensor segment_ids, int num_segments) -> Tensor")


# the bodies look their functions up when called, so that a patched name
# (a spy, the plain path on the card) is the one that runs


def _csr_cuda(data, row_ptr, num_segments):
    return _launch(data, row_ptr, num_segments)


def _csr_cpu(data, row_ptr, num_segments):
    return sorted_segment_sum_csr_plain(data, row_ptr)


def _windows_cpu(data, row_ptr, num_segments):
    return sorted_segment_sum_csr_windows_plain(data, row_ptr, num_segments)


def _ids_cuda(data, segment_ids, num_segments):
    return _launch_ids(data, segment_ids, num_segments)


def _ids_cpu(data, segment_ids, num_segments):
    return sorted_segment_sum_ids_plain(data, segment_ids, num_segments)


def _sum_fake(data, index, num_segments):
    acc = torch.promote_types(data.dtype, torch.float32)
    return data.new_empty((num_segments, data.shape[1]), dtype=acc)


_lib.impl("csr_segment_sum", _csr_cuda, "CUDA")
_lib.impl("csr_segment_sum", _csr_cpu, "CPU")
_lib.impl("csr_segment_sum_windows", _csr_cuda, "CUDA")
_lib.impl("csr_segment_sum_windows", _windows_cpu, "CPU")
_lib.impl("segment_sum_ids", _ids_cuda, "CUDA")
_lib.impl("segment_sum_ids", _ids_cpu, "CPU")
torch.library.register_fake(f"{_build.OPS}::csr_segment_sum", _sum_fake, lib=_lib)
torch.library.register_fake(f"{_build.OPS}::csr_segment_sum_windows", _sum_fake, lib=_lib)
torch.library.register_fake(f"{_build.OPS}::segment_sum_ids", _sum_fake, lib=_lib)


# Gradients come from autograd Functions around the operators, not from an
# autograd registration of the operators: that would add a Python kernel, and
# its host time, to every call of a step that the host bounds. An operator
# called by itself therefore does not differentiate; the public entries do.


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _CsrSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, row_ptr):
        ctx.save_for_backward(row_ptr)
        ctx.data_dtype, ctx.num_edges = data.dtype, data.shape[0]
        return torch.ops.ignnition_tpu_torch.csr_segment_sum(data, row_ptr, row_ptr.shape[0] - 1)

    @staticmethod
    def backward(ctx, ct):
        """The TPU function's `_csr_bwd`: a row gather of the cotangent by
        segment id, zero for padding edges, in the data's dtype."""
        (row_ptr,) = ctx.saved_tensors
        ids = _segment_ids(row_ptr, ctx.num_edges)
        grad = ct[ids.clamp_min(0)] * (ids >= 0)[:, None].to(ct.dtype)
        return grad.to(ctx.data_dtype), None


class _IdsSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        ctx.data_dtype = data.dtype
        return torch.ops.ignnition_tpu_torch.segment_sum_ids(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, ct):
        (segment_ids,) = ctx.saved_tensors
        return sorted_segment_sum_ids_transpose(ct, segment_ids).to(ctx.data_dtype), None, None


# --------------------------------------------------------------------------
# public entries
# --------------------------------------------------------------------------


def sorted_segment_sum_csr(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """[E, D] bf16/f32 rows summed into len(row_ptr) - 1 segments -> f32.
    Differentiable in `data`: the backward gathers the cotangent row of each
    edge's segment (ids derived from `row_ptr`); padding edges get zero.

    The operator `csr_segment_sum`: a CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (and raises if it cannot). Under the
    pallas switch's 'never' the plain version on any device, differentiated
    by autograd; under 'always' a CPU tensor raises."""
    if takes_plain(data, "pallas", "sorted_segment_sum_csr"):
        return sorted_segment_sum_csr_plain(data, row_ptr)
    if _wants_grad(data):
        return _CsrSegmentSum.apply(data, row_ptr)
    return torch.ops.ignnition_tpu_torch.csr_segment_sum(data, row_ptr, row_ptr.shape[0] - 1)


def sorted_segment_sum_csr_windows(
    data: torch.Tensor, row_ptr: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """[E, D] bf16/f32 rows summed over the row pointers of several windows
    (`row_ptr` [windows * num_segments + 1], offsets into the whole of
    `data`) -> [num_segments, D] f32, row n adding row n of every window.
    Not differentiable: backwards call it.

    The operator `csr_segment_sum_windows`: a CPU tensor takes the plain
    version; a CUDA tensor launches kernel A once (and raises if it
    cannot). The pallas switch as for `sorted_segment_sum_csr`."""
    if takes_plain(data, "pallas", "sorted_segment_sum_csr_windows"):
        return sorted_segment_sum_csr_windows_plain(data.detach(), row_ptr, num_segments)
    return torch.ops.ignnition_tpu_torch.csr_segment_sum_windows(
        data.detach(), row_ptr, num_segments)


def sorted_segment_sum_ids(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """[E, D] bf16/f32 rows summed by non-decreasing `segment_ids` [E] (int32
    or int64) into `num_segments` rows -> f32, at any width D. Every edge
    whose id lies in [0, num_segments) counts, padding included.
    Differentiable in `data`: the backward is `ct[segment_ids]` in the data's
    dtype (the TPU function's `_sss_bwd`), zero for an id out of range.

    The operator `segment_sum_ids`: a CPU tensor takes the plain version; a
    CUDA tensor launches the id-keyed kernel once (and raises if it
    cannot). The pallas switch as for `sorted_segment_sum_csr`."""
    if segment_ids.dim() != 1 or segment_ids.shape[0] != data.shape[0]:
        raise ValueError(
            f"sorted_segment_sum_ids: {tuple(segment_ids.shape)} ids for data "
            f"{tuple(data.shape)}"
        )
    if takes_plain(data, "pallas", "sorted_segment_sum_ids"):
        return sorted_segment_sum_ids_plain(data, segment_ids, num_segments)
    if _wants_grad(data):
        return _IdsSegmentSum.apply(data, segment_ids, num_segments)
    return torch.ops.ignnition_tpu_torch.segment_sum_ids(data, segment_ids, num_segments)
