"""Segment primitives of the flagship slice (counterpart of
`ignnition_tpu/ops/segment.py`), with the JAX package's hand-written
backwards as `torch.autograd.Function`s over the same host-precomputed
companion arrays: no scatter in any backward, every transpose is a gather
through a host index vector into kernel A or a masked sum of table gathers.

Dtype contract, pinned to the TPU kernel's: the CSR sums (`segment_sum` with
`row_ptr`, `direct_segment_sum*`) return **f32** whatever the input dtype —
the kernel's accumulator. The dense-incidence products return the input
dtype, as in the JAX package. The model casts sums back to its compute
dtype before the update. Every backward returns the input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda.segment_kernels import sorted_segment_sum_csr


class _GatherStateSlices(torch.autograd.Function):
    """`states[slice_src]` whose transpose is a sorted segment sum of the
    flattened cotangents in source order (the JAX `_gss_bwd`)."""

    @staticmethod
    def forward(ctx, states, slice_src, sort_perm, sort_row_ptr):
        ctx.save_for_backward(sort_perm, sort_row_ptr)
        ctx.n_src, ctx.dtype = states.shape[0], states.dtype
        return states[slice_src]

    @staticmethod
    def backward(ctx, ct):
        sort_perm, sort_row_ptr = ctx.saved_tensors
        n_src = ctx.n_src
        l, n, d = ct.shape
        n_slots = l * n
        flat = ct.reshape(n_slots, d)
        # the data layer may sort the slots within ~equal windows, with
        # indices local to each window and n_src row pointers per window
        n_chunks = (sort_row_ptr.shape[0] - 1) // n_src
        if n_chunks > 1:
            w = -(-n_slots // n_chunks)
            ct_states = None
            for c in range(n_chunks):
                lo, hi = c * w, min((c + 1) * w, n_slots)
                part = flat[lo:hi][sort_perm[lo:hi]]
                rp_c = sort_row_ptr[c * n_src : c * n_src + n_src + 1] - lo
                s = sorted_segment_sum_csr(part, rp_c)
                ct_states = s if ct_states is None else ct_states + s
        else:
            ct_states = sorted_segment_sum_csr(flat[sort_perm], sort_row_ptr)
        # kernel A returns f32; the cotangent goes back in the state dtype
        return ct_states.to(ctx.dtype), None, None, None


def gather_state_slices(
    states: torch.Tensor,
    slice_src: torch.Tensor,
    sort_perm: Optional[torch.Tensor] = None,
    sort_ids: Optional[torch.Tensor] = None,
    sort_row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """xs[t, d] = states[slice_src[t, d]]: the ordered update's time slices
    read straight from the source table (slice_src is host-precomputed).

    With the training companions (`slice_sort_perm_*`, `slice_sort_ids_*`,
    `slice_sort_row_ptr_*` of `build_batch`) the backward is kernel A over
    the cotangent rows gathered in source order; invalid slots point at the
    last source row and carry zero cotangent from the masked scan.
    `sort_ids` is the JAX function's argument for its id-based CPU sum;
    kernel A needs the row pointers only. Without companions (serving) the
    gather differentiates by autograd's scatter-add."""
    if sort_perm is None or sort_row_ptr is None:
        return states[slice_src]
    return _GatherStateSlices.apply(states, slice_src, sort_perm, sort_row_ptr)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum rows of `data` into `num_segments` buckets.

    With `row_ptr` (destination-sorted edges, CSR pointers over real edges)
    this is kernel A and returns f32. Without it, padding rows must already
    be zero and the sum keeps the input dtype (XLA's segment sum in the JAX
    package; `index_add_` here)."""
    if row_ptr is not None:
        if row_ptr.shape[0] != num_segments + 1:
            raise ValueError(
                f"row_ptr has {row_ptr.shape[0]} entries for {num_segments} segments"
            )
        return sorted_segment_sum_csr(data, row_ptr)
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device
    )
    return out.index_add_(0, segment_ids, data)


def _dss_impl(src_states, src_idx, row_ptr, num_dst):
    """Gather each edge's source row, then kernel A over the real edges.
    Padding edges lie past row_ptr[-1] and are never summed, so no edge
    mask is needed."""
    if row_ptr.shape[0] != num_dst + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries for {num_dst} rows")
    return sorted_segment_sum_csr(src_states[src_idx], row_ptr)


class _DirectSegmentSum(torch.autograd.Function):
    """Backward (the JAX `_dss_bwd`): ct_src[s] = sum over edges e with
    src[e] == s of ct[dst[e]], as a gather of ct through `dst_in_src_order`
    into kernel A over `src_row_ptr`."""

    @staticmethod
    def forward(ctx, src_states, src_idx, row_ptr, dst_in_src_order, src_row_ptr, num_dst):
        if src_row_ptr.shape[0] != src_states.shape[0] + 1:
            raise ValueError(
                f"src_row_ptr has {src_row_ptr.shape[0]} entries for "
                f"{src_states.shape[0]} source rows"
            )
        ctx.save_for_backward(dst_in_src_order, src_row_ptr)
        ctx.dtype = src_states.dtype
        return _dss_impl(src_states, src_idx, row_ptr, num_dst)

    @staticmethod
    def backward(ctx, ct):
        dst_in_src_order, src_row_ptr = ctx.saved_tensors
        ct_src = sorted_segment_sum_csr(ct[dst_in_src_order], src_row_ptr)
        return ct_src.to(ctx.dtype), None, None, None, None, None


def direct_segment_sum(
    src_states, src_idx, row_ptr, num_dst, dst_in_src_order=None, src_row_ptr=None
) -> torch.Tensor:
    """out[d] = sum over edges e with dst[e] == d of src_states[src[e]].

    With the training companions (`dst_in_src_order_*`, `src_row_ptr_*`) the
    backward is a host-indexed gather and kernel A; without them the pieces
    differentiate by autograd. The JAX function's id and mask arguments
    serve its id-based CPU sum only."""
    if dst_in_src_order is None or src_row_ptr is None:
        return _dss_impl(src_states, src_idx, row_ptr, num_dst)
    return _DirectSegmentSum.apply(
        src_states, src_idx, row_ptr, dst_in_src_order, src_row_ptr, num_dst
    )


class _DirectSegmentSumSliced(torch.autograd.Function):
    """Backward (the JAX `_dsss_bwd`): ct_src[s] = sum_t ct[bwd_slice_dst[t, s]]
    over t < out_lens[s], a few table gathers and masked adds."""

    @staticmethod
    def forward(ctx, src_states, src_idx, row_ptr, bwd_slice_dst, out_lens, num_dst):
        ctx.save_for_backward(bwd_slice_dst, out_lens)
        ctx.dtype = src_states.dtype
        return _dss_impl(src_states, src_idx, row_ptr, num_dst)

    @staticmethod
    def backward(ctx, ct):
        bwd_slice_dst, out_lens = ctx.saved_tensors
        acc = None
        for t in range(bwd_slice_dst.shape[0]):
            part = ct[bwd_slice_dst[t]] * (out_lens > t).to(ct.dtype)[:, None]
            acc = part if acc is None else acc + part
        return acc.to(ctx.dtype), None, None, None, None, None


def direct_segment_sum_sliced(
    src_states, src_idx, row_ptr, num_dst, bwd_slice_dst=None, out_lens=None
) -> torch.Tensor:
    """`direct_segment_sum` whose backward uses the bounded out-degree slice
    map (`bwd_slice_dst_*` [L_out, num_src], `out_lens_*` [num_src])."""
    if bwd_slice_dst is None or out_lens is None:
        return _dss_impl(src_states, src_idx, row_ptr, num_dst)
    return _DirectSegmentSumSliced.apply(
        src_states, src_idx, row_ptr, bwd_slice_dst, out_lens, num_dst
    )


def direct_segment_sum_dense(src_states: torch.Tensor, dense_inc: torch.Tensor) -> torch.Tensor:
    """out = M @ src_states over the dense incidence (multiplicity) matrix.

    `dense_inc` must already be in src_states' dtype: the caller upcasts the
    int8 matrix once per batch. A library matmul, as XLA's dot is in the JAX
    package (bf16 accumulates in f32, f32 runs full precision); it
    differentiates by autograd (d_states = M^T @ d_out)."""
    return torch.matmul(dense_inc, src_states)


def direct_segment_sum_blocks(
    src_states: torch.Tensor, blocks: torch.Tensor, n_dst_pad: int
) -> torch.Tensor:
    """Block-diagonal batched form of `direct_segment_sum_dense` for merged
    batches of G equal-sized graphs; `blocks` [G, bd, bs] is already in
    src_states' dtype."""
    g, bd, bs = blocks.shape
    d = src_states.shape[-1]
    x = src_states[: g * bs].reshape(g, bs, d)
    out = torch.bmm(blocks, x).reshape(g * bd, d)
    if n_dst_pad > g * bd:
        pad = torch.zeros((n_dst_pad - g * bd, d), dtype=out.dtype, device=out.device)
        out = torch.cat([out, pad], dim=0)
    return out
