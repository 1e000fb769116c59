"""Segment and attention primitives of the ported slices (counterpart of
`ignnition_tpu/ops/segment.py`), with the JAX package's hand-written
backwards as `torch.autograd.Function`s over the same host-precomputed
companion arrays: no scatter in any backward, every transpose is a gather
through a host index vector into kernel A or a masked sum of table gathers.

Dtype contract, pinned to the TPU kernels': the sorted sums (`segment_sum`
over sorted ids or with `row_ptr`, `direct_segment_sum*`) return **f32**
whatever the input dtype — the kernel's accumulator. The dense-incidence
products and the attention aggregations over an incidence matrix return
the input dtype, as in the JAX package. The model casts sums back to its
compute dtype before the update. Every backward returns the input's dtype.

Attention over an incidence matrix (`dense_attention_aggregate*`) goes
through kernels D and E (`_flash_masked_softmax_matmul`) at any size; the
matrix-materializing forms (`_dense_masked_softmax_matmul`,
`_blocks_masked_softmax_matmul`) are the JAX package's library routes, kept
as references that no aggregation calls. Per-edge attention
(`sorted_softmax_aggregate`) is two sorted sums through kernel A.

Sharded forms (the JAX `axis_name` argument): `segment_sum`,
`segment_softmax`, `segment_count` and `scatter_to_sequences` take a
process `group` over which the edges are split (the mesh's model axis,
`parallel/steps.py`). Each rank computes its partial over its own block of
edges by the branch it would take alone (sorted ids reach the id-keyed
kernel), and the partial is all-reduced (`_collectives.psum`, which sums
the cotangent in the backward). The builder never hands these functions
row pointers under edge sharding: they describe the whole edge array.

Destination sharding (v2, `parallel/edgeshard.py`): `halo_extend` and
`halo_recv` trade the boundary rows of a node block with the ranks of the
model axis (one `_collectives.all_to_all`), and `graph_pool(group=)`
combines each rank's per-graph partials.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ._collectives import all_to_all, all_to_all_start, pmax, psum
from .cuda import set_mode
from .cuda.attention_kernels import flash_gat_backward, flash_gat_forward
from .cuda.segment_kernels import (
    sorted_segment_sum_csr,
    sorted_segment_sum_csr_windows,
    sorted_segment_sum_ids,
)

def set_pallas_mode(mode: str) -> None:
    """The mode of kernel A, its windowed form and the id-keyed kernel, and
    with the flash-attn switch of D and E: 'auto', 'never' or 'always' (the
    JAX package's `set_pallas_mode`; the table is `ops.cuda`'s)."""
    set_mode("pallas", mode)


def _whole_sort_perm(sort_perm: torch.Tensor, n_windows: int) -> torch.Tensor:
    """The windowed slice sort's permutation with indices into the whole
    slot table: the data layer sorts the slots within ~equal windows and
    emits indices local to each window. Made once per permutation tensor and
    kept on it (a batch keeps its tensors over iterations and steps), so a
    step pays one gather, not this arithmetic. A captured step reads its
    graph's own input buffers, on which no eager call made a cache, and each
    replay recomputes what its capture cached there (`training.capture`)."""
    cached = getattr(sort_perm, "_whole_sort_perm", None)
    if cached is not None and cached[0] == (n_windows, sort_perm._version):
        return cached[1]
    n_slots = sort_perm.shape[0]
    w = -(-n_slots // n_windows)
    slot = torch.arange(n_slots, device=sort_perm.device, dtype=torch.int64)
    whole = sort_perm.to(torch.int64) + (slot // w) * w
    sort_perm._whole_sort_perm = ((n_windows, sort_perm._version), whole)
    return whole


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
        l, n, d = ct.shape
        # one gather into source order, one launch of kernel A, which adds a
        # source's rows of every window
        sorted_ct = ct.reshape(l * n, d)[sort_perm]
        ct_states = sorted_segment_sum_csr_windows(sorted_ct, sort_row_ptr, ctx.n_src)
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
    `slice_sort_row_ptr_*` of `build_batch`) the backward is one gather of
    the cotangent rows into source order and one launch of kernel A. Past
    `_SLICE_SORT_CHUNK` slots the data layer sorts within windows (local
    indices, a set of row pointers per window): the permutation is made
    whole once per batch and kernel A adds the windows in the same launch,
    where the JAX function sums `windows * n_src` segments and reduces
    them. Invalid slots point at the last source row and carry
    zero cotangent from the masked scan. `sort_ids` is the JAX function's
    argument for its id-based CPU sum; kernel A needs the row pointers only.
    Without companions (serving) the gather differentiates by autograd's
    scatter-add; a forward that records no graph (serving, inference mode)
    is the plain gather."""
    if (
        sort_perm is None
        or sort_row_ptr is None
        or not (torch.is_grad_enabled() and states.requires_grad)
    ):
        return states[slice_src]
    n_windows = (sort_row_ptr.shape[0] - 1) // states.shape[0]
    if n_windows > 1:
        sort_perm = _whole_sort_perm(sort_perm, n_windows)
    return _GatherStateSlices.apply(states, slice_src, sort_perm, sort_row_ptr)


class _GatherRows(torch.autograd.Function):
    """`states[idx]` whose transpose is the sorted segment sum of `ct[perm]`
    over `row_ptr` (the JAX `_gr_bwd`): kernel A on the card."""

    @staticmethod
    def forward(ctx, states, idx, perm, row_ptr):
        ctx.save_for_backward(idx, perm, row_ptr)
        ctx.n, ctx.dtype = states.shape[0], states.dtype
        return states[idx]

    @staticmethod
    def backward(ctx, ct):
        idx, perm, row_ptr = ctx.saved_tensors
        out = segment_sum(ct[perm], idx[perm], ctx.n, row_ptr=row_ptr)
        return out.to(ctx.dtype), None, None, None


def gather_rows(
    states: torch.Tensor,
    idx: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    row_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Row gather `states[idx]`. With a host-precomputed stable sort `perm` of
    `idx` and its CSR pointers (`src_perm_*`, `src_row_ptr_*` of
    `build_batch`) the backward is a sorted segment sum instead of autograd's
    scatter-add. The pointers cover real edges only: padding edges, which
    sort last, get no cotangent back, so theirs must be zero."""
    if perm is None or row_ptr is None:
        return states[idx]
    return _GatherRows.apply(states, idx, perm, row_ptr)


def segment_count(
    segment_ids: torch.Tensor, num_segments: int, mask: torch.Tensor, group=None
) -> torch.Tensor:
    """Number of real edges per segment (the sum of `mask` by segment), in
    `mask`'s dtype: the in-degrees of a batch made without its `lens_*`
    companions. With `group`, over every rank's edges."""
    out = torch.zeros(num_segments, dtype=mask.dtype, device=mask.device)
    return psum(out.index_add_(0, segment_ids, mask), group)


def scatter_to_sequences(
    messages: torch.Tensor,  # [E, D], zero on padding edges
    dst_idx: torch.Tensor,  # [E]
    seq: torch.Tensor,  # [E] position within the destination
    num_dst: int,
    max_len: int,
    group=None,
) -> torch.Tensor:
    """The padded per-destination sequences [num_dst, max_len, D] of the
    generic sequence path. An additive scatter over the flat slot index:
    real (dst, seq) slots are unique and padding edges carry zero messages,
    so adding is setting. Its backward is autograd's gather. With `group`,
    each rank scatters its edges' slots and the padded blocks are summed
    (the slots are disjoint: the sum is their union)."""
    d = messages.shape[-1]
    flat = dst_idx * max_len + seq
    out = torch.zeros((num_dst * max_len, d), dtype=messages.dtype, device=messages.device)
    return psum(out.index_add(0, flat, messages), group).reshape(num_dst, max_len, d)


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    row_ptr: Optional[torch.Tensor] = None,
    indices_are_sorted: bool = False,
    group=None,
) -> torch.Tensor:
    """Sum rows of `data` into `num_segments` buckets (with `group`, the
    rows of every rank's block: each rank's sum, all-reduced).

    With `row_ptr` (destination-sorted edges, CSR pointers over real edges)
    and a width that divides 128 this is kernel A: padding edges are never
    read and the sum is f32. At any other width, or for sorted ids without
    `row_ptr` (`indices_are_sorted`), it is the id-keyed kernel
    (`sorted_segment_sum_ids`: one launch that finds each row's edges in
    the sorted ids itself), also f32, which counts every edge: padding
    rows must already be zero. That split is the TPU function's
    (`sorted_segment_sum_csr` there). Unsorted ids keep the input dtype
    (XLA's segment sum in the JAX package; `index_add_` here), padding rows
    zero as well."""
    return psum(_local_segment_sum(data, segment_ids, num_segments, row_ptr,
                                   indices_are_sorted), group)


def _local_segment_sum(data, segment_ids, num_segments, row_ptr, indices_are_sorted):
    if row_ptr is not None:
        if row_ptr.shape[0] != num_segments + 1:
            raise ValueError(
                f"row_ptr has {row_ptr.shape[0]} entries for {num_segments} segments"
            )
        if data.dim() == 2 and 128 % data.shape[1] != 0:
            return sorted_segment_sum_ids(data, segment_ids, num_segments)
        return sorted_segment_sum_csr(data, row_ptr)
    if indices_are_sorted and data.dim() == 2:
        return sorted_segment_sum_ids(data, segment_ids, num_segments)
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device
    )
    return out.index_add_(0, segment_ids, data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The largest row of `data` in each segment (along the first axis), -inf
    where a segment has no row (`jax.ops.segment_max`); the library's
    `scatter_reduce`. Its callers detach it: a softmax does not depend on
    the shift."""
    index = segment_ids.to(torch.int64).reshape((-1,) + (1,) * (data.dim() - 1))
    out = torch.full(
        (num_segments,) + tuple(data.shape[1:]), float("-inf"), dtype=data.dtype,
        device=data.device,
    )
    return out.scatter_reduce(0, index.expand_as(data), data, "amax", include_self=False)


def segment_softmax(
    scores: torch.Tensor,  # [E] or [E, 1]
    segment_ids: torch.Tensor,  # [E]
    num_segments: int,
    mask: torch.Tensor,  # [E], 1 on real edges
    group=None,
) -> torch.Tensor:
    """Per-segment softmax of edge scores over unsorted ids (the JAX
    `segment_softmax`): stabilized by each segment's max over its real
    edges, detached as JAX's `stop_gradient` does; masked edges get weight 0
    and an empty segment all-zero weights. In scores' dtype. With `group`,
    the max and the denominator span every rank's edges, while the weights
    stay those of this rank's."""
    scores = scores.reshape(-1)
    on = mask > 0
    masked = torch.where(on, scores, torch.full_like(scores, torch.finfo(scores.dtype).min))
    seg_max = pmax(segment_max(masked.detach(), segment_ids, num_segments), group)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    exp = torch.where(on, torch.exp(masked - seg_max[segment_ids]), torch.zeros_like(scores))
    denom = segment_sum(exp, segment_ids, num_segments, group=group)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return exp / denom[segment_ids]


def _pool_ids(graph_ids: torch.Tensor, num_graphs: int, node_mask: torch.Tensor) -> torch.Tensor:
    """Each row's graph for the id-keyed sum: a real row's own, a padding
    row's that of the next real row (`num_graphs` after the last one), from
    the real rows' count per graph and a running count of real rows: a few
    elementwise kernels and no sync with the host. The padding rows' own ids
    (`num_graphs - 1` in the data layer) would put the trailing padding in
    the last graph's segment, which one CTA then walks."""
    real = (node_mask > 0).to(torch.int64)
    ends = torch.cumsum(segment_count(graph_ids, num_graphs, real), 0)
    before = torch.cumsum(real, 0) - real
    return torch.where(real > 0, graph_ids.to(torch.int64),
                       torch.searchsorted(ends, before, right=True))


def graph_pool(
    x: torch.Tensor,  # [N, D]
    graph_ids: torch.Tensor,  # [N]
    num_graphs: int,
    node_mask: torch.Tensor,  # [N]
    kind: str,
    group=None,
) -> torch.Tensor:
    """Per-graph pooling (sum | mean | max) over node rows, the JAX
    `graph_pool`. Rows are masked first, and the masked product takes JAX's
    dtype (bf16 rows times the f32 mask: f32).

    `sum` and `mean` are one launch of the id-keyed kernel (mean carries the
    mask as one more column, whose sums are the real-row counts); the JAX
    package sums with XLA's segment sum, the same function in another
    order. The kernel needs ids that never decrease and reads each graph's
    rows in one CTA: real rows are sorted by graph (the caller checks it on
    the host), and each padding row is keyed by the graph of the next real
    row (`_pool_ids`), so that padding between graphs (per-graph padding)
    keeps the order and trailing padding, keyed past the last graph, is
    never read. `max` is the library's `scatter_reduce` over rows filled
    with the dtype's lowest value where masked, its backward splitting the
    cotangent among tied rows as JAX's `segment_max` does; graphs that are
    empty or all masked give 0.

    group: the model axis of destination sharding (the JAX `axis_name`):
    `x` holds this rank's block of rows, and the per-graph partials combine
    over the group. Sum and mean all-reduce the sums (mean its sums and its
    counts, so it stays exact). Max takes the detached largest over the
    ranks, then adds a zero-valued residual that routes the cotangent to the
    rows holding it: each rank's local maximum less its detached self,
    weighted by the rank's share of the rows that tie with the global max,
    and all-reduced (cross-rank ties split the cotangent as the serial
    `segment_max` does)."""
    xm = x * node_mask[:, None]
    if kind in ("sum", "mean"):
        ids = _pool_ids(graph_ids, num_graphs, node_mask)
        if kind == "sum":
            return psum(sorted_segment_sum_ids(xm, ids, num_graphs).to(xm.dtype), group)
        cols = torch.cat([xm, node_mask[:, None].to(xm.dtype)], dim=1)
        sums = psum(sorted_segment_sum_ids(cols, ids, num_graphs).to(xm.dtype), group)
        return sums[:, :-1] / torch.clamp_min(sums[:, -1:], 1.0)
    if kind == "max":
        low = torch.finfo(x.dtype).min
        on = node_mask[:, None] > 0
        xmasked = torch.where(on, x, torch.full_like(x, low))
        index = graph_ids.to(torch.int64)[:, None].expand_as(x)
        out = torch.full((num_graphs, x.shape[1]), low, dtype=x.dtype, device=x.device)
        m = out.scatter_reduce(0, index, xmasked, "amax", include_self=False)
        if group is not None:
            g = pmax(m, group)
            ties = (on & (xmasked >= g[graph_ids.to(torch.int64)])).to(torch.float32)
            t_loc = segment_sum(ties, graph_ids.to(torch.int64), num_graphs)
            w = t_loc / torch.clamp_min(psum(t_loc, group), 1.0)
            residual = torch.where(m >= g, m - m.detach(), torch.zeros_like(m)) * w
            m = g + psum(residual, group)
        count = segment_count(graph_ids, num_graphs, node_mask, group=group)
        return torch.where(torch.isfinite(m) & (count[:, None] > 0), m, torch.zeros_like(m))
    raise ValueError(f"unknown pooling kind '{kind}'")


def halo_extend(table: torch.Tensor, send_idx: torch.Tensor, group) -> torch.Tensor:
    """The destination-sharded boundary exchange (the JAX `halo_extend`):
    `table` is this rank's block [B, D] of a node table, `send_idx`
    [n_ranks, H] the rows it sends to each rank of `group` (the host-built
    `halo_send_*`; padding slots read row 0). The rows each peer needs are
    gathered, traded with one `all_to_all`, and appended:
    concat([table, halo]) [B + n_ranks * H, D], so that a remapped source
    index reads a received row at B + owner * H + slot. In the backward the
    cotangent of a received row goes back to its owner and is added into
    its row (autograd's gather backward accumulates: a row sent to several
    peers receives the sum of their cotangents)."""
    return torch.cat([table, halo_recv(table, send_idx, group)], 0)


def halo_recv(table: torch.Tensor, send_idx: torch.Tensor, group,
              wait: bool = True):
    """The halo rows alone [n_ranks * H, D] (the JAX `halo_recv`), for the
    interior/boundary overlap of the builder's `_halo_gather`. With
    wait=False the exchange is only issued: the caller gets the pending
    exchange (`_collectives.all_to_all_start`) and reads its rows through
    `_collectives.all_to_all_wait`, once the work that overlaps it has been
    issued. The send gather is `index_select`, whose backward adds with
    atomics: the padding slots all read row 0, and a sorted scatter-add
    would walk them one at a time."""
    send = torch.index_select(table, 0, send_idx.to(torch.int64).reshape(-1))  # [n_ranks * H, D]
    if wait:
        return all_to_all(send, group)
    return all_to_all_start(send, group)


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


# --------------------------------------------------------------------------
# attention over an incidence matrix
# --------------------------------------------------------------------------


def _flash_stab(ssrc: torch.Tensor, sdst: torch.Tensor) -> torch.Tensor:
    """Per-row score bound lrelu(sdst[d] + max ssrc) >= every e[d, s], for
    `ssrc [G, bs]`, `sdst [G, bd]` (the max per graph). LeakyReLU is
    monotone, so no pass over the matrix is needed; exp(e - stab) <= 1 never
    overflows, and a destination's own score can never underflow its row.
    Non-finite bounds fall back to 0, as in the JAX package."""
    sup = ssrc.to(torch.float32).amax(dim=1, keepdim=True)
    sup = torch.where(torch.isfinite(sup), sup, torch.zeros_like(sup))
    s = F.leaky_relu(sdst.to(torch.float32) + sup, 0.2)
    return torch.where(torch.isfinite(s), s, torch.zeros_like(s))


class _FlashMaskedSoftmaxMatmul(torch.autograd.Function):
    """Kernel D forward, kernel E backward (the JAX `_flash_fwd` /
    `_flash_bwd` and their blocks forms): residuals are vectors and the
    inputs, every attention entry is recomputed in the backward."""

    @staticmethod
    def forward(ctx, ssrc, sdst, msg_table, blocks):
        g, bd, bs = blocks.shape
        ssrc3, sdst3 = ssrc.reshape(g, bs), sdst.reshape(g, bd)
        x = msg_table.reshape(g, bs, -1)
        stab = _flash_stab(ssrc3, sdst3)
        out, den = flash_gat_forward(ssrc3, sdst3, x, blocks, stab)
        ctx.save_for_backward(ssrc3, sdst3, x, blocks, out, den, stab)
        ctx.dtypes = (ssrc.dtype, sdst.dtype)
        return out.reshape(g * bd, -1)

    @staticmethod
    def backward(ctx, ct):
        ssrc3, sdst3, x, blocks, out, den, stab = ctx.saved_tensors
        g, bd, bs = blocks.shape
        ct3 = ct.reshape(g, bd, -1)
        # sum_s dA[d,s] A[d,s] = ct[d] . out[d]: the softmax row statistic
        srow = (ct3.to(torch.float32) * out.to(torch.float32)).sum(dim=2)
        dtab_plus, d_sdst = flash_gat_backward(ssrc3, sdst3, x, blocks, stab, den, ct3, srow)
        return (
            dtab_plus[:, :, -1].reshape(g * bs).to(ctx.dtypes[0]),
            d_sdst.reshape(g * bd).to(ctx.dtypes[1]),
            dtab_plus[:, :, :-1].reshape(g * bs, -1).to(x.dtype),
            None,
        )


def _flash_masked_softmax_matmul(ssrc, sdst, msg_table, incidence) -> torch.Tensor:
    """out[d] = sum_s A[d, s] msg_table[s], A the row softmax of
    LeakyReLU(sdst[d] + ssrc[s]) over the support of the incidence matrix
    (multiplicity-weighted), through kernels D and E. `incidence` is one
    matrix [n_dst, n_src] or per-graph blocks [G, bd, bs] over the first
    G*bs sources and G*bd destinations; int8 or bf16, never upcast."""
    if incidence.dim() == 2:
        incidence = incidence[None]
    return _FlashMaskedSoftmaxMatmul.apply(ssrc, sdst, msg_table, incidence)


def _masked_attention(ssrc3, sdst3, blocks, dtype):
    """The [G, bd, bs] attention tensor in `dtype` (the JAX `_dmsm_attn` /
    `_bmsm_attn`): the masked row max is lrelu(sdst + masked row max of
    ssrc), LeakyReLU being monotone."""
    neg = -1e30
    srcf = ssrc3.to(torch.float32)[:, None, :]
    dstf = sdst3.to(torch.float32)[:, :, None]
    on = blocks > 0
    sup = torch.where(on, srcf, torch.full_like(srcf, neg)).amax(dim=2)
    row_max = F.leaky_relu(dstf[:, :, 0] + sup, 0.2).clamp_min(neg * 0.5)
    e = F.leaky_relu(dstf + srcf, 0.2)
    z = torch.where(on, torch.exp(e - row_max[:, :, None]), torch.zeros_like(e))
    z = z * blocks.to(torch.float32)
    return (z / z.sum(dim=2).clamp_min(1e-30)[:, :, None]).to(dtype)


def _f32_bmm(a, b):
    """Batched product of two tensors of one dtype, f32 out (the JAX `_dot`
    / `_bdot` with `preferred_element_type=float32`)."""
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


class _BlocksMaskedSoftmaxMatmul(torch.autograd.Function):
    """The matrix-materializing form with the JAX package's matmul-factored
    backward (`_bmsm_bwd`; `_dmsm_bwd` is its G = 1 case): with
    W = A * LeakyReLU'(pre), the row statistic and both score gradients
    collapse into products against A and W."""

    @staticmethod
    def forward(ctx, ssrc, sdst, msg_table, blocks):
        g, bd, bs = blocks.shape
        ctx.save_for_backward(ssrc, sdst, msg_table, blocks)
        dtype = msg_table.dtype
        a = _masked_attention(ssrc.reshape(g, bs), sdst.reshape(g, bd), blocks, dtype)
        out = _f32_bmm(a, msg_table.reshape(g, bs, -1))
        return out.reshape(g * bd, -1).to(dtype)

    @staticmethod
    def backward(ctx, ct):
        ssrc, sdst, msg_table, blocks = ctx.saved_tensors
        g, bd, bs = blocks.shape
        dtype, f32 = msg_table.dtype, torch.float32
        ssrc3, sdst3 = ssrc.reshape(g, bs), sdst.reshape(g, bd)
        a = _masked_attention(ssrc3, sdst3, blocks, dtype)
        pre = sdst3.to(f32)[:, :, None] + ssrc3.to(f32)[:, None, :]
        w = (a.to(f32) * torch.where(pre > 0, 1.0, 0.2)).to(dtype)
        ct3 = ct.reshape(g, bd, -1).to(dtype)
        x = msg_table.reshape(g, bs, -1)

        d_table = _f32_bmm(a.transpose(1, 2), ct3).reshape(g * bs, -1).to(dtype)
        out_rec = _f32_bmm(a, x)
        s_row = (ct3.to(f32) * out_rec).sum(dim=2)  # [g, bd]

        xe = torch.cat([x, torch.ones((g, bs, 1), dtype=dtype, device=x.device)], dim=2)
        wx = _f32_bmm(w, xe)  # [g, bd, D+1]
        d_sdst = (ct3.to(f32) * wx[:, :, :-1]).sum(dim=2) - s_row * wx[:, :, -1]

        cts = torch.cat([ct3, s_row[:, :, None].to(dtype)], dim=2)
        wt = _f32_bmm(w.transpose(1, 2), cts)  # [g, bs, D+1]
        d_ssrc = (x.to(f32) * wt[:, :, :-1]).sum(dim=2) - wt[:, :, -1]
        return (
            d_ssrc.reshape(g * bs).to(ssrc.dtype),
            d_sdst.reshape(g * bd).to(sdst.dtype),
            d_table,
            None,
        )


def _blocks_masked_softmax_matmul(ssrc, sdst, msg_table, blocks) -> torch.Tensor:
    """`_flash_masked_softmax_matmul`'s function over [G, bd, bs] blocks by
    materializing the attention tensor and library products."""
    return _BlocksMaskedSoftmaxMatmul.apply(ssrc, sdst, msg_table, blocks)


def _dense_masked_softmax_matmul(ssrc, sdst, msg_table, dense_inc) -> torch.Tensor:
    """The same over one [n_dst, n_src] matrix."""
    return _BlocksMaskedSoftmaxMatmul.apply(ssrc, sdst, msg_table, dense_inc[None])


def _attention_scores(msg_table, dst_states, kernel1, kernel2, attn_kernel):
    """Per-node GATv1 score scalars (ssrc [n_src], sdst [n_dst]) in f32:
    e[d, s] = LeakyReLU(a1 . (K1 m_s) + a2 . (K2 h_d)). The a1 / a2 products
    take f32 copies of their operands: the JAX `_dot` returns f32 from bf16
    operands, `torch.matmul` would return bf16."""
    d1 = kernel1.shape[1]
    f32 = torch.float32
    ssrc = (msg_table @ kernel1).to(f32) @ attn_kernel[:d1].to(f32)
    sdst = (dst_states @ kernel2).to(f32) @ attn_kernel[d1:].to(f32)
    return ssrc[:, 0], sdst[:, 0]


def dense_attention_aggregate(
    msg_table, dst_states, dense_inc, kernel1, kernel2, attn_kernel
) -> torch.Tensor:
    """GAT attention aggregation computed over the dense incidence matrix:
    two per-node score products, then one masked softmax-matmul over
    [n_dst, n_src] (kernels D and E). Multiplicity k counts as k identical
    softmax terms, the per-edge semantics."""
    ssrc, sdst = _attention_scores(msg_table, dst_states, kernel1, kernel2, attn_kernel)
    return _flash_masked_softmax_matmul(ssrc, sdst, msg_table, dense_inc)


def dense_attention_aggregate_blocks(
    msg_table, dst_states, blocks, kernel1, kernel2, attn_kernel, n_dst_pad: int
) -> torch.Tensor:
    """Block-diagonal form of `dense_attention_aggregate` for merged batches
    of G equal-sized graphs: the graph axis is a grid dimension of kernels D
    and E. Rows past G*bd come out zero."""
    g, bd, bs = blocks.shape
    ssrc, sdst = _attention_scores(msg_table, dst_states, kernel1, kernel2, attn_kernel)
    out = _flash_masked_softmax_matmul(
        ssrc[: g * bs], sdst[: g * bd], msg_table[: g * bs], blocks
    )
    if n_dst_pad > g * bd:
        pad = torch.zeros((n_dst_pad - g * bd, out.shape[-1]), dtype=out.dtype, device=out.device)
        out = torch.cat([out, pad], dim=0)
    return out


# --------------------------------------------------------------------------
# per-edge attention over a destination-sorted edge list
# --------------------------------------------------------------------------


class _GatherByDst(torch.autograd.Function):
    """`values[dst_idx]` whose transpose is a sorted segment sum over
    `row_ptr` (the JAX `_gbd_bwd`)."""

    @staticmethod
    def forward(ctx, values, dst_idx, row_ptr):
        ctx.save_for_backward(dst_idx, row_ptr)
        ctx.n, ctx.dtype = values.shape[0], values.dtype
        return values[dst_idx]

    @staticmethod
    def backward(ctx, ct):
        dst_idx, row_ptr = ctx.saved_tensors
        ct2 = ct if ct.dim() == 2 else ct[:, None]
        out = segment_sum(ct2, dst_idx, ctx.n, row_ptr=row_ptr).to(ctx.dtype)
        return (out if ct.dim() == 2 else out[:, 0]), None, None


def gather_by_dst(values: torch.Tensor, dst_idx: torch.Tensor, row_ptr: torch.Tensor):
    """values[dst_idx] for a destination-sorted edge list; the backward is
    kernel A instead of autograd's scatter-add. Padding edges get no
    cotangent back (they lie past `row_ptr[-1]`), so theirs must be zero."""
    return _GatherByDst.apply(values, dst_idx, row_ptr)


def _masked_exp(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exp(score - global max over real edges), zero on padding edges. exp
    never sees a masked score (one far above the real max would overflow)."""
    on = mask > 0
    stab = torch.where(on, scores, torch.full_like(scores, float("-inf"))).max()
    stab = torch.where(torch.isfinite(stab), stab, torch.zeros_like(stab))
    safe = torch.where(on, scores, stab)
    return torch.where(on, torch.exp(safe - stab), torch.zeros_like(scores))


def sorted_segment_softmax(scores, dst_idx, num_segments: int, mask, row_ptr) -> torch.Tensor:
    """Per-destination softmax over sorted edge scores without a scatter:
    stabilized by the **global** max as in the JAX package (a destination
    whose best score lies ~88 nats below it would underflow); denominators
    through kernel A, their gather back through `gather_by_dst`."""
    exp = _masked_exp(scores.reshape(-1), mask)
    denom = segment_sum(exp[:, None], dst_idx, num_segments, row_ptr=row_ptr)[:, 0]
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return exp / gather_by_dst(denom, dst_idx, row_ptr).to(exp.dtype)


def sorted_softmax_aggregate(
    messages, scores, dst_idx, num_segments: int, mask, row_ptr
) -> torch.Tensor:
    """out[d] = sum_e exp(s_e) m_e / sum_e exp(s_e) over each destination's
    edges: two sorted segment sums (width D and, as in the JAX package,
    width 8 for the denominator) and a per-node division; the per-edge
    weights are never formed. Global-max stabilization as above. f32 out."""
    exp = _masked_exp(scores.reshape(-1), mask)
    num = segment_sum(
        messages * exp[:, None].to(messages.dtype), dst_idx, num_segments, row_ptr=row_ptr
    )
    exp8 = exp[:, None].expand(exp.shape[0], 8)
    den = segment_sum(exp8, dst_idx, num_segments, row_ptr=row_ptr)[:, :1]
    return num / torch.where(den > 0, den, torch.ones_like(den)).to(num.dtype)
