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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .cuda.attention_kernels import flash_gat_backward, flash_gat_forward
from .cuda.segment_kernels import sorted_segment_sum_csr, sorted_segment_sum_ids


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
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Sum rows of `data` into `num_segments` buckets.

    With `row_ptr` (destination-sorted edges, CSR pointers over real edges)
    and a width that divides 128 this is kernel A: padding edges are never
    read and the sum is f32. At any other width, or for sorted ids without
    `row_ptr` (`indices_are_sorted`), it is the id-keyed sum over kernel A
    (`sorted_segment_sum_ids`), also f32, which counts every edge: padding
    rows must already be zero. That split is the TPU function's
    (`sorted_segment_sum_csr` there). Unsorted ids keep the input dtype
    (XLA's segment sum in the JAX package; `index_add_` here), padding rows
    zero as well."""
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
