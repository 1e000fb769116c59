"""Recurrent cells (GRU / LSTM) and the masked sequence update
(counterpart of `ignnition_tpu/nn/rnn.py`).

GRU follows Keras v2 with `reset_after=True` (bias [2, 3u]); LSTM uses
`unit_forget_bias=True`. Params keep the JAX tree. `cell_step` and the
step loop differentiate by autograd; the GRU scan goes through kernel B
and, in the backward, kernel C (`ops/cuda/rnn_kernels.masked_gru_scan`).
Every sequence update (`masked_update` over padded [N, L, D] sequences,
`masked_update_from_edges` over destination-sorted edge messages) ends in
`masked_update_stacked`, so a GRU takes the kernels on each of them.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.cuda.rnn_kernels import masked_gru_scan
from .layers import glorot_uniform, orthogonal, zeros


def init(generator: torch.Generator, spec, in_dim: int, units: int) -> Dict[str, torch.Tensor]:
    if spec.cell_type == "GRU":
        return {
            "kernel": glorot_uniform(generator, (in_dim, 3 * units)),
            "recurrent_kernel": orthogonal(generator, (units, 3 * units)),
            "bias": zeros((2, 3 * units)),
        }
    if spec.cell_type == "LSTM":
        bias = zeros((4 * units,))
        bias[units : 2 * units] = 1.0  # unit_forget_bias
        return {
            "kernel": glorot_uniform(generator, (in_dim, 4 * units)),
            "recurrent_kernel": orthogonal(generator, (units, 4 * units)),
            "bias": bias,
        }
    raise ValueError(f"unknown recurrent cell type '{spec.cell_type}'")


def _gru_step(params, x, h):
    xw = x @ params["kernel"] + params["bias"][0]
    hw = h @ params["recurrent_kernel"] + params["bias"][1]
    xz, xr, xh = torch.chunk(xw, 3, dim=-1)
    hz, hr, hh = torch.chunk(hw, 3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    hcand = torch.tanh(xh + r * hh)
    return z * h + (1.0 - z) * hcand


def _lstm_step(params, x, h, c):
    zw = x @ params["kernel"] + h @ params["recurrent_kernel"] + params["bias"]
    i, f, g, o = torch.chunk(zw, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def cell_step(spec, params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One cell application (LSTM starts from a zero cell state)."""
    if spec.cell_type == "GRU":
        return _gru_step(params, x, h)
    h_new, _ = _lstm_step(params, x, h, torch.zeros_like(h))
    return h_new


def masked_update_stacked(
    spec,
    params,
    xs: torch.Tensor,  # [max_len, num_dst, dim] time-major slices
    lengths: torch.Tensor,  # [num_dst]
    init_state: torch.Tensor,  # [num_dst, units]
    step_fn=None,
) -> torch.Tensor:
    """Masked recurrent scan over time-major slices; masked steps carry the
    state through. GRU without a per-slice `step_fn` is kernel B with kernel
    C as its backward (`ops/cuda/rnn_kernels.masked_gru_scan`); the rest runs
    step by step."""
    if spec.cell_type == "GRU" and step_fn is None:
        return masked_gru_scan(xs, lengths.to(torch.int32), init_state, params)
    h = init_state
    c = torch.zeros_like(init_state)
    for t in range(xs.shape[0]):
        x = xs[t] if step_fn is None else step_fn(xs[t])
        valid = (t < lengths)[:, None]
        if spec.cell_type == "GRU":
            h = torch.where(valid, _gru_step(params, x, h), h)
        else:
            h_new, c_new = _lstm_step(params, x, h, c)
            h = torch.where(valid, h_new, h)
            c = torch.where(valid, c_new, c)
    return h


def masked_update(
    spec,
    params,
    seq_inputs: torch.Tensor,  # [num_dst, max_len, dim]
    lengths: torch.Tensor,  # [num_dst]
    init_state: torch.Tensor,  # [num_dst, units]
) -> torch.Tensor:
    """The masked scan over padded per-destination sequences: the state after
    each destination's last valid step. Runs as `masked_update_stacked` on
    the time-major transpose."""
    xs = seq_inputs.transpose(0, 1).contiguous()
    return masked_update_stacked(spec, params, xs, lengths, init_state)


class _GatherTimeSlices(torch.autograd.Function):
    """xs[t, d] = messages[min(row_ptr[d] + t, E - 1)], whose transpose is one
    flat gather of the cotangent (the JAX `_gts_bwd`): every real edge e is
    read by exactly the slot (seq[e], dst[e]). Padding edges receive the
    cotangent of the slot their clamped position names; the edge-mask
    multiply upstream of this gather sends those credits to zero."""

    @staticmethod
    def forward(ctx, messages, row_ptr, seq, dst, max_len):
        ctx.save_for_backward(seq, dst)
        e = messages.shape[0]
        t = torch.arange(max_len, device=messages.device, dtype=row_ptr.dtype)
        idx = torch.clamp(row_ptr[None, :] + t[:, None], max=e - 1)  # [L, num_dst]
        return messages[idx.long()]

    @staticmethod
    def backward(ctx, ct):
        seq, dst = ctx.saved_tensors
        l, n, d = ct.shape
        flat = ct.reshape(l * n, d)
        return flat[torch.clamp(seq.long(), max=l - 1) * n + dst.long()], None, None, None, None


def gather_time_slices(
    messages: torch.Tensor,  # [E, dim] destination-sorted, seq-ascending
    row_ptr: torch.Tensor,  # [num_dst] first edge of each destination
    seq: torch.Tensor,  # [E] position of each edge within its destination
    dst: torch.Tensor,  # [E] destination of each edge
    max_len: int,
) -> torch.Tensor:
    """[max_len, num_dst, dim] time slices of a destination-sorted edge-message
    array; slice t row d = messages[row_ptr[d] + t] (clamped to the last
    edge). The backward is one gather (`_GatherTimeSlices`)."""
    return _GatherTimeSlices.apply(messages, row_ptr, seq, dst, int(max_len))


def masked_update_from_edges(
    spec,
    params,
    messages: torch.Tensor,  # [E, dim] destination-sorted, seq-ascending
    row_ptr: torch.Tensor,  # [num_dst] first edge of each destination
    seq: torch.Tensor,  # [E]
    dst: torch.Tensor,  # [E]
    lengths: torch.Tensor,  # [num_dst] real message count per destination
    init_state: torch.Tensor,  # [num_dst, units]
    max_len: int,
) -> torch.Tensor:
    """The ordered update without the host slice map and without the padded
    [num_dst, max_len, dim] sequences: destination d's t-th message is
    messages[row_ptr[d] + t], gathered per time slice, then the masked scan."""
    xs = gather_time_slices(messages, row_ptr, seq, dst, max_len)
    return masked_update_stacked(spec, params, xs, lengths, init_state)
