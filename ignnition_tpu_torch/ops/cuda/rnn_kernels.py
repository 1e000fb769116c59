"""Kernels B and C: the masked GRU scan, forward and backward.

Kernel B replaces the TPU kernel `ignnition_tpu/ops/pallas/rnn_kernels.py`,
`_fwd_call` / `_make_fwd_kernel`, kernel C its backward `_bwd_call` /
`_make_bwd_kernel` (both reached through `masked_gru_scan`). The CUDA
sources are `csrc/gru_scan.cu` and `csrc/gru_scan_bwd.cu`; their header
comments give what bounds each kernel on an H100 (instruction issue on the
CUDA cores) and what the designs do about that.

Contract, the TPU kernels': time-major `xs [L, N, D]`, `lens [N]`,
`h0 [N, u]` and Keras reset_after GRU params (`kernel [D, 3u]`,
`recurrent_kernel [u, 3u]`, `bias [2, 3u]`). h0 and the params are cast to
xs's dtype; h is carried in f32; each step's products take operands
rounded to that dtype and sum in f32; steps with t >= lens[n] carry h
through. Returns the final h in xs's dtype.

`masked_gru_scan` differentiates: a `torch.autograd.Function` joins kernel
B to kernel C, which recomputes the forward and sweeps time in reverse
(gate gradients and the previous carry rounded to xs's dtype before each
product, f32 sums; masked steps pass dh through). Gradients come back in
the dtypes of the inputs, as the TPU kernel's custom backward casts them.
"""

from __future__ import annotations

from typing import Mapping

import torch

from . import _build

launch_count = 0  # launches of kernel B (forward) in this process
bwd_launch_count = 0  # launches of kernel C (backward) in this process

_HOPPER_BLOCK_SMEM = 232448  # bytes of shared memory one block can use


def _cast_params(params: Mapping[str, torch.Tensor], dtype):
    return (
        params["kernel"].to(dtype),
        params["recurrent_kernel"].to(dtype),
        params["bias"].to(dtype),
    )


def masked_gru_scan_plain(
    xs: torch.Tensor, lens: torch.Tensor, h0: torch.Tensor, params
) -> torch.Tensor:
    """The same function in plain PyTorch (the reference of the kernel)."""
    dtype = xs.dtype
    wx, wh, b = (p.to(torch.float32) for p in _cast_params(params, dtype))
    u = h0.shape[1]
    h = h0.to(dtype).to(torch.float32)
    for t in range(xs.shape[0]):
        xw = xs[t].to(torch.float32) @ wx + b[0]
        hw = h.to(dtype).to(torch.float32) @ wh + b[1]
        z = torch.sigmoid(xw[:, :u] + hw[:, :u])
        r = torch.sigmoid(xw[:, u : 2 * u] + hw[:, u : 2 * u])
        hcand = torch.tanh(xw[:, 2 * u :] + r * hw[:, 2 * u :])
        h_new = z * h + (1.0 - z) * hcand
        h = torch.where((lens > t)[:, None], h_new, h)
    return h.to(dtype)


def masked_gru_scan_bwd_plain(xs, lens, h0, params, ct):
    """Gradients of `masked_gru_scan_plain` by autograd (the reference of
    kernel C): (d_xs, d_h0, d_kernel, d_recurrent_kernel, d_bias), each in
    its input's dtype."""
    with torch.enable_grad():
        leaves = [xs.detach().requires_grad_(True), h0.detach().requires_grad_(True)]
        names = ("kernel", "recurrent_kernel", "bias")
        leaves += [params[k].detach().requires_grad_(True) for k in names]
        out = masked_gru_scan_plain(leaves[0], lens, leaves[1], dict(zip(names, leaves[2:])))
        return torch.autograd.grad(out, leaves, ct.to(out.dtype))


def _check_scan_args(xs, lens, h0, wx, wh, b):
    dtype = xs.dtype
    if xs.dim() != 3 or dtype not in _build.DTYPE_CODES:
        raise ValueError(
            f"masked_gru_scan takes 3-D bf16/f32 xs, got {tuple(xs.shape)} {dtype}"
        )
    L, N, D = xs.shape
    U = h0.shape[1]
    if (
        h0.shape != (N, U)
        or wx.shape != (D, 3 * U)
        or wh.shape != (U, 3 * U)
        or b.shape != (2, 3 * U)
        or lens.shape != (N,)
    ):
        raise ValueError(
            "masked_gru_scan shapes disagree: xs "
            f"{tuple(xs.shape)}, lens {tuple(lens.shape)}, h0 {tuple(h0.shape)}, "
            f"kernel {tuple(wx.shape)}, recurrent_kernel {tuple(wh.shape)}, "
            f"bias {tuple(b.shape)}"
        )
    if U > 128:
        raise ValueError(f"masked_gru_scan supports up to 128 units, got {U}")
    for t, name in ((h0, "h0"), (lens, "lens"), (wx, "kernel"),
                    (wh, "recurrent_kernel"), (b, "bias")):
        if t.device != xs.device:
            raise ValueError(f"masked_gru_scan: {name} is on {t.device}, xs on {xs.device}")
    return L, N, D, U


def _launch_forward(xs, lens, h0, wx, wh, b) -> torch.Tensor:
    """Kernel B on contiguous CUDA tensors already in xs's dtype."""
    global launch_count
    _build.check_device(xs, "masked_gru_scan")
    L, N, D, U = _check_scan_args(xs, lens, h0, wx, wh, b)
    smem = 4 * (D + U + 2) * 3 * U
    if smem > _HOPPER_BLOCK_SMEM:
        raise ValueError(
            f"masked_gru_scan: weights need {smem} bytes of shared memory, "
            f"more than a Hopper block has ({_HOPPER_BLOCK_SMEM})"
        )
    if L == 0 or N == 0:
        return h0.clone()
    out = torch.empty((N, U), dtype=xs.dtype, device=xs.device)
    code = _build.library().ign_masked_gru_scan(
        xs.data_ptr(), lens.data_ptr(), h0.data_ptr(), wx.data_ptr(),
        wh.data_ptr(), b.data_ptr(), out.data_ptr(), L, N, D, U,
        _build.DTYPE_CODES[xs.dtype], _build.stream_handle(xs.device),
    )
    _build.check(code, "masked_gru_scan")
    launch_count += 1
    return out


def _launch_backward(xs, lens, h0, wx, wh, b, ct):
    """Kernel C on contiguous CUDA tensors in xs's dtype: (d_xs in that
    dtype; d_h0, d_wx, d_wh, d_b in f32)."""
    global bwd_launch_count
    _build.check_device(xs, "masked_gru_scan backward")
    L, N, D, U = _check_scan_args(xs, lens, h0, wx, wh, b)
    if ct.shape != (N, U) or ct.device != xs.device:
        raise ValueError(
            f"masked_gru_scan backward: cotangent {tuple(ct.shape)} on {ct.device}, "
            f"expected {(N, U)} on {xs.device}"
        )
    dev, dtype = xs.device, xs.dtype
    f32 = torch.float32
    if L == 0 or N == 0:
        zeros = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)
        return (torch.zeros_like(xs), ct.to(f32), zeros(D, 3 * U), zeros(U, 3 * U),
                zeros(2, 3 * U))
    lib = _build.library()
    # warps per block: the most whose per-step stash fits beside the weights
    warps = next(
        (w for w in (8, 4, 2, 1)
         if lib.ign_masked_gru_scan_bwd_smem(L, D, U, w) <= _HOPPER_BLOCK_SMEM),
        None,
    )
    if warps is None:
        raise ValueError(
            f"masked_gru_scan backward: L={L}, D={D}, u={U} need "
            f"{lib.ign_masked_gru_scan_bwd_smem(L, D, U, 1)} bytes of shared memory "
            f"for one row's recompute stash, more than a Hopper block has "
            f"({_HOPPER_BLOCK_SMEM})"
        )
    smem = lib.ign_masked_gru_scan_bwd_smem(L, D, U, warps)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = max(1, min(4, _HOPPER_BLOCK_SMEM // smem))
    blocks = min(-(-N // warps), sms * per_sm)
    rows = L * N
    n_chunks = max(1, min(256, -(-rows // 1024)))
    rows_per_chunk = -(-rows // n_chunks)

    d_xs = torch.empty_like(xs)
    d_h0 = torch.empty((N, U), dtype=f32, device=dev)
    dg = torch.empty((L, N, 4 * U), dtype=dtype, device=dev)
    hprev = torch.empty((L, N, U), dtype=dtype, device=dev)
    bias_part = torch.empty((blocks, 4 * U), dtype=f32, device=dev)
    part = torch.empty((n_chunks, D + U, 3 * U), dtype=f32, device=dev)
    wgrad = torch.empty((D + U, 3 * U), dtype=f32, device=dev)
    d_b = torch.empty((2, 3 * U), dtype=f32, device=dev)
    code = lib.ign_masked_gru_scan_bwd(
        xs.data_ptr(), lens.data_ptr(), h0.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        b.data_ptr(), ct.data_ptr(), d_xs.data_ptr(), d_h0.data_ptr(), dg.data_ptr(),
        hprev.data_ptr(), bias_part.data_ptr(), part.data_ptr(), wgrad.data_ptr(),
        d_b.data_ptr(), L, N, D, U, warps, blocks, n_chunks, rows_per_chunk,
        _build.DTYPE_CODES[dtype], _build.stream_handle(dev),
    )
    _build.check(code, "masked_gru_scan_bwd")
    bwd_launch_count += 1
    return d_xs, d_h0, wgrad[:D], wgrad[D:], d_b


class _MaskedGruScan(torch.autograd.Function):
    """Kernel B forward, kernel C backward, on CUDA tensors in one dtype."""

    @staticmethod
    def forward(ctx, xs, lens, h0, wx, wh, b):
        xs, h0, wx, wh, b = (t.contiguous() for t in (xs, h0, wx, wh, b))
        ctx.save_for_backward(xs, lens, h0, wx, wh, b)
        return _launch_forward(xs, lens, h0, wx, wh, b)

    @staticmethod
    def backward(ctx, ct):
        xs, lens, h0, wx, wh, b = ctx.saved_tensors
        d_xs, d_h0, d_wx, d_wh, d_b = _launch_backward(
            xs, lens, h0, wx, wh, b, ct.to(xs.dtype).contiguous()
        )
        dtype = xs.dtype
        return d_xs, None, d_h0.to(dtype), d_wx.to(dtype), d_wh.to(dtype), d_b.to(dtype)


def masked_gru_scan(
    xs: torch.Tensor, lens: torch.Tensor, h0: torch.Tensor, params
) -> torch.Tensor:
    """Masked GRU scan over time-major slices; returns the final h.
    Differentiable in xs, h0 and the params.

    A CPU tensor takes the plain version (and autograd's backward of it); a
    CUDA tensor launches kernel B, and kernel C in the backward (and raises
    if it cannot)."""
    if xs.device.type == "cpu":
        return masked_gru_scan_plain(xs, lens, h0, params)
    dtype = xs.dtype
    wx, wh, b = _cast_params(params, dtype)
    return _MaskedGruScan.apply(
        xs, lens.to(torch.int32).contiguous(), h0.to(dtype), wx, wh, b
    )
