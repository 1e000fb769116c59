"""Kernels B and C: the masked GRU scan, forward and backward.

Kernel B replaces the TPU kernel `ignnition_tpu/ops/pallas/rnn_kernels.py`,
`_fwd_call` / `_make_fwd_kernel`, kernel C its backward `_bwd_call` /
`_make_bwd_kernel` (both reached through `masked_gru_scan`). The CUDA
sources are `csrc/gru_scan.cu` (with the tensor-core tile step in
`csrc/gru_tile_mma.cuh`) and `csrc/gru_scan_bwd.cu`; their header comments
give what bounds each kernel on an H100 and what the designs do about that.
Kernel B has two instances, chosen by (dtype, u) before launch (the rule
is `forward_instance`): bf16 runs on tensor cores (mma.sync, one warp per 16 rows), f32 on
the CUDA cores (one warp per row), as the TPU kernel runs f32 at
Precision.HIGHEST. Kernel C's sweep likewise (the rule is
`backward_instance`): bf16 at u <= 32 on tensor cores, with B's tile step
and a device-memory stash of the carry (scratch `hstash`), everything else
on the CUDA cores; its weight-gradient and finalize kernels serve both.

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

import functools
import re
from typing import Mapping

import torch

from . import _build, takes_plain
from . import set_mode as cuda_set_mode

# launches made from Python in this process, eager or recorded into a CUDA
# graph; a graph's replays launch again uncounted (`ops.cuda`)
launch_count = 0  # launches of kernel B (forward)
bwd_launch_count = 0  # launches of kernel C (backward)

def set_mode(mode: str) -> None:
    """The mode of kernels B and C, 'auto', 'never' or 'always' (the JAX
    package's `rnn_kernels.set_mode`; the table is `ops.cuda`'s)."""
    cuda_set_mode("fused-rnn", mode)


_HOPPER_BLOCK_SMEM = 232448  # bytes of shared memory one block can use
_SWEEP_MMA_WARPS = 4  # warps a block of C's tensor-core sweep (kSweepMmaWarps)


def _cast_params(params: Mapping[str, torch.Tensor], dtype):
    return (
        params["kernel"].to(dtype),
        params["recurrent_kernel"].to(dtype),
        params["bias"].to(dtype),
    )


def masked_gru_scan_plain(
    xs: torch.Tensor, lens: torch.Tensor, h0: torch.Tensor, params
) -> torch.Tensor:
    """The same function in plain PyTorch (the reference of the kernel): f32
    arithmetic over operands rounded to the input dtype, f64 for f64 input."""
    dtype = xs.dtype
    acc = torch.promote_types(dtype, torch.float32)
    wx, wh, b = (p.to(acc) for p in _cast_params(params, dtype))
    u = h0.shape[1]
    h = h0.to(dtype).to(acc)
    for t in range(xs.shape[0]):
        xw = xs[t].to(acc) @ wx + b[0]
        hw = h.to(dtype).to(acc) @ wh + b[1]
        z = torch.sigmoid(xw[:, :u] + hw[:, :u])
        r = torch.sigmoid(xw[:, u : 2 * u] + hw[:, u : 2 * u])
        hcand = torch.tanh(xw[:, 2 * u :] + r * hw[:, 2 * u :])
        h_new = z * h + (1.0 - z) * hcand
        h = torch.where((lens > t)[:, None], h_new, h)
    return h.to(dtype)


def masked_gru_scan_bwd_plain(xs, lens, h0, params, ct):
    """Gradients of `masked_gru_scan_plain` by autograd (the reference of
    kernel C): (d_xs, d_h0, d_kernel, d_recurrent_kernel, d_bias), each in
    its input's dtype (None for an input that no step reads: L = 0)."""
    with torch.enable_grad():
        leaves = [xs.detach().requires_grad_(True), h0.detach().requires_grad_(True)]
        names = ("kernel", "recurrent_kernel", "bias")
        leaves += [params[k].detach().requires_grad_(True) for k in names]
        out = masked_gru_scan_plain(leaves[0], lens, leaves[1], dict(zip(names, leaves[2:])))
        return torch.autograd.grad(out, leaves, ct.to(out.dtype), allow_unused=True)


def masked_gru_scan_bwd_kernel_plain(xs, lens, h0, params, ct):
    """Kernel C's function in plain PyTorch, with the TPU kernel's rounding
    (`_make_bwd_kernel`): the forward recomputed in f32 from operands rounded
    to xs's dtype, then the reverse sweep with the gate gradients `d_xw`,
    `d_hw` and the carry `hprev` rounded to that dtype before each product,
    every sum in f32 and the bias gradients summed from the unrounded gate
    gradients. Autograd through `masked_gru_scan_plain`
    (`masked_gru_scan_bwd_plain`) rounds the h-path product instead; in f32
    the two agree. Returns (d_xs, d_h0, d_kernel, d_recurrent_kernel,
    d_bias), each in its input's dtype."""
    dtype, f32 = xs.dtype, torch.float32
    rnd = lambda t: t.to(dtype).to(f32)
    wx, wh, b = (p.to(f32) for p in _cast_params(params, dtype))
    u = h0.shape[1]
    h = rnd(h0)
    stash = []
    for t in range(xs.shape[0]):
        xw = xs[t].to(f32) @ wx + b[0]
        hw = rnd(h) @ wh + b[1]
        z = torch.sigmoid(xw[:, :u] + hw[:, :u])
        r = torch.sigmoid(xw[:, u : 2 * u] + hw[:, u : 2 * u])
        hh = hw[:, 2 * u :]
        hc = torch.tanh(xw[:, 2 * u :] + r * hh)
        stash.append((h, z, r, hc, hh))
        h = torch.where((lens > t)[:, None], z * h + (1.0 - z) * hc, h)

    dh = rnd(ct)
    d_wx, d_wh = torch.zeros_like(wx), torch.zeros_like(wh)
    d_b = torch.zeros_like(b)
    d_xs = torch.empty_like(xs, dtype=dtype)
    for t in range(xs.shape[0] - 1, -1, -1):
        hprev, z, r, hc, hh = stash[t]
        valid = (lens > t)[:, None]
        dh_upd = torch.where(valid, dh, 0.0)
        dh_carry = torch.where(valid, 0.0, dh)
        da_c = dh_upd * (1.0 - z) * (1.0 - hc * hc)
        da_z = dh_upd * (hprev - hc) * z * (1.0 - z)
        da_r = da_c * hh * r * (1.0 - r)
        d_xw = torch.cat([da_z, da_r, da_c], dim=1)
        d_hw = torch.cat([da_z, da_r, da_c * r], dim=1)
        d_wx += xs[t].to(f32).T @ rnd(d_xw)
        d_wh += rnd(hprev).T @ rnd(d_hw)
        d_b[0] += d_xw.sum(dim=0)
        d_b[1] += d_hw.sum(dim=0)
        d_xs[t] = (rnd(d_xw) @ wx.T).to(dtype)
        dh = rnd(d_hw) @ wh.T + dh_upd * z + dh_carry
    return (
        d_xs,
        dh.to(dtype).to(h0.dtype),
        d_wx.to(dtype).to(params["kernel"].dtype),
        d_wh.to(dtype).to(params["recurrent_kernel"].dtype),
        d_b.to(dtype).to(params["bias"].dtype),
    )


MAX_UNITS = 128


def forward_instance(dtype: torch.dtype, units: int) -> str:
    """The instance of kernel B that serves a call of `dtype` and `units`:
    `mma_bf16_u{32,64,128}` (tensor cores, 1, 2 or 4 chunks of 32 units) or
    `cuda_cores_f32_u{32,64,128}`. The C entry `ign_masked_gru_scan`
    dispatches by the same rule; `profiled_instance` reads which one ran."""
    if dtype not in _build.DTYPE_CODES or not 0 < units <= MAX_UNITS:
        raise ValueError(
            f"masked_gru_scan takes bf16/f32 and 1-{MAX_UNITS} units, got {dtype}, u={units}"
        )
    chunks = 1 if units <= 32 else 2 if units <= 64 else 4
    route = "mma_bf16" if dtype == torch.bfloat16 else "cuda_cores_f32"
    return f"{route}_u{32 * chunks}"


def profiled_instance(kernel_name: str) -> str:
    """`forward_instance`'s name for the kernel-B `__global__` that a
    profiler reports as `kernel_name` (demangled, e.g.
    `masked_gru_scan_mma_kernel<1, true>(...)`, whose first template
    argument is the number of 32-unit chunks); raises for another kernel."""
    found = re.search(r"masked_gru_scan_(mma_)?kernel<(?:float, )?(\d+)", kernel_name)
    if found is None:
        raise ValueError(f"not an instance of kernel B: {kernel_name!r}")
    route = "mma_bf16" if found.group(1) else "cuda_cores_f32"
    return f"{route}_u{32 * int(found.group(2))}"


def backward_instance(dtype: torch.dtype, units: int) -> str:
    """The instance of kernel C's sweep that serves a call of `dtype` and
    `units`: `mma_bf16_u32` (tensor cores, bf16 at u <= 32), else
    `cuda_cores_bf16_u{64,128}` or `cuda_cores_f32_u{32,64,128}` (one warp
    per row, 1, 2 or 4 chunks of 32 units). The C entry
    `ign_masked_gru_scan_bwd` dispatches by the same rule;
    `profiled_backward_instance` reads which one ran."""
    if dtype not in _build.DTYPE_CODES or not 0 < units <= MAX_UNITS:
        raise ValueError(
            f"masked_gru_scan backward takes bf16/f32 and 1-{MAX_UNITS} units, got {dtype}, "
            f"u={units}"
        )
    if dtype == torch.bfloat16 and units <= 32:
        return "mma_bf16_u32"
    chunks = 1 if units <= 32 else 2 if units <= 64 else 4
    route = "cuda_cores_bf16" if dtype == torch.bfloat16 else "cuda_cores_f32"
    return f"{route}_u{32 * chunks}"


def profiled_backward_instance(kernel_name: str) -> str:
    """`backward_instance`'s name for the sweep `__global__` of kernel C that
    a profiler reports as `kernel_name` (demangled: `gru_bwd_sweep_mma_kernel<1,
    true>(...)` or `gru_bwd_sweep_kernel<__nv_bfloat16, 2>(...)`, the unit
    chunks of 32 in the last template argument shown); raises for another
    kernel."""
    found = re.search(
        r"gru_bwd_sweep_(?:(mma_)kernel<(\d+)|kernel<(float|__nv_bfloat16), (\d+))", kernel_name
    )
    if found is None:
        raise ValueError(f"not an instance of kernel C's sweep: {kernel_name!r}")
    if found.group(1):
        return f"mma_bf16_u{32 * int(found.group(2))}"
    route = "cuda_cores_f32" if found.group(3) == "float" else "cuda_cores_bf16"
    return f"{route}_u{32 * int(found.group(4))}"


@functools.lru_cache(maxsize=None)
def _forward_smem(dtype_code: int, D: int, U: int) -> int:
    """Bytes of shared memory of the instance serving (dtype, D, u)."""
    return _build.library().ign_masked_gru_scan_smem(dtype_code, D, U)


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
    if U > MAX_UNITS:
        raise ValueError(f"masked_gru_scan supports up to {MAX_UNITS} units, got {U}")
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
    smem = _forward_smem(_build.DTYPE_CODES[xs.dtype], D, U)
    if smem > _HOPPER_BLOCK_SMEM:
        raise ValueError(
            f"masked_gru_scan ({forward_instance(xs.dtype, U)}): weights need {smem} bytes "
            f"of shared memory, more than a Hopper block has ({_HOPPER_BLOCK_SMEM})"
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
        return (torch.zeros_like(xs), ct.to(f32, copy=True), zeros(D, 3 * U), zeros(U, 3 * U),
                zeros(2, 3 * U))
    lib = _build.library()
    hstash = None
    if backward_instance(dtype, U).startswith("mma"):
        # one warp per 16-row tile; the C entry launches no more blocks than
        # are resident at once and writes that many bias partials
        warps, tiles = _SWEEP_MMA_WARPS, -(-N // 16)
        blocks = -(-tiles // warps)
        hstash = torch.empty((L, tiles, 4, 32, 4), dtype=f32, device=dev)
    else:
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
        hprev.data_ptr(), None if hstash is None else hstash.data_ptr(), bias_part.data_ptr(), part.data_ptr(), wgrad.data_ptr(),
        d_b.data_ptr(), L, N, D, U, warps, blocks, n_chunks, rows_per_chunk,
        _build.DTYPE_CODES[dtype], _build.stream_handle(dev),
    )
    _build.check(code, "masked_gru_scan_bwd")
    bwd_launch_count += 1
    return d_xs, d_h0, wgrad[:D], wgrad[D:], d_b


# --------------------------------------------------------------------------
# the kernels as operators (`torch.ops.ignnition_tpu_torch.*`, see
# `_build.op_library`); `_MaskedGruScan` differentiates B, with C on the card
# --------------------------------------------------------------------------

_lib = _build.op_library()
_lib.define(
    "masked_gru_scan(Tensor xs, Tensor lens, Tensor h0, Tensor kernel, "
    "Tensor recurrent_kernel, Tensor bias) -> Tensor"
)
_lib.define(
    "masked_gru_scan_backward(Tensor xs, Tensor lens, Tensor h0, Tensor kernel, "
    "Tensor recurrent_kernel, Tensor bias, Tensor ct) -> (Tensor, Tensor, Tensor, Tensor)"
)
_PARAM_NAMES = ("kernel", "recurrent_kernel", "bias")


def _forward_cuda(xs, lens, h0, wx, wh, b):
    return _launch_forward(*(t.contiguous() for t in (xs, lens, h0, wx, wh, b)))


def _forward_cpu(xs, lens, h0, wx, wh, b):
    if xs.shape[0] == 0:  # no step: h0 itself, as a new tensor
        return h0.to(xs.dtype, copy=True)
    return masked_gru_scan_plain(xs, lens, h0, dict(zip(_PARAM_NAMES, (wx, wh, b))))


def _forward_fake(xs, lens, h0, wx, wh, b):
    return xs.new_empty((xs.shape[1], h0.shape[1]))


def _backward_cuda(xs, lens, h0, wx, wh, b, ct):
    """Kernel C: (d_xs in xs's dtype; d_h0, d_w, d_b in f32), d_w the
    gradients of `kernel` and `recurrent_kernel` stacked [D + u, 3u] as
    the kernel writes them."""
    d_xs, d_h0, d_wx, d_wh, d_b = _launch_backward(
        *(t.contiguous() for t in (xs, lens, h0, wx, wh, b, ct.to(xs.dtype)))
    )
    # d_wx and d_wh are the two row blocks of one tensor, unless L or N is 0
    d_w = d_wx._base if d_wx._base is not None else torch.cat([d_wx, d_wh])
    return d_xs, d_h0, d_w, d_b


def _backward_cpu(xs, lens, h0, wx, wh, b, ct):
    """Kernel C's plain version (the TPU kernel's rounding), in the CUDA
    body's dtypes."""
    d_xs, d_h0, d_wx, d_wh, d_b = masked_gru_scan_bwd_kernel_plain(
        xs, lens, h0, dict(zip(_PARAM_NAMES, (wx, wh, b))), ct
    )
    acc = torch.promote_types(xs.dtype, torch.float32)
    # with no step d_h0 is ct itself: copied, as an output aliases no input
    return d_xs, d_h0.to(acc, copy=True), torch.cat([d_wx, d_wh]).to(acc), d_b.to(acc)


def _backward_fake(xs, lens, h0, wx, wh, b, ct):
    (d, three_u), u = wx.shape, h0.shape[1]
    acc = torch.promote_types(xs.dtype, torch.float32)
    return (torch.empty_like(xs), h0.new_empty(h0.shape, dtype=acc),
            wx.new_empty((d + u, three_u), dtype=acc), b.new_empty(b.shape, dtype=acc))


_lib.impl("masked_gru_scan", _forward_cuda, "CUDA")
_lib.impl("masked_gru_scan", _forward_cpu, "CPU")
_lib.impl("masked_gru_scan_backward", _backward_cuda, "CUDA")
_lib.impl("masked_gru_scan_backward", _backward_cpu, "CPU")
torch.library.register_fake(f"{_build.OPS}::masked_gru_scan", _forward_fake, lib=_lib)
torch.library.register_fake(f"{_build.OPS}::masked_gru_scan_backward", _backward_fake, lib=_lib)


class _MaskedGruScan(torch.autograd.Function):
    """The operator `masked_gru_scan` with its backward: kernel C on the card;
    on the CPU autograd through the plain scan (`masked_gru_scan_bwd_plain`,
    which recomputes the forward). Gradients come back in the inputs' dtypes.
    (Not an autograd registration of the operator: see `segment_kernels`.)"""

    @staticmethod
    def forward(ctx, xs, lens, h0, wx, wh, b):
        ctx.save_for_backward(xs, lens, h0, wx, wh, b)
        return torch.ops.ignnition_tpu_torch.masked_gru_scan(xs, lens, h0, wx, wh, b)

    @staticmethod
    def backward(ctx, ct):
        xs, lens, h0, wx, wh, b = ctx.saved_tensors
        if xs.device.type == "cpu":
            grads = masked_gru_scan_bwd_plain(
                xs, lens, h0, dict(zip(_PARAM_NAMES, (wx, wh, b))), ct
            )
            d_xs, d_h0, d_wx, d_wh, d_b = (
                torch.zeros_like(t) if g is None else g
                for g, t in zip(grads, (xs, h0, wx, wh, b))
            )
            return d_xs, None, d_h0, d_wx, d_wh, d_b
        d_xs, d_h0, d_w, d_b = torch.ops.ignnition_tpu_torch.masked_gru_scan_backward(
            xs, lens, h0, wx, wh, b, ct
        )
        dtype, d = xs.dtype, xs.shape[2]
        return d_xs, None, d_h0.to(dtype), d_w[:d].to(dtype), d_w[d:].to(dtype), d_b.to(dtype)


def masked_gru_scan(
    xs: torch.Tensor, lens: torch.Tensor, h0: torch.Tensor, params
) -> torch.Tensor:
    """Masked GRU scan over time-major slices; returns the final h.
    Differentiable in xs, h0 and the params.

    The operator `masked_gru_scan`: a CPU tensor takes the plain version
    (and autograd's backward of it); a CUDA tensor launches kernel B, and
    kernel C in the backward (and raises if it cannot). Under the fused-rnn
    switch's 'never' the plain version on any device, differentiated by
    autograd; under 'always' a CPU tensor raises."""
    if takes_plain(xs, "fused-rnn", "masked_gru_scan"):
        return masked_gru_scan_plain(xs, lens, h0, params)
    dtype = xs.dtype
    wx, wh, b = _cast_params(params, dtype)
    args = (xs, lens.to(torch.int32), h0.to(dtype), wx, wh, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _MaskedGruScan.apply(*args)
    return torch.ops.ignnition_tpu_torch.masked_gru_scan(*args)
