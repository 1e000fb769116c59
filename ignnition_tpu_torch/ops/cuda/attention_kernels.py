"""Kernels D and E: flash-style dense GAT attention, forward and backward.

Kernel D replaces the TPU kernel `ignnition_tpu/ops/pallas/
attention_kernels.py`, `flash_gat_forward` / `_fwd_kernel`, kernel E its
backward `flash_gat_backward` / `_bwd_kernel`. The CUDA source is
`csrc/flash_gat.cu`; its header comment gives what bounds the kernels on an
H100 (the one read of the incidence matrix per pass) and what the design
does about that (only non-zero entries cost the D-wide work).

Contract, the TPU kernels' with a leading graph axis G (block-diagonal merged
batches; G = 1 is one dense matrix):

    forward(ssrc [G,bs], sdst [G,bd], x [G,bs,D], m [G,bd,bs], stab [G,bd])
        -> out [G,bd,D] in x's dtype, den [G,bd] f32
    backward(ssrc, sdst, x, m, stab, den, ct [G,bd,D], srow [G,bd])
        -> dtab_plus [G,bs,D+1] f32 ([..., :D] = d_table, [..., D] = d_ssrc),
           d_sdst [G,bd] f32

x is bf16 or f32, m int8 or bf16 (upcast in registers), the score vectors
and `stab` (the per-row bound of `ops.segment._flash_stab`) f32, D up to 128,
any bd and bs. z = m * exp(lrelu(sdst[d] + ssrc[s]) - stab[d]) in f32 is
rounded to x's dtype before the product with x; sums are f32; den is the sum
of the rounded z; a row without support gives exactly 0. The backward
recomputes a = z / max(den, 1e-30) in f32, rounds a and ct to x's dtype for
the products and keeps dp = a * lrelu'(pre) * (ct . x[s] - srow) in f32.

What bounds D and E on an H100 is the one read of m (33.5 MB at the
flagship's [2048, 16384] int8, 0.010 ms at 3.35 TB/s); its ~131,000
non-zeros cost little arithmetic but, handled one at a time, a chain of
dependent loads each. So D streams m once, in one launch over blocks of up
to 8 rows (a warp a row, or a row's columns split over the warps when the
rows are few), through a cp.async ring of its own in each warp; it lists a
row's non-zeros and handles up to 128 at once, one lane each for z and
lane groups gathering the x rows with 16-byte loads, and adds each row's
sums in a fixed order. E reads m once, in one launch over 64-byte column
strips (a CTA owns whole columns and writes their d_table and d_ssrc
itself) streamed through shared memory; it lists a strip's non-zeros,
handles them one thread each, sums each column's in row order in a lane
group, and writes each strip's partial row sums to a scratch
[strips, G, bd] (`bwd_layout` asks the CUDA source for the strips) that a
second launch adds in strip order into d_sdst: two launches a call
(`BWD_LAUNCHES_PER_CALL`). No atomics: every sum has a fixed order, so two
calls agree bitwise. `csrc/flash_gat.cu`'s header gives each choice.

The plain versions below repeat that arithmetic over the whole matrix in
PyTorch: they are the kernels' references, and what a CPU tensor gets.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, takes_plain

# launches made from Python in this process, eager or recorded into a CUDA
# graph; a graph's replays launch again uncounted (`ops.cuda`)
fwd_launch_count = 0  # launches of kernel D
bwd_launch_count = 0  # launches of kernel E

_SLOPE = 0.2  # LeakyReLU negative slope of the GAT scores
_DEN_FLOOR = 1e-30
_MAX_WIDTH = 128

# device launches of one call of kernel E: the strip kernel and the row sums
BWD_LAUNCHES_PER_CALL = 2


def bwd_layout(bs: int, d: int, x_dtype: torch.dtype, m_dtype: torch.dtype) -> Tuple[int, int]:
    """(strips, cap) of kernel E at bs columns and width d, as the CUDA
    source lays them out: the strip CTAs of a graph (the first axis of the
    scratch of row partials) and the non-zeros a strip's list holds before
    it is handled."""
    strips, cap = ctypes.c_int(), ctypes.c_int()
    code = _build.library().ign_flash_gat_bwd_layout(
        bs, d, _build.DTYPE_CODES[x_dtype], _build.INCIDENCE_DTYPE_CODES[m_dtype],
        ctypes.byref(strips), ctypes.byref(cap),
    )
    _build.check(code, "flash_gat_bwd_layout")
    return strips.value, cap.value


def _tile_z(ssrc, sdst, m, stab):
    """(z, pre) over the whole [G, bd, bs] matrix, f32."""
    pre = sdst[:, :, None] + ssrc[:, None, :]
    e = torch.maximum(pre, _SLOPE * pre)
    return torch.exp(e - stab[:, :, None]) * m.to(torch.float32), pre


def flash_gat_forward_plain(ssrc, sdst, x, m, stab) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's function in plain PyTorch (its reference)."""
    f32 = torch.float32
    z, _ = _tile_z(ssrc.to(f32), sdst.to(f32), m, stab.to(f32))
    z = z.to(x.dtype).to(f32)  # rounded to x's dtype before the product
    acc = torch.bmm(z, x.to(f32))
    den = z.sum(dim=2)
    out = (acc / den.clamp_min(_DEN_FLOOR)[:, :, None]).to(x.dtype)
    return out, den


def flash_gat_backward_plain(
    ssrc, sdst, x, m, stab, den, ct, srow
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E's function in plain PyTorch (its reference)."""
    f32 = torch.float32
    z, pre = _tile_z(ssrc.to(f32), sdst.to(f32), m, stab.to(f32))
    a = z / den.to(f32).clamp_min(_DEN_FLOOR)[:, :, None]
    ab = a.to(x.dtype).to(f32)
    ctf = ct.to(x.dtype).to(f32)
    da = torch.bmm(ctf, x.to(f32).transpose(1, 2))  # [G, bd, bs]
    w = a * torch.where(pre > 0, 1.0, _SLOPE)
    dp = w * (da - srow.to(f32)[:, :, None])
    d_table = torch.bmm(ab.transpose(1, 2), ctf)  # [G, bs, D]
    dtab_plus = torch.cat([d_table, dp.sum(dim=1)[:, :, None]], dim=2)
    return dtab_plus, dp.sum(dim=2)


def _check(name, ssrc, sdst, x, m, stab, more=()):
    _build.check_device(x, name)
    if x.dim() != 3 or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name} takes x [G, bs, D] in bf16/f32, got {tuple(x.shape)} {x.dtype}")
    g, bs, d = x.shape
    if m.dim() != 3 or m.shape[0] != g or m.shape[2] != bs:
        raise ValueError(f"{name}: m {tuple(m.shape)} does not fit x {tuple(x.shape)}")
    if m.dtype not in _build.INCIDENCE_DTYPE_CODES:
        raise ValueError(f"{name} takes an int8 or bf16 incidence matrix, got {m.dtype}")
    bd = m.shape[1]
    if d > _MAX_WIDTH:
        raise ValueError(f"{name} supports widths up to {_MAX_WIDTH}, got {d}")
    if g > 65535:
        raise ValueError(f"{name} supports up to 65535 graphs per call, got {g}")
    vectors = [(ssrc, (g, bs), "ssrc"), (sdst, (g, bd), "sdst"), (stab, (g, bd), "stab")]
    for t, shape, what in vectors + list(more):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"{name}: {what} is {tuple(t.shape)} on {t.device}, expected {shape} "
                f"on {x.device}"
            )
    return g, bd, bs, d


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _launch_forward(ssrc, sdst, x, m, stab):
    """Kernel D on CUDA tensors."""
    global fwd_launch_count
    g, bd, bs, d = _check("flash_gat_forward", ssrc, sdst, x, m, stab)
    out = torch.empty((g, bd, d), dtype=x.dtype, device=x.device)
    den = torch.empty((g, bd), dtype=torch.float32, device=x.device)
    if min(g, bd, d) == 0:
        return out, den
    if bs == 0:
        return out.zero_(), den.zero_()
    ssrc, sdst, stab = _f32(ssrc), _f32(sdst), _f32(stab)
    x, m = x.contiguous(), m.contiguous()
    code = _build.library().ign_flash_gat_fwd(
        ssrc.data_ptr(), sdst.data_ptr(), stab.data_ptr(), x.data_ptr(), m.data_ptr(),
        out.data_ptr(), den.data_ptr(), g, bd, bs, d, _build.DTYPE_CODES[x.dtype],
        _build.INCIDENCE_DTYPE_CODES[m.dtype], _build.stream_handle(x.device),
    )
    _build.check(code, "flash_gat_fwd")
    fwd_launch_count += 1
    return out, den


def _launch_backward(ssrc, sdst, x, m, stab, den, ct, srow):
    """Kernel E on CUDA tensors."""
    global bwd_launch_count
    g, bs, d = x.shape
    bd = m.shape[1]
    _check("flash_gat_backward", ssrc, sdst, x, m, stab,
           more=[(den, (g, bd), "den"), (srow, (g, bd), "srow"), (ct, (g, bd, d), "ct")])
    dtab_plus = torch.empty((g, bs, d + 1), dtype=torch.float32, device=x.device)
    d_sdst = torch.empty((g, bd), dtype=torch.float32, device=x.device)
    if min(g, bs, d) == 0:
        return dtab_plus, d_sdst.zero_()
    if bd == 0:
        return dtab_plus.zero_(), d_sdst
    ssrc, sdst, stab, den, srow = (_f32(t) for t in (ssrc, sdst, stab, den, srow))
    x, m, ct = x.contiguous(), m.contiguous(), ct.to(x.dtype).contiguous()
    # each strip's partial of d_sdst, summed in strip order by the second launch
    strips, _ = bwd_layout(bs, d, x.dtype, m.dtype)
    part = torch.empty((strips, g, bd), dtype=torch.float32, device=x.device)
    code = _build.library().ign_flash_gat_bwd(
        ssrc.data_ptr(), sdst.data_ptr(), stab.data_ptr(), den.data_ptr(), srow.data_ptr(),
        x.data_ptr(), ct.data_ptr(), m.data_ptr(), dtab_plus.data_ptr(), d_sdst.data_ptr(),
        part.data_ptr(), g, bd, bs, d, _build.DTYPE_CODES[x.dtype],
        _build.INCIDENCE_DTYPE_CODES[m.dtype], _build.stream_handle(x.device),
    )
    _build.check(code, "flash_gat_bwd")
    bwd_launch_count += 1
    return dtab_plus, d_sdst


# --------------------------------------------------------------------------
# the kernels as operators (`torch.ops.ignnition_tpu_torch.*`, see
# `_build.op_library`); `ops.segment._FlashMaskedSoftmaxMatmul` joins them
# --------------------------------------------------------------------------

_lib = _build.op_library()
_lib.define(
    "flash_gat_forward(Tensor ssrc, Tensor sdst, Tensor x, Tensor m, Tensor stab) "
    "-> (Tensor, Tensor)"
)
_lib.define(
    "flash_gat_backward(Tensor ssrc, Tensor sdst, Tensor x, Tensor m, Tensor stab, "
    "Tensor den, Tensor ct, Tensor srow) -> (Tensor, Tensor)"
)


def _forward_fake(ssrc, sdst, x, m, stab):
    g, bd = m.shape[0], m.shape[1]
    return x.new_empty((g, bd, x.shape[2])), x.new_empty((g, bd), dtype=torch.float32)


def _backward_fake(ssrc, sdst, x, m, stab, den, ct, srow):
    g, bs, d = x.shape
    f32 = torch.float32
    return x.new_empty((g, bs, d + 1), dtype=f32), x.new_empty((g, m.shape[1]), dtype=f32)


# the bodies look their functions up when called, so that a patched name is
# the one that runs
_lib.impl("flash_gat_forward", lambda *args: _launch_forward(*args), "CUDA")
_lib.impl("flash_gat_forward", lambda *args: flash_gat_forward_plain(*args), "CPU")
_lib.impl("flash_gat_backward", lambda *args: _launch_backward(*args), "CUDA")
_lib.impl("flash_gat_backward", lambda *args: flash_gat_backward_plain(*args), "CPU")
torch.library.register_fake(f"{_build.OPS}::flash_gat_forward", _forward_fake, lib=_lib)
torch.library.register_fake(f"{_build.OPS}::flash_gat_backward", _backward_fake, lib=_lib)


def flash_gat_forward(ssrc, sdst, x, m, stab) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, den) of the contract above: the operator `flash_gat_forward`. A
    CPU tensor takes the plain version; a CUDA tensor launches kernel D (and
    raises if it cannot). Under 'never' the plain version on any device;
    under 'always' a CPU tensor raises."""
    if takes_plain(x, "flash-attn", "flash_gat_forward"):
        return flash_gat_forward_plain(ssrc, sdst, x, m, stab)
    return torch.ops.ignnition_tpu_torch.flash_gat_forward(ssrc, sdst, x, m, stab)


def flash_gat_backward(
    ssrc, sdst, x, m, stab, den, ct, srow
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dtab_plus, d_sdst) of the contract above: the operator
    `flash_gat_backward`. A CPU tensor takes the plain version; a CUDA tensor
    launches kernel E (and raises if it cannot). The switches as for
    `flash_gat_forward`."""
    if takes_plain(x, "flash-attn", "flash_gat_backward"):
        return flash_gat_backward_plain(ssrc, sdst, x, m, stab, den, ct, srow)
    return torch.ops.ignnition_tpu_torch.flash_gat_backward(
        ssrc, sdst, x, m, stab, den, ct, srow
    )
