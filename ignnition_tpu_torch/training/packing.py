"""Packed batch transfer: ship a batch to the device as one buffer per
device dtype instead of one copy per array (counterpart of
`ignnition_tpu/training/packing.py`).

A merged batch is a dict of ~40 small arrays (features, edge lists, masks,
index companions), and each host-to-device copy pays a fixed cost. Packing
writes every array of a device dtype into one flat host buffer (pinned when
the batch goes to a GPU), so a batch costs one copy per dtype; on the device
the arrays are views into those buffers.

The layout follows `batch.to_device`'s conversions, so a packed batch and
an unpacked one give bitwise the same tensors: int32 index arrays travel
as int64 (`*row_ptr*` arrays stay int32), ml_dtypes bfloat16 arrays as
torch.bfloat16 (written through an int16 view of the buffer), the rest in
their own dtype. Each array starts on a 128-byte boundary of its buffer.

The layout is a pure function of the batch's (key, dtype, shape)
signature, i.e. of its BatchMeta.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# layout: ((key, device dtype name, start, shape), ...) sorted by key
Layout = Tuple[Tuple[str, str, int, Tuple[int, ...]], ...]

_ALIGN_BYTES = 128


def _device_dtype(key: str, a: np.ndarray) -> torch.dtype:
    """The dtype `batch.to_device` gives this array."""
    if a.dtype.name == "bfloat16":
        return torch.bfloat16
    if a.dtype == np.int32 and "row_ptr" not in key:
        return torch.int64
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def pack_layout(arrays: Mapping[str, np.ndarray]) -> Layout:
    """The packed layout of a batch signature (every batch with the same
    keys, dtypes and shapes, i.e. the same BatchMeta, shares it)."""
    sizes: Dict[str, int] = {}
    out = []
    for k in sorted(arrays):
        v = np.asarray(arrays[k])
        dtype = _device_dtype(k, v)
        g = _dtype_name(dtype)
        align = _ALIGN_BYTES // dtype.itemsize
        start = -(-sizes.get(g, 0) // align) * align
        out.append((k, g, start, tuple(v.shape)))
        sizes[g] = start + v.size
    return tuple(out)


def pack_arrays(
    arrays: Mapping[str, np.ndarray], layout: Layout, pin: bool = False
) -> Dict[str, torch.Tensor]:
    """One flat host buffer per device dtype, pinned with `pin` (one memcpy
    per array, converting as `batch.to_device` does)."""
    sizes: Dict[str, int] = {}
    for _, g, start, shape in layout:
        sizes[g] = max(sizes.get(g, 0), start + int(np.prod(shape, dtype=np.int64)))
    bufs = {
        g: torch.empty(n, dtype=getattr(torch, g), pin_memory=pin) for g, n in sizes.items()
    }
    host = {
        g: (b.view(torch.int16) if b.dtype == torch.bfloat16 else b).numpy()
        for g, b in bufs.items()
    }
    for k, g, start, shape in layout:
        v = np.asarray(arrays[k])
        if g == "bfloat16":
            v = v.view(np.int16)
        host[g][start : start + v.size] = v.reshape(-1)
    return {f"packed{g}": b for g, b in bufs.items()}


def unpack_arrays(bufs: Mapping[str, torch.Tensor], layout: Layout) -> Dict[str, torch.Tensor]:
    """Views into the buffers, one per array, on whatever device they are."""
    out = {}
    for k, g, start, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        out[k] = bufs[f"packed{g}"][start : start + n].view(shape)
    return out
