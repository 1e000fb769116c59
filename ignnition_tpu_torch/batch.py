"""Move a numpy batch from `build_batch` onto a device (the port's
counterpart of `jax.device_put`).

Conversions:
  * int32 index arrays become int64, the index type of PyTorch's gathers;
    CSR pointer arrays (`*row_ptr*`) stay int32, the type the kernels take;
  * int8 incidence matrices (`dense_inc_*`, `inc_blocks_*`) stay int8 on the
    device; the model upcasts each once per forward and reuses it across
    the message-passing iterations (it is loop-invariant);
  * ml_dtypes bfloat16 arrays (the incidence fallback when a multiplicity
    exceeds 127) have no numpy type PyTorch knows: they travel as int16
    and are viewed as torch.bfloat16 on arrival;
  * everything else keeps its dtype.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _to_tensor(key: str, a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.to(device).view(torch.bfloat16)
    if a.dtype == np.int32 and "row_ptr" not in key:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: `device`, or by default the current
    CUDA device. Without one it raises rather than settle for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and none was asked for: the default "
            'device is the GPU; pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


def to_device(
    arrays: Mapping[str, object], device, non_blocking: bool = False
) -> Dict[str, torch.Tensor]:
    """Tensors on `device` for every array of a `build_batch` result. Values
    that are tensors already (a batch cached on the device, packed host
    buffers) are moved as they are, with `non_blocking` (which overlaps only
    copies from pinned memory)."""
    device = torch.device(device)
    return {
        k: v.to(device, non_blocking=non_blocking) if isinstance(v, torch.Tensor)
        else _to_tensor(k, v, device)
        for k, v in arrays.items()
    }
