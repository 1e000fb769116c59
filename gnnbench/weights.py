"""The initial weights of a run, made from its seed on the device.

One uniform draw from a `torch.Generator` on the run's device covers every
glorot-uniform leaf (Keras' initializer: U(-a, a), a = sqrt(6 / (fan_in +
fan_out))); biases start at zero. The same weights go to the program and to
the reference, by leaf name.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def make(spec: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{leaf: float32 tensor} for `spec` ({leaf: (shape, "glorot" | "zeros")})."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    drawn = [k for k, (_, init) in spec.items() if init == "glorot"]
    total = sum(math.prod(spec[k][0]) for k in drawn)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, (shape, init) in spec.items():
        if init == "zeros":
            out[k] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        if init != "glorot":
            raise ValueError(f"unknown initializer {init!r} of {k}")
        n = math.prod(shape)
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[k] = ((u[at:at + n] * 2.0 - 1.0) * limit).reshape(shape)
        at += n
    return out
