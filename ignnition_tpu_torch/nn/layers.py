"""Activations, Keras initializers and the Dense layer (counterpart of
`ignnition_tpu/nn/layers.py`).

Initializers draw from an explicit `torch.Generator`. The numbers differ
from `jax.random`'s for the same seed; parity tests move one parameter tree
across with `model.builder.params_from_jax`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# Activations (keras names, jax.nn semantics)
# --------------------------------------------------------------------------

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "selu": F.selu,
    "elu": F.elu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "swish": F.silu,
    "silu": F.silu,
    # jax.nn.leaky_relu's default slope
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "exponential": torch.exp,
    "hard_sigmoid": F.hardsigmoid,
    "linear": lambda x: x,
}


def activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None or name == "None" or name == "linear":
        return lambda x: x
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation '{name}'; supported: {sorted(ACTIVATIONS)}"
        ) from None


# --------------------------------------------------------------------------
# Initializers (Keras defaults)
# --------------------------------------------------------------------------


def glorot_uniform(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.empty(tuple(shape), dtype=torch.float32)
    return out.uniform_(-limit, limit, generator=generator)


def orthogonal(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Keras/jax orthogonal: QR of a normal matrix, signs fixed by diag(R)."""
    rows, cols = shape[0], shape[1]
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q if rows >= cols else q.T).contiguous()


def zeros(shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------


def dense(layer, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Keras Dense: x @ kernel (+ bias), then the layer's activation. Mixed
    dtypes promote as `jnp.matmul` does (an f32 readout input times a bf16
    kernel computes in f32); `torch.matmul` would raise on them."""
    kernel = p["kernel"]
    if x.dtype != kernel.dtype:
        dtype = torch.promote_types(x.dtype, kernel.dtype)
        x, kernel = x.to(dtype), kernel.to(dtype)
    x = x @ kernel
    if layer.use_bias:
        x = x + p["bias"]
    return activation(layer.activation)(x)


def unsupported_layer(kind: str, nn_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"layer type '{kind}' in network '{nn_name}' is not ported to "
        f"ignnition_tpu_torch yet (ported: Dense)"
    )
