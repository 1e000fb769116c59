"""Activations, Keras initializers, the Dense layer, the built-in layer
kinds and the registry of custom ones (counterpart of
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


# The random layers, each a function of its input and of the keep mask or
# noise that a training step draws (`draw_keep`, `draw_normal`). The draws
# are float32 whatever the compute dtype, so that a bf16, f32 or f64 run
# from one generator state sees the same masks and noise.

# keras AlphaDropout's alpha' = -selu_scale * selu_alpha
_ALPHA_P = -1.6732632423543772 * 1.0507009873554805


def draw_keep(generator: torch.Generator, x: torch.Tensor, rate: float) -> torch.Tensor:
    """A keep mask of x's shape, each entry True with probability 1 - rate
    (jax.random.bernoulli: a uniform draw below 1 - rate)."""
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return u < 1.0 - rate


def draw_normal(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Standard normal noise of x's shape, in x's dtype."""
    n = torch.randn(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return n.to(x.dtype)


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Keras Dropout: kept entries scaled by 1 / (1 - rate), the rest zero."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def alpha_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Keras AlphaDropout (the selu companion): dropped entries are set to
    alpha', then an affine correction a * x + b restores zero mean and unit
    variance."""
    a = ((1.0 - rate) * (1.0 + rate * _ALPHA_P**2)) ** -0.5
    b = -a * _ALPHA_P * rate
    return a * torch.where(keep, x, torch.full_like(x, _ALPHA_P)) + b


def gaussian_noise(x: torch.Tensor, noise: torch.Tensor, stddev: float) -> torch.Tensor:
    """Keras GaussianNoise: x + stddev * noise."""
    return x + stddev * noise


SUPPORTED_LAYERS = (
    "Dense",
    "Dropout",
    "Activation",
    "LayerNormalization",
    "BatchNormalization",
    "LeakyReLU",
    "ReLU",
    "ELU",
    "PReLU",
    "Softmax",
    "GaussianNoise",
    "AlphaDropout",
)


# --------------------------------------------------------------------------
# Extension registry (the port's own: a kind registered on the JAX package
# does not appear here)
# --------------------------------------------------------------------------


class LayerDef:
    """A registered custom layer.

    init_fn(generator, layer_spec, in_dim) -> (params, out_dim)
        Build the layer's parameter tree (a dict of float32 tensors, possibly
        empty) from the `torch.Generator` and report its output width.
        `layer_spec` is the frontend's `LayerSpec`; extra description keys
        are in `layer_spec.extra`.
    apply_fn(layer_spec, params, x, *, deterministic, generator) -> y
        The forward. `deterministic` is False in a training step's readout,
        where a random layer draws from `generator`.
    """

    __slots__ = ("kind", "init_fn", "apply_fn")

    def __init__(self, kind, init_fn, apply_fn):
        self.kind = kind
        self.init_fn = init_fn
        self.apply_fn = apply_fn


CUSTOM_LAYERS: Dict[str, LayerDef] = {}


def register_layer(kind: str, init_fn, apply_fn) -> None:
    """Register a custom layer kind usable from model descriptions
    (`{"type_layer": "<kind>", ...}`). Overwrites an earlier registration of
    the same kind; a built-in kind cannot be shadowed."""
    if kind in SUPPORTED_LAYERS:
        raise ValueError(f"cannot override built-in layer kind '{kind}'")
    CUSTOM_LAYERS[kind] = LayerDef(kind, init_fn, apply_fn)


def unsupported_layer_error(kind: str, nn_name: str) -> ValueError:
    return ValueError(
        f"unsupported layer type '{kind}' in network '{nn_name}'; "
        f"built-ins: {', '.join(SUPPORTED_LAYERS)}"
        + (
            f"; registered extensions: {', '.join(sorted(CUSTOM_LAYERS))}"
            if CUSTOM_LAYERS
            else "; custom kinds can be added with "
            "ignnition_tpu_torch.register_layer(kind, init_fn, apply_fn)"
        )
    )
