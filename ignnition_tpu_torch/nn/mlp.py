"""Feed-forward model: init/apply/l2_loss from an MLPSpec (counterpart of
`ignnition_tpu/nn/mlp.py`). Only Dense layers are ported, so `apply` is the
same function in training and in inference. Every function acts on the last
axis, so it runs unchanged on a [L, N, H] slot tensor.

Params keep the JAX tree: {"layers": ({"kernel": ..., "bias": ...}, ...)}.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .layers import activation, dense, glorot_uniform, unsupported_layer, zeros


def init(
    generator: torch.Generator,
    spec,
    in_dim: int,
    last_units: Optional[int] = None,
) -> Tuple[Dict[str, Any], int]:
    """Initialize parameters; returns (params, output_dim). `last_units`
    overrides the last Dense layer's width, as in the JAX package."""
    params = []
    dim = in_dim
    last_dense = max(
        (j for j, l in enumerate(spec.layers) if l.kind == "Dense"), default=None
    )
    if last_units is not None and last_dense is None:
        raise ValueError(
            f"network '{spec.name}' must contain a Dense layer: its output "
            f"is required to have width {last_units}"
        )
    for j, layer in enumerate(spec.layers):
        if layer.kind != "Dense":
            raise unsupported_layer(layer.kind, spec.name)
        units = layer.units
        if j == last_dense and last_units is not None:
            units = last_units
        if units is None:
            raise ValueError(
                f"Dense layer '{layer.name}' of network '{spec.name}' has no units"
            )
        p = {"kernel": glorot_uniform(generator, (dim, int(units)))}
        if layer.use_bias:
            p["bias"] = zeros((int(units),))
        params.append(p)
        dim = int(units)
    return {"layers": tuple(params)}, dim


def apply(spec, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Forward (Dense layers behave alike in training and inference)."""
    return _apply_layers(spec, spec.layers, params["layers"], x)


def _apply_layers(spec, layers, param_list, x: torch.Tensor) -> torch.Tensor:
    for layer, p in zip(layers, param_list):
        if layer.kind != "Dense":
            raise unsupported_layer(layer.kind, spec.name)
        x = dense(layer, p, x)
    return x


def can_split_first(spec) -> bool:
    """True when the first layer is Dense, so `x @ kernel` decomposes over
    row-slices of the kernel (one slice per concatenated input part)."""
    return bool(spec.layers) and spec.layers[0].kind == "Dense"


def _finish_first(spec, params: Dict[str, Any], pre: torch.Tensor) -> torch.Tensor:
    """The first Dense layer's bias and activation on its pre-activation."""
    layer0 = spec.layers[0]
    if layer0.use_bias:
        pre = pre + params["layers"][0]["bias"]
    return activation(layer0.activation)(pre)


def apply_from_first_preact(spec, params: Dict[str, Any], pre: torch.Tensor) -> torch.Tensor:
    """Finish the first Dense layer from its pre-activation `pre = x @ kernel`
    and run the remaining layers: concat([a, b]) @ K == a @ K[:da] + b @ K[da:],
    so the per-part matmuls of a split first layer meet here."""
    x = _finish_first(spec, params, pre)
    return _apply_layers(spec, spec.layers[1:], params["layers"][1:], x)


def can_factor_last(spec) -> bool:
    """True when the network ends in a linear Dense layer: f(x) = g(x) @ K + b.
    A sum then commutes with the last layer: sum_e f(x_e) = (sum_e g(x_e)) @ K
    + count * b, which moves the final matmul from edge rate to node rate."""
    if not spec.layers:
        return False
    last = spec.layers[-1]
    return last.kind == "Dense" and last.activation in (None, "linear")


def apply_prefix(spec, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """All layers except the last (see `can_factor_last`)."""
    return _apply_layers(spec, spec.layers[:-1], params["layers"][:-1], x)


def prefix_from_first_preact(spec, params: Dict[str, Any], pre: torch.Tensor) -> torch.Tensor:
    """Finish layer 0 from its pre-activation and run layers 1..n-2 (a split
    first layer and a factored last layer together)."""
    x = _finish_first(spec, params, pre)
    return _apply_layers(spec, spec.layers[1:-1], params["layers"][1:-1], x)


def last_dense(spec, params: Dict[str, Any]):
    """(kernel, bias or None) of the final Dense layer (see `can_factor_last`)."""
    p = params["layers"][-1]
    return p["kernel"], (p["bias"] if spec.layers[-1].use_bias else None)


def output_dim(spec, in_dim: int, last_units: Optional[int] = None) -> int:
    """The network's output width for an input of width `in_dim`."""
    dim = in_dim
    last = max((j for j, l in enumerate(spec.layers) if l.kind == "Dense"), default=None)
    for j, layer in enumerate(spec.layers):
        if layer.kind == "Dense":
            dim = int(last_units if j == last and last_units is not None else layer.units)
    return dim


def l2_loss(spec, params: Dict[str, Any]) -> torch.Tensor:
    """Sum of kernel_regularizer * sum(kernel**2) over the Dense layers, the
    Keras `regularizers.l2` semantics; a float32 scalar on the params' device."""
    first = params["layers"][0]["kernel"]
    total = torch.zeros((), dtype=torch.float32, device=first.device)
    for layer, p in zip(spec.layers, params["layers"]):
        if layer.kind == "Dense" and layer.kernel_regularizer > 0.0:
            total = total + layer.kernel_regularizer * torch.sum(p["kernel"] ** 2)
    return total
