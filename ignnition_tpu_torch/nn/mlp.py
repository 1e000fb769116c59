"""Feed-forward model: init/apply/l2_loss from an MLPSpec (counterpart of
`ignnition_tpu/nn/mlp.py`). Only Dense layers are ported, so `apply` is the
same function in training and in inference.

Params keep the JAX tree: {"layers": ({"kernel": ..., "bias": ...}, ...)}.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .layers import dense, glorot_uniform, unsupported_layer, zeros


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
    for layer, p in zip(spec.layers, params["layers"]):
        if layer.kind != "Dense":
            raise unsupported_layer(layer.kind, spec.name)
        x = dense(layer, p, x)
    return x


def l2_loss(spec, params: Dict[str, Any]) -> torch.Tensor:
    """Sum of kernel_regularizer * sum(kernel**2) over the Dense layers, the
    Keras `regularizers.l2` semantics; a float32 scalar on the params' device."""
    first = params["layers"][0]["kernel"]
    total = torch.zeros((), dtype=torch.float32, device=first.device)
    for layer, p in zip(spec.layers, params["layers"]):
        if layer.kind == "Dense" and layer.kernel_regularizer > 0.0:
            total = total + layer.kernel_regularizer * torch.sum(p["kernel"] ** 2)
    return total
