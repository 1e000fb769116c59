"""Feed-forward model: init/apply/l2_loss from an MLPSpec (counterpart of
`ignnition_tpu/nn/mlp.py`), with every built-in layer kind of
`layers.SUPPORTED_LAYERS` and the kinds registered with
`layers.register_layer`. Every function acts on the last axis, so it runs
unchanged on a [L, N, H] slot tensor.

In training (`deterministic=False`) Dropout, AlphaDropout and GaussianNoise
draw from an explicit `torch.Generator` (`layers.dropout` and its siblings
compute each from the drawn mask or noise); otherwise they are the identity.

Params keep the JAX tree: {"layers": ({"kernel": ..., "bias": ...} | {...}, ...)}.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import (
    CUSTOM_LAYERS,
    activation,
    alpha_dropout,
    dense,
    draw_keep,
    draw_normal,
    dropout,
    gaussian_noise,
    glorot_uniform,
    unsupported_layer_error,
    zeros,
)

# the layers that keep their input's width and hold no parameters
_PARAMETER_FREE = (
    "Dropout", "Activation", "LeakyReLU", "ReLU", "ELU", "Softmax", "GaussianNoise",
    "AlphaDropout",
)


def _last_dense(spec) -> Optional[int]:
    return max((j for j, l in enumerate(spec.layers) if l.kind == "Dense"), default=None)


def _scale_center(layer, dim: int) -> Dict[str, torch.Tensor]:
    """The Keras normalizations' gamma (ones) and beta (zeros), each under
    its `scale` / `center` flag."""
    p = {}
    if bool(layer.extra.get("scale", True)):
        p["gamma"] = torch.ones(dim, dtype=torch.float32)
    if bool(layer.extra.get("center", True)):
        p["beta"] = zeros((dim,))
    return p


def init(
    generator: torch.Generator,
    spec,
    in_dim: int,
    last_units: Optional[int] = None,
) -> Tuple[Dict[str, Any], int]:
    """Initialize parameters; returns (params, output_dim). `last_units`
    overrides the last Dense layer's width, as in the JAX package. Custom
    layers draw from `generator` in their turn."""
    params = []
    dim = in_dim
    last_dense = _last_dense(spec)
    if last_units is not None and last_dense is None:
        raise ValueError(
            f"network '{spec.name}' must contain a Dense layer: its output "
            f"is required to have width {last_units}"
        )
    for j, layer in enumerate(spec.layers):
        if layer.kind == "Dense":
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
        elif layer.kind in _PARAMETER_FREE:
            params.append({})
        elif layer.kind == "PReLU":
            # keras PReLU: a per-feature alpha, zeros-initialized
            params.append({"alpha": zeros((dim,))})
        elif layer.kind == "LayerNormalization":
            params.append(_scale_center(layer, dim))
        elif layer.kind == "BatchNormalization":
            # normalization by the moving statistics, which never change (the
            # reference's estimator never runs the Keras update ops; see the
            # JAX package's docs/dsl.md): leaves whose gradient is zero
            p = _scale_center(layer, dim)
            p["moving_mean"] = zeros((dim,))
            p["moving_variance"] = torch.ones(dim, dtype=torch.float32)
            params.append(p)
        elif layer.kind in CUSTOM_LAYERS:
            p, dim = CUSTOM_LAYERS[layer.kind].init_fn(generator, layer, dim)
            params.append(p)
        else:
            raise unsupported_layer_error(layer.kind, spec.name)
    return {"layers": tuple(params)}, dim


def apply(
    spec,
    params: Dict[str, Any],
    x: torch.Tensor,
    *,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Forward; with `deterministic=False` the random layers draw from
    `generator` (and raise without one)."""
    return _apply_layers(
        spec, spec.layers, params["layers"], x,
        deterministic=deterministic, generator=generator,
    )


def _needs_generator(kind: str, generator) -> None:
    if generator is None:
        raise ValueError(f"{kind} requires a generator in training mode")


def _normalize(x, p, shift, inv_std):
    x = (x - shift) * inv_std
    if "gamma" in p:
        x = x * p["gamma"]
    if "beta" in p:
        x = x + p["beta"]
    return x


def _apply_layers(
    spec,
    layers,
    param_list,
    x: torch.Tensor,
    *,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Each layer's Keras semantics, in the JAX `_apply_layers`' terms."""
    for layer, p in zip(layers, param_list):
        kind = layer.kind
        if kind == "Dense":
            x = dense(layer, p, x)
        elif kind == "Activation":
            x = activation(layer.activation or layer.extra.get("activation"))(x)
        elif kind == "Dropout":
            if not deterministic and layer.rate > 0.0:
                _needs_generator(kind, generator)
                x = dropout(x, draw_keep(generator, x, layer.rate), layer.rate)
        elif kind == "LeakyReLU":
            # the Keras layer's default slope 0.3 (jax.nn.leaky_relu's is 0.01)
            x = F.leaky_relu(x, float(layer.extra.get("alpha", 0.3)))
        elif kind == "ReLU":
            neg = float(layer.extra.get("negative_slope", 0.0))
            thr = float(layer.extra.get("threshold", 0.0))
            mx = layer.extra.get("max_value")
            y = torch.where(x >= thr, x, neg * (x - thr))
            x = torch.clamp_max(y, float(mx)) if mx is not None else y
        elif kind == "ELU":
            x = F.elu(x, float(layer.extra.get("alpha", 1.0)))
        elif kind == "PReLU":
            x = torch.where(x >= 0, x, p["alpha"] * x)
        elif kind == "AlphaDropout":
            if not deterministic and layer.rate > 0.0:
                _needs_generator(kind, generator)
                x = alpha_dropout(x, draw_keep(generator, x, layer.rate), layer.rate)
        elif kind == "Softmax":
            x = torch.softmax(x, dim=int(layer.extra.get("axis", -1)))
        elif kind == "GaussianNoise":
            if not deterministic:
                _needs_generator(kind, generator)
                x = gaussian_noise(
                    x, draw_normal(generator, x), float(layer.extra.get("stddev", 0.0))
                )
        elif kind == "LayerNormalization":
            eps = float(layer.extra.get("epsilon", 1e-3))
            mean = torch.mean(x, dim=-1, keepdim=True)
            var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
            x = _normalize(x, p, mean, torch.rsqrt(var + eps))
        elif kind == "BatchNormalization":
            # the moving statistics are detached (JAX: stop_gradient), so
            # their gradient is zero and no optimizer but AdamW's decay
            # moves them
            eps = float(layer.extra.get("epsilon", 1e-3))
            mm, mv = p["moving_mean"].detach(), p["moving_variance"].detach()
            x = _normalize(x, p, mm, torch.rsqrt(mv + eps))
        elif kind in CUSTOM_LAYERS:
            x = CUSTOM_LAYERS[kind].apply_fn(
                layer, p, x, deterministic=deterministic, generator=generator
            )
        else:
            raise unsupported_layer_error(kind, spec.name)
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


def apply_from_first_preact(
    spec, params: Dict[str, Any], pre: torch.Tensor, *,
    deterministic: bool = True, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Finish the first Dense layer from its pre-activation `pre = x @ kernel`
    and run the remaining layers: concat([a, b]) @ K == a @ K[:da] + b @ K[da:],
    so the per-part matmuls of a split first layer meet here."""
    x = _finish_first(spec, params, pre)
    return _apply_layers(
        spec, spec.layers[1:], params["layers"][1:], x,
        deterministic=deterministic, generator=generator,
    )


def can_factor_last(spec) -> bool:
    """True when the network ends in a linear Dense layer: f(x) = g(x) @ K + b.
    A sum then commutes with the last layer: sum_e f(x_e) = (sum_e g(x_e)) @ K
    + count * b, which moves the final matmul from edge rate to node rate."""
    if not spec.layers:
        return False
    last = spec.layers[-1]
    return last.kind == "Dense" and last.activation in (None, "linear")


def apply_prefix(
    spec, params: Dict[str, Any], x: torch.Tensor, *,
    deterministic: bool = True, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """All layers except the last (see `can_factor_last`)."""
    return _apply_layers(
        spec, spec.layers[:-1], params["layers"][:-1], x,
        deterministic=deterministic, generator=generator,
    )


def prefix_from_first_preact(
    spec, params: Dict[str, Any], pre: torch.Tensor, *,
    deterministic: bool = True, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Finish layer 0 from its pre-activation and run layers 1..n-2 (a split
    first layer and a factored last layer together)."""
    x = _finish_first(spec, params, pre)
    return _apply_layers(
        spec, spec.layers[1:-1], params["layers"][1:-1], x,
        deterministic=deterministic, generator=generator,
    )


def last_dense(spec, params: Dict[str, Any]):
    """(kernel, bias or None) of the final Dense layer (see `can_factor_last`)."""
    p = params["layers"][-1]
    return p["kernel"], (p["bias"] if spec.layers[-1].use_bias else None)


def output_dim(spec, in_dim: int, last_units: Optional[int] = None) -> int:
    """The network's output width for an input of width `in_dim`: the last
    Dense layer's, or a custom layer's that declares `units`."""
    dim = in_dim
    last = _last_dense(spec)
    for j, layer in enumerate(spec.layers):
        if layer.kind == "Dense":
            dim = int(last_units if j == last and last_units is not None else layer.units)
        elif layer.kind in CUSTOM_LAYERS and layer.units is not None:
            # a width-changing custom layer declares 'units' in the
            # description, so that widths are known before params exist
            dim = int(layer.units)
    return dim


def l2_loss(spec, params: Dict[str, Any]) -> torch.Tensor:
    """Sum of kernel_regularizer * sum(kernel**2) over the Dense layers, the
    Keras `regularizers.l2` semantics; a float32 scalar on the kernels'
    device (the CPU for a network without a Dense layer)."""
    kernels = [p["kernel"] for layer, p in zip(spec.layers, params["layers"])
               if layer.kind == "Dense"]
    device = kernels[0].device if kernels else None
    total = torch.zeros((), dtype=torch.float32, device=device)
    for layer, p in zip(spec.layers, params["layers"]):
        if layer.kind == "Dense" and layer.kernel_regularizer > 0.0:
            total = total + layer.kernel_regularizer * torch.sum(p["kernel"] ** 2)
    return total
