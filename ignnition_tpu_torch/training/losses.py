"""Loss functions, resolved by Keras class name (counterpart of
`ignnition_tpu/training/losses.py`).

Each supported name maps to a masked function `(labels, predictions, mask)
-> scalar`: with merged padded batches the mean must run over real rows
only, which reproduces the unpadded batch loss exactly.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(err * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def mean_squared_error(labels, preds, mask):
    return _masked_mean((preds - labels) ** 2, mask)


def mean_absolute_error(labels, preds, mask):
    return _masked_mean(torch.abs(preds - labels), mask)


def mean_absolute_percentage_error(labels, preds, mask):
    denom = torch.clamp_min(torch.abs(labels), 1e-7)
    return 100.0 * _masked_mean(torch.abs(preds - labels) / denom, mask)


def mean_squared_logarithmic_error(labels, preds, mask):
    l1 = torch.log1p(torch.clamp_min(preds, 0.0))
    l2 = torch.log1p(torch.clamp_min(labels, 0.0))
    return _masked_mean((l1 - l2) ** 2, mask)


def huber(labels, preds, mask, delta: float = 1.0):
    abs_err = torch.abs(preds - labels)
    quad = torch.clamp_max(abs_err, delta)
    lin = abs_err - quad
    return _masked_mean(0.5 * quad**2 + delta * lin, mask)


def log_cosh(labels, preds, mask):
    # stable form |e| + log1p(exp(-2|e|)) - log 2: the naive
    # err + log1p(exp(-2 err)) overflows for err < ~-44 in f32; identical
    # in value since log cosh is even
    err = torch.abs(preds - labels)
    return _masked_mean(err + torch.log1p(torch.exp(-2.0 * err)) - math.log(2.0), mask)


def binary_crossentropy(labels, preds, mask):
    eps = 1e-7
    p = torch.clamp(preds, eps, 1.0 - eps)
    return _masked_mean(-(labels * torch.log(p) + (1 - labels) * torch.log(1 - p)), mask)


def poisson(labels, preds, mask):
    # keras: mean(preds - labels * log(preds + eps)). Padding rows carry
    # unconstrained model outputs; a negative one makes log() NaN and
    # NaN * mask(0) poisons the masked mean, so masked rows are neutralized
    # before the log; real rows are unchanged
    safe = torch.where(mask > 0, preds, torch.ones_like(preds))
    return _masked_mean(safe - labels * torch.log(safe + 1e-7), mask)


def kl_divergence(labels, preds, mask):
    # keras sums the per-element divergence over the feature axis rather
    # than averaging; on flat concatenated predictions that is a sum over
    # all real elements. The `reduction` tag tells accumulated or sharded
    # step constructors to combine partial losses by sum.
    eps = 1e-7
    y = torch.clamp(labels, eps, 1.0)
    p = torch.clamp(preds, eps, 1.0)
    return torch.sum(y * torch.log(y / p) * mask)


kl_divergence.reduction = "sum"


def _hinge_labels(labels, mask):
    # keras converts {0,1} labels to {-1,1} only when all labels are binary;
    # the predicate runs over real rows only (padding zeros must not sway it)
    real = mask > 0
    binary = (labels == 0.0) | (labels == 1.0)
    is_binary = torch.all(torch.where(real, binary, torch.ones_like(binary)))
    return torch.where(is_binary, 2.0 * labels - 1.0, labels)


def hinge(labels, preds, mask):
    y = _hinge_labels(labels, mask)
    return _masked_mean(torch.clamp_min(1.0 - y * preds, 0.0), mask)


def squared_hinge(labels, preds, mask):
    y = _hinge_labels(labels, mask)
    return _masked_mean(torch.clamp_min(1.0 - y * preds, 0.0) ** 2, mask)


LOSSES: Dict[str, Callable] = {
    "MeanSquaredError": mean_squared_error,
    "MeanAbsoluteError": mean_absolute_error,
    "MeanAbsolutePercentageError": mean_absolute_percentage_error,
    "MeanSquaredLogarithmicError": mean_squared_logarithmic_error,
    "Huber": huber,
    "LogCosh": log_cosh,
    "BinaryCrossentropy": binary_crossentropy,
    "Poisson": poisson,
    "KLDivergence": kl_divergence,
    "Hinge": hinge,
    "SquaredHinge": squared_hinge,
}


def get_loss(name: str) -> Callable:
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(
            f"unknown loss '{name}'; supported: {sorted(LOSSES)}"
        ) from None


def loss_reduction(loss_fn: Callable) -> str:
    """'mean' (mask-weighted mean, the default) or 'sum': how accumulated or
    sharded step constructors must combine partial losses."""
    return getattr(loss_fn, "reduction", "mean")
