"""The comparison that decides `correct`: the program's first three training
steps against the plain reference's, from the same weights on the same
batches.

Three numbers, each against a limit of the cell (`workloads/<cell>.json`):

* `loss_gap`: the first step's |program loss - reference loss| / |reference
  loss| (the later steps' losses part by Adam's first update, which moves
  every weight by about the learning rate in the sign of its gradient, so
  that a weight whose gradient lies within rounding of zero moves either
  way: the float32 reference itself parts from float64 there; they are
  compared through `step_gap`);
* `grad_gap`: the first step's gradient as the optimizer got it (Adam's first
  moment after one step, over 1 - beta_1), by the worst leaf: |norm of the
  program's leaf - norm of the reference's| over the larger of the
  reference's norm of that leaf and of the median leaf;
* `step_gap`: the change of the parameters over the three steps, by the same
  worst-leaf measure.

Leaves whose first gradient is nought to rounding in the reference, under a
thousandth of the median leaf's, move under Adam by round-off alone: they are
left out of `grad_gap` and `step_gap`. A number that is not finite fails.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict

import torch

NAMES = ("loss_gap", "grad_gap", "step_gap")


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> float:
    p, r = _norms(prog), _norms(ref)
    scale = median(r[k] for k in keep)
    return max(abs(p[k] - r[k]) / max(r[k], scale) if math.isfinite(p[k]) else math.inf
               for k in keep)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if math.isfinite(a) else math.inf


def losses_gap(prog: dict, ref: dict) -> float:
    """The largest relative gap of any checked step's loss (not compared;
    `calibrate.py` reports it)."""
    return max(_rel(a, b) for a, b in zip(prog["loss"], ref["loss"]))


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers; `prog` and `ref` each hold "loss" (a list),
    "grad1" and "delta" ({leaf: tensor})."""
    g_ref = _norms(ref["grad1"])
    mid = median(g_ref.values())
    keep = [k for k in ref["grad1"] if g_ref[k] >= 1e-3 * mid]
    return {
        "loss_gap": _rel(prog["loss"][0], ref["loss"][0]),
        "grad_gap": _worst_leaf(prog["grad1"], ref["grad1"], keep),
        "step_gap": _worst_leaf(prog["delta"], ref["delta"], keep),
    }


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(values[k]) and values[k] <= limits[k] for k in NAMES)
