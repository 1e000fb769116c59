"""Faults planted in the timed path, to show that the comparison catches them
(the benchmark's tests at a small size, `calibrate.py` at the cells' sizes).

Each `plant(prog, kind)` replaces the step of a `port.Program`:
  * "unchanged": the step runs, then the parameters and the optimizer's state
    are put back as they were: a step that returns its state unchanged;
  * "half_batch": the second half of the batch's labelled rows is masked out,
    so the loss is the mean over the rest;
  * "altered": every prediction of the model 5% off, where it is produced.
"""

from __future__ import annotations

import torch

KINDS = ("unchanged", "half_batch", "altered")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else ()
    return [t for v in items for t in _tensors(v)]


def half_mask(arrays):
    mask = arrays["label_mask"].clone()
    real = torch.nonzero(mask > 0).flatten()
    mask[real[len(real) // 2:]] = 0
    return {**arrays, "label_mask": mask}


def plant(prog, kind: str) -> None:
    step = prog.step

    def unchanged(arrays, meta):
        held = [t.detach().clone() for t in _tensors((prog.state.params, prog.state.opt_state))]
        logs = step(arrays, meta)
        with torch.no_grad():
            for t, h in zip(_tensors((prog.state.params, prog.state.opt_state)), held):
                t.copy_(h)
        return logs

    def half_batch(arrays, meta):
        return step(half_mask(arrays), meta)

    if kind == "altered":
        model = prog.trainer.model
        apply = model.apply
        model.apply = lambda *a, **k: apply(*a, **k) * 1.05
        return
    prog.step = {"unchanged": unchanged, "half_batch": half_batch}[kind]
