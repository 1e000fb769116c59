"""The training and evaluation steps (counterpart of
`ignnition_tpu/training/trainer.py`: `TrainState`, `Trainer.__init__`,
`init_state`, `_loss`, `train_step_fn`, `eval_step_fn`).

  * loss = model loss + l2 regularization;
  * the forward runs in `compute_dtype` (e.g. bf16) over float32 master
    weights; gradients arrive in float32 on the masters;
  * the optimizer and schedule come from the IR's learning options.

A step runs eagerly; `train_step_fn(meta)` exists so callers are written as
against the JAX package, where it returns the function jitted for that
batch shape. Unlike there, a step updates `state` in place and returns it.
The input pipeline, gradient accumulation, checkpoints and `train()` are
not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from ..batch import resolve_device
from ..data.graph import BatchMeta, PaddingConfig
from ..model.builder import GnnModel, flatten_params, map_params, with_leaves
from .losses import get_loss
from .optimizers import build_optimizer


@dataclass
class TrainState:
    params: Any  # the JAX package's parameter tree; float32 leaves that require grad
    opt_state: Any
    step: int


class Trainer:
    def __init__(
        self,
        model: GnnModel,
        padding: Optional[PaddingConfig] = None,
        normalizations: Optional[Mapping[str, Callable]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        """compute_dtype: e.g. torch.bfloat16 for mixed-precision training
        (float32 master weights, bf16 compute). device: where the state lives
        and the steps run; by default the current CUDA device (pass
        device="cpu" for the CPU)."""
        self.device = resolve_device(device)
        self.model = model
        self.ir = model.ir
        self.padding = padding or PaddingConfig()
        self.normalizations = normalizations
        self.compute_dtype = compute_dtype
        self.loss_fn = get_loss(self.ir.learning.loss)
        self.optimizer = build_optimizer(self.ir.learning.optimizer)

    # ------------------------------------------------------------------

    def init_state(
        self, generator: Optional[torch.Generator] = None, params=None
    ) -> TrainState:
        """A fresh state on the trainer's device: parameters drawn from
        `generator` (seed 0 by default), or a copy of the tree `params`."""
        if params is None:
            generator = generator if generator is not None else torch.Generator().manual_seed(0)
            params = self.model.init(generator)
        params = map_params(
            lambda v: torch.as_tensor(v, dtype=torch.float32)
            .to(self.device, copy=True)
            .requires_grad_(True),
            params,
        )
        return TrainState(params, self.optimizer.init(params), 0)

    # ------------------------------------------------------------------

    def _loss(self, params, batch, meta) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        preds = self.model.apply(params, batch, meta, compute_dtype=self.compute_dtype)
        loss = self.loss_fn(batch["label"], preds, batch["label_mask"])
        reg = self.model.regularization_loss(params)
        return loss + reg, (loss, reg)

    def train_step_fn(self, meta: BatchMeta) -> Callable:
        """`step(state, batch) -> (state, {"loss", "reg", "total"})` for
        device batches of shape `meta`: forward, backward and one optimizer
        update of `state` in place. The metrics stay on the device."""

        grads = self.grads_fn(meta)

        def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
            grad_tree, metrics = grads(state.params, batch)
            self.optimizer.step(state.params, grad_tree, state.opt_state)
            state.step += 1
            return state, metrics

        return step

    def grads_fn(self, meta: BatchMeta) -> Callable:
        """`grads(params, batch) -> (gradient tree, {"loss", "reg", "total"})`:
        the step's forward and backward without the update."""

        def grads(params, batch):
            total, (loss, reg) = self._loss(params, batch, meta)
            g = torch.autograd.grad(total, list(flatten_params(params).values()))
            return with_leaves(params, g), {
                "loss": loss.detach(), "reg": reg.detach(), "total": total.detach()
            }

        return grads

    def eval_step_fn(self, meta: BatchMeta) -> Callable:
        """`step(params, batch) -> (predictions, loss)`, float32 compute and no
        graph, as the JAX package's evaluation step."""

        def step(params, batch):
            with torch.no_grad():
                preds = self.model.apply(params, batch, meta)
                loss = self.loss_fn(batch["label"], preds, batch["label_mask"])
            return preds, loss

        return step
