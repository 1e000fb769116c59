"""The program under test, `ignnition_tpu_torch`, driven as a user trains with it.

The only module of the benchmark that imports the program. It turns raw
samples into the program's samples, merges them with the program's
`build_batch` under the padding a user gets by default (`PaddingConfig()`,
pow2), copies the batches to the device once, and feeds them to the
compiled training step (`Trainer.train_step_fn(meta)`, replayed from its
CUDA graph by `training.capture`), as `Trainer.train` feeds device-cached
batches. The initial weights are the benchmark's, handed in by name.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

import ignnition_tpu_torch as igt
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data.dataset import AdjacencyArrays, GraphSample
from ignnition_tpu_torch.model.builder import flatten_params, with_leaves


def _affine(table: Dict[str, list]):
    def normalize(value, name):
        a, b = table.get(name, (0.0, 1.0))
        return (value - a) / b

    return normalize


def register(config: dict) -> None:
    """Register the configuration's feature normalizations with the program."""
    for name, table in config["normalizations"].items():
        igt.register_normalization(name, _affine(table))


def sample(raw: dict) -> GraphSample:
    """A raw sample (`gnnbench.generate`) as the program's sample."""
    return GraphSample(
        num_nodes=dict(raw["num_nodes"]),
        features=dict(raw["features"]),
        adjacencies={k: AdjacencyArrays(*v) for k, v in raw["adjacencies"].items()},
        label=raw["label"],
    )


class Program:
    """One trainer, one state and the device batches of a run."""

    def __init__(self, config: dict, device, compute_dtype: str):
        register(config)
        self.ir = igt.parse_model_description(config["description"], config["feature_dims"])
        model = igt.build(self.ir)
        # the layout of the parameter tree; the values are replaced by the benchmark's
        self.structure = model.init(torch.Generator().manual_seed(0))
        self.trainer = igt.Trainer(model, compute_dtype=getattr(torch, compute_dtype),
                                   device=device)
        self.device = self.trainer.device
        self.state = None

    def leaf_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {k: tuple(v.shape) for k, v in flatten_params(self.structure).items()}

    def batch(self, raws: List[dict]):
        """(device arrays, meta) of one merged batch."""
        arrays, meta = igt.build_batch([sample(r) for r in raws], self.ir, igt.PaddingConfig())
        return to_device(arrays, self.device), meta

    def start(self, weights: Dict[str, torch.Tensor]) -> None:
        names = list(flatten_params(self.structure))
        tree = with_leaves(self.structure, [weights[k] for k in names])
        self.state = self.trainer.init_state(params=tree)

    def step(self, arrays, meta) -> Dict[str, torch.Tensor]:
        """One training step through the compiled step of `meta`; the
        metrics stay on the device."""
        self.state, logs = self.trainer.train_step_fn(meta)(self.state, arrays)
        return logs

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in flatten_params(self.state.params).items()}

    def first_moment(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment, by leaf."""
        return {k: v.detach().clone()
                for k, v in flatten_params(self.state.opt_state["mu"]).items()}

    def release(self) -> None:
        """Free the state, the batches' graphs and the cached blocks."""
        self.state = None
        self.trainer = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
