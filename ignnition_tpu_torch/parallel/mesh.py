"""The ('data', 'model') mesh over `torch.distributed` (counterpart of
`ignnition_tpu/parallel/mesh.py`).

Graph-batch data parallelism runs along 'data', edge-partitioned
aggregation along 'model'. A `Mesh` spans the first data * model ranks of
the initialized default process group: rank r sits at
(r // model, r % model), so that the ranks of one data row, which share a
batch and split its edges, are consecutive (and, under torchrun, on one
node when `model` divides its local world). Each rank of the mesh holds
the process group of its data row (`model_group`, the model axis's
collectives) and of its model column (`data_group`), and every rank holds
`group`, the whole mesh. A rank past data * model is outside the mesh
(`coords` None) and takes no step.

The JAX package's `replicated(mesh)` is a sharding object and has no
counterpart: a tensor here lives on one rank. What takes its place is
`replicate`, a broadcast of a parameter (or optimizer) tree from the mesh's
first rank, which the trainer makes before the first step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


def _new_group(ranks: List[int]):
    """A process group of `ranks`, the default group itself when they are the
    whole world. Every rank must make the same calls in the same order."""
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


class Mesh:
    """A data x model grid of the default group's first data * model ranks."""

    def __init__(self, data: int, model: int):
        world, rank = dist.get_world_size(), dist.get_rank()
        self.shape: Dict[str, int] = {"data": data, "model": model}
        self.size = data * model
        # one group per data row, then one per model column, then the mesh:
        # made on every rank in this order
        rows = [_new_group([d * model + m for m in range(model)]) for d in range(data)]
        cols = [_new_group([d * model + m for d in range(data)]) for m in range(model)]
        self.group = _new_group(list(range(self.size)))
        self.coords: Optional[Tuple[int, int]] = None
        self.model_group = self.data_group = None
        if rank < self.size:
            self.coords = (rank // model, rank % model)
            self.model_group, self.data_group = rows[self.coords[0]], cols[self.coords[1]]
        self.backend = dist.get_backend()
        self.world = world

    def require_member(self) -> Tuple[int, int]:
        """This rank's (data, model) place; raises on a rank outside the mesh."""
        if self.coords is None:
            raise ValueError(
                f"rank {dist.get_rank()} lies outside the mesh "
                f"({self.shape['data']} data x {self.shape['model']} model of a "
                f"world of {self.world})"
            )
        return self.coords

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"backend={self.backend!r}, coords={self.coords})")


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The mesh of the first data * model ranks of the initialized default
    process group; raises when the world is smaller."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed default group "
            "(parallel.distributed.initialize, or torchrun and initialize())"
        )
    need = data * model
    have = dist.get_world_size()
    if have < need:
        raise ValueError(
            f"mesh ({data} data x {model} model) needs {need} ranks, have {have}"
        )
    return Mesh(data, model)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor leaf of `tree` (dicts, tuples, lists) from the
    mesh's first rank, in place; other leaves are left as they are."""
    if mesh.coords is None:
        return tree

    def walk(x):
        if isinstance(x, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(x, src=0, group=mesh.group)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(tree)
    return tree
