"""The mesh, multi-process initialization, batch stacking and the data- and
edge-parallel (v1, "replicated") steps (counterpart of
`ignnition_tpu/parallel/`). Destination sharding (v2: `edgeshard`,
`locality`) is not ported yet: ROADMAP item 6 v2."""

from . import distributed
from .mesh import Mesh, make_mesh, replicate
from .steps import (
    batch_partition_specs,
    edge_array_keys,
    make_parallel_apply,
    make_parallel_train_step,
    stack_batches,
)

__all__ = [
    "distributed",
    "Mesh",
    "make_mesh",
    "replicate",
    "batch_partition_specs",
    "edge_array_keys",
    "make_parallel_apply",
    "make_parallel_train_step",
    "stack_batches",
]
