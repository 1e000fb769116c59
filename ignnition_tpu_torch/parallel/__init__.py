"""The mesh, multi-process initialization, batch stacking, the data- and
edge-parallel (v1, "replicated") steps and destination sharding (v2,
`edgeshard`, with the `locality` renumbering): the counterpart of
`ignnition_tpu/parallel/`."""

from . import distributed
from .edgeshard import (
    EdgeShardError,
    comm_bytes_per_step,
    halo_fractions,
    make_edgeshard_apply,
    make_edgeshard_train_step,
    partition_batch,
    partition_dims,
)
from .locality import boundary_edge_count, locality_order, reorder_sample
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
    "boundary_edge_count",
    "comm_bytes_per_step",
    "edge_array_keys",
    "EdgeShardError",
    "halo_fractions",
    "locality_order",
    "make_edgeshard_apply",
    "make_edgeshard_train_step",
    "make_parallel_apply",
    "make_parallel_train_step",
    "partition_batch",
    "partition_dims",
    "reorder_sample",
    "stack_batches",
]
