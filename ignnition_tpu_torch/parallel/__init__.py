"""Batch stacking for gradient accumulation (the data- and edge-parallel
steps of the JAX package's `parallel/` are not ported yet)."""

from .steps import edge_array_keys, stack_batches

__all__ = ["edge_array_keys", "stack_batches"]
