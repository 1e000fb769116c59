"""Batch classification and stacking (counterpart of
`ignnition_tpu/parallel/steps.py:60-98`, of which these two functions are a
copy: numpy over the port's own `merge_metas` / `repad_to_meta`). The
sharded steps of that module are not ported yet."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..data.graph import BatchMeta, merge_metas, repad_to_meta


def edge_array_keys(model_ir) -> set:
    """Batch keys whose leading dimension is the edge axis of an adjacency."""
    keys = set()
    for a in model_ir.adjacency_info():
        for prefix in ("src_", "dst_", "seq_", "edge_mask_", "params_"):
            keys.add(prefix + a.name)
    for adj in model_ir.readout_adjacencies():
        for prefix in ("src_", "dst_", "seq_", "edge_mask_", "params_"):
            keys.add(prefix + adj)
    return keys


def stack_batches(
    batches: List[Tuple[Dict[str, np.ndarray], BatchMeta]],
    model_ir=None,
) -> Tuple[Dict[str, np.ndarray], BatchMeta]:
    """Stack merged batches on a new leading axis.

    Batches whose padded shapes differ are grown to a common meta first
    (requires `model_ir` for the re-pad)."""
    metas = {m for _, m in batches}
    if len(metas) != 1:
        if model_ir is None:
            raise ValueError(
                f"cannot stack batches with different shapes: {metas}; pass "
                f"model_ir so they can be re-padded to a common bucket"
            )
        target = merge_metas([m for _, m in batches], model_ir)
        batches = [
            (repad_to_meta(arrays, m, target, model_ir), target)
            for arrays, m in batches
        ]
    arrays = {
        k: np.stack([b[k] for b, _ in batches], axis=0) for k in batches[0][0]
    }
    return arrays, batches[0][1]
