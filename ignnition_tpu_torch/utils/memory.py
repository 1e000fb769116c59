"""Analytic device-memory estimate for one training step (counterpart of
`ignnition_tpu/utils/memory.py`, copied: `estimate_train_hbm`,
`recommended_shards`, `maybe_warn_capacity`; the capacity is the H100's
80 GB).

Answers "does this graph fit on one card, and if not, how many
destination shards does it need?". Itemization:

  * params: ~20 B/param — f32 master weights + Adam slots (m, v) + the
    gradient tree + transient bf16 compute casts;
  * batch: the device-resident batch arrays (pass the exact
    `sum(v.nbytes)` when the batch exists; estimated from BatchMeta
    otherwise);
  * residuals: activations saved for the backward, the dominant term at
    scale — per MP iteration each sequence update saves its [L, n_dst, D]
    time slices (plus the scan's per-step carries), each per-edge chain its
    [E, units] interior activations, and every entity its per-iteration
    state table;
  * workspace: transient scratch, ~2x the largest live edge-rate tensor;
  * library workspace: what cuBLAS keeps per handle and stream
    (`LIBRARY_WORKSPACE_BYTES`), the card's alone: the JAX package's
    estimate has no such term.

The model is deliberately simple and padded-shape based (BatchMeta), like
the roofline. `chip_smoke.py` (phase 12) holds it against
`torch.cuda.max_memory_allocated` of the flagship training step at three
sizes on the card, each the first captured step of a fresh trainer in a
process of its own: the estimate must not fall below the measured peak.
The usable fraction of the card's memory (`USABLE_FRACTION`) is the card's
own, measured by `chip_smoke.py` (phase 12 (b), `usable_fraction`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

# the H100's device memory; override for another card
DEFAULT_HBM_GB = float(os.environ.get("IGNNITION_TPU_HBM_GB", 80.0))
# the share of it a training step can use: what the CUDA context, the
# libraries and the kernels leave (0.9897 of the card), over what the
# caching allocator reserves for what the flagship_x8 step needs, the lesser
# of two paths from a fresh trainer: eager (1.1651x: 0.8494) and replayed
# from CUDA graphs, with the static input copies (1.1532x: 0.8582); the
# least reading so far, 0.8340 (an eager step alone), rounded down; measured
# on an NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py's `usable_fraction`
USABLE_FRACTION = 0.83
# cuBLAS's workspaces: PyTorch gives each (cuBLAS handle, stream) pair one of
# 32 MiB on Hopper, from the caching allocator, and keeps it for the life of
# the process. A trainer's first step meets two new pairs on its own stream
# (the captured steps' side stream): the forward's matmuls on the calling
# thread's handle, the backward's on autograd's thread's. A process that has
# run other steps may reuse pairs (PyTorch hands out streams from a pool of
# 32), a fresh one, as a user's is, pays both: 2 x 32.0 MiB at the peak of
# the flagship's first captured bf16 step, from `torch.cuda.memory`'s
# snapshot (`at::cuda::setWorkspaceForHandle`), NVIDIA H100 80GB HBM3
CUBLAS_WORKSPACE_BYTES = 32 * 2**20
LIBRARY_WORKSPACE_BYTES = 2 * CUBLAS_WORKSPACE_BYTES


def estimate_train_hbm(
    model_ir,
    meta,
    batch_bytes: Optional[float] = None,
    dtype_bytes: int = 2,
) -> Dict[str, float]:
    from .roofline import _mlp_dims, _param_count

    b = dtype_bytes
    state = model_ir.state_dims()
    iters = model_ir.num_iterations

    params_bytes = 20.0 * _param_count(model_ir)

    if batch_bytes is None:
        # features + labels + per-edge index companions (~6 int32 vectors
        # per adjacency counting src/dst/seq + CSR/slice companions)
        batch_bytes = 0.0
        for e in model_ir.entities:
            n = meta.nodes(e.name)
            batch_bytes += n * sum(f.size for f in e.features) * 4
        for info in model_ir.adjacency_info():
            E = meta.edges(info.name)
            batch_bytes += 6 * E * 4
            batch_bytes += E * (info.edge_param_dim or 0) * 4
        batch_bytes += max(meta.label_pad, 1) * 8

    residual = 0.0
    for stage in model_ir.stages:
        for mp in stage.passes:
            d_dst = state[mp.destination]
            n_d = meta.nodes(mp.destination)
            seq_agg = mp.aggregation.kind in ("ordered", "interleave", "concat")
            for src in mp.sources:
                E = meta.edges(src.adj_name)
                d_src = state[src.entity]
                if seq_agg:
                    # [L, n_dst, D] time slices saved for the backward +
                    # the remat scan's per-step carry residuals (~same size)
                    L = dict(meta.max_len).get(src.adj_name) or 1
                    residual += 2 * L * n_d * d_dst * b * iters
                else:
                    # edge-rate message stream saved once per iteration
                    residual += E * max(d_src, d_dst) * b * iters
                # per-edge MLP interior activations
                cur = d_src
                for op in src.ops:
                    if op.kind == "mlp":
                        dims, cur = _mlp_dims(op.mlp, cur)
                        for (_i, o) in dims[:-1]:
                            residual += E * o * b * iters
    for e in model_ir.entities:
        residual += meta.nodes(e.name) * state[e.name] * b * iters

    # dense incidence matrices (block or full), live per iteration's
    # backward when the dense lowering applies
    from ..data.graph import (
        _DENSE_INC_MAX_ENTRIES, _DENSE_INC_MIN_EDGES, dense_agg_adjacencies,
    )

    dense_adjs = dense_agg_adjacencies(model_ir)
    inc_blocks = dict(meta.inc_blocks)
    dense_bytes = 0.0
    for info in model_ir.adjacency_info():
        if info.name not in dense_adjs:
            continue
        if meta.edges(info.name) < _DENSE_INC_MIN_EDGES:
            continue
        blk = inc_blocks.get(info.name)
        entries = (
            blk[0] * blk[1] * blk[2] if blk
            else meta.nodes(info.dst) * meta.nodes(info.src)
        )
        if blk is None and entries > _DENSE_INC_MAX_ENTRIES:
            continue  # the data layer never emits the matrix above the cap
        dense_bytes += entries * b

    # transient fusion scratch: ~2x the largest edge-rate tensor
    biggest = 0.0
    for info in model_ir.adjacency_info():
        E = meta.edges(info.name)
        d = max(state[info.src], state[info.dst])
        biggest = max(biggest, E * d * b)
    workspace = 2.0 * biggest

    total = params_bytes + batch_bytes + residual + dense_bytes + workspace
    total += LIBRARY_WORKSPACE_BYTES
    return {
        "params_bytes": params_bytes,
        "batch_bytes": float(batch_bytes),
        "residual_bytes": residual,
        "dense_inc_bytes": dense_bytes,
        "workspace_bytes": workspace,
        "library_workspace_bytes": float(LIBRARY_WORKSPACE_BYTES),
        "total_bytes": total,
    }


def recommended_shards(total_bytes: float, hbm_gb: float = None) -> int:
    """Destination shards (the mesh's model axis under dest_shard) needed to
    fit. 1 = fits on one card: `USABLE_FRACTION` of its memory."""
    hbm = (hbm_gb or DEFAULT_HBM_GB) * 1e9
    usable = USABLE_FRACTION * hbm
    m = 1
    while total_bytes / m > usable and m < 4096:
        m *= 2
    return m


def maybe_warn_capacity(model_ir, meta, batch_bytes=None, log=None, captured=False) -> int:
    """Estimate the footprint and warn when a single card likely cannot
    hold it; returns the recommended shard count (1 = fits). `captured`:
    the step replays a CUDA graph, whose static input buffers hold one more
    copy of the batch (`training.capture`)."""
    est = estimate_train_hbm(model_ir, meta, batch_bytes=batch_bytes)
    total = est["total_bytes"] + (est["batch_bytes"] if captured else 0.0)
    m = recommended_shards(total)
    if m > 1 and log is not None:
        log.warning(
            "estimated training footprint %.1f GB exceeds the usable %.0f%% of "
            "one card's memory (%.0f GB): train over a mesh with "
            "model_strategy='dest_shard' and a model axis of >=%d "
            "(Trainer.train(mesh=..., model_strategy='dest_shard')) to split "
            "it, or use a smaller batch_size",
            total / 1e9, 100 * USABLE_FRACTION, DEFAULT_HBM_GB, m,
        )
    return m
