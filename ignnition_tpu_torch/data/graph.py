"""GraphBatch: merged, padded, statically-shaped device representation.

The reference framework feeds one ragged python-dict graph at a time and
"batches" by tracing a python loop over graphs (generate_model.py:712-726).
On TPU that is the wrong shape: XLA wants one statically-shaped program.

Here a batch of B graphs becomes ONE merged graph:
  * per-entity node arrays are concatenated with contiguous offsets, padded to
    a bucket size, with a node mask and per-node graph id;
  * per-adjacency COO edge arrays (src, dst, seq) are concatenated with node
    offsets applied and padded with masked edges;
  * per-destination ordered-message sequences keep their per-sample `seq`
    positions (message passing on a disjoint union of graphs is numerically
    identical to per-graph execution);
  * graph-level readout (pooling) becomes a segment reduction over graph ids.

Bucketed padding keeps the set of compiled shapes small so jit caches stay
warm across steps.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import ml_dtypes
import numpy as np

from .dataset import GraphSample

# --------------------------------------------------------------------------
# Padding policy
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PaddingConfig:
    """How to round dynamic sizes up to static buckets.

    mode "pow2": next power of two (fewest distinct compiled shapes);
    mode "multiple": round up to `multiple`.
    """

    mode: str = "pow2"
    multiple: int = 64
    min_size: int = 8
    seq_multiple: int = 4  # bucket for max_len (RNN time axis)
    # pad every graph's per-entity node block to the batch max (rounded by
    # mode/multiple) so merged batches are ALWAYS uniform and the
    # block-diagonal incidence fast paths apply to streaming workloads of
    # slightly-different-sized samples (see block_sum_adjacencies); costs
    # (max/mean - 1) extra padded rows per entity
    per_graph: bool = False

    def pad_size(self, n: int) -> int:
        n = max(int(n), 1)
        if self.mode == "pow2":
            p = self.min_size
            while p < n:
                p *= 2
            return p
        m = self.multiple
        return max(self.min_size, ((n + m - 1) // m) * m)

    def pad_len(self, n: int) -> int:
        n = max(int(n), 1)
        m = self.seq_multiple
        return ((n + m - 1) // m) * m


# --------------------------------------------------------------------------
# Static batch metadata (part of the jit cache key)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchMeta:
    num_graphs: int
    node_pad: Tuple[Tuple[str, int], ...]  # entity -> padded node count
    edge_pad: Tuple[Tuple[str, int], ...]  # adj name -> padded edge count
    max_len: Tuple[Tuple[str, int], ...]  # adj name -> padded max sequence length
    # interleave tag (interleave_tag(dst, si, mi)) -> combined T_out
    interleave_len: Tuple[Tuple[str, int], ...] = ()
    label_pad: int = 0
    # adj name -> rows of the bounded out-degree backward slice map
    # (0 = not emitted / out-degree unbounded)
    bwd_len: Tuple[Tuple[str, int], ...] = ()
    # adj name -> (G, bd, bs) block-diagonal incidence shape (uniform merged
    # batches only; see block_sum_adjacencies)
    inc_blocks: Tuple[Tuple[str, Tuple[int, int, int]], ...] = ()
    # additional readout input name -> entity whose block layout its rows
    # follow ('' = flat concat; build_batch's per-sample count match — the
    # padded shapes alone can't re-derive this, so sharding reads it here)
    extra_layout: Tuple[Tuple[str, str], ...] = ()
    # FLAT ('' layout) additional input name -> padded row count. Entity-
    # shaped extras derive their rows from node_pad; flat extras' pad is
    # otherwise invisible to the meta, so equal-meta batches could carry
    # different shapes and crash data-parallel stacking
    extra_pad: Tuple[Tuple[str, int], ...] = ()

    def nodes(self, entity: str) -> int:
        return dict(self.node_pad)[entity]

    def edges(self, adj: str) -> int:
        return dict(self.edge_pad)[adj]

    def maxlen(self, adj: str) -> int:
        return dict(self.max_len)[adj]

    def ilv_len(self, tag: str) -> int:
        return dict(self.interleave_len)[tag]


# --------------------------------------------------------------------------
# Label domain inference
# --------------------------------------------------------------------------


def infer_readout_domains(model_ir) -> Dict[str, Tuple[str, str]]:
    """Map every readout tensor name (entities + output_names) to its domain:
    ('entity', name) | ('graph', '') | ('edge', adj_name).

    Needed to lay out labels in the padded batch and to broadcast graph-level
    intermediates back over nodes.
    """
    domains: Dict[str, Tuple[str, str]] = {
        e.name: ("entity", e.name) for e in model_ir.entities
    }
    for op in model_ir.readout:
        if op.kind == "pooling":
            domains[op.output_name] = ("graph", "")
        elif op.kind == "neural_network":
            # the model back-end evaluates the op on the first NON-graph input's
            # domain (graph-level operands broadcast over its rows,
            # GnnModel._readout `target = next(d for d in doms ...)`) — the
            # inferred domain must match or labels/broadcasts mislay
            # (e.g. inputs[0] graph-level + a node-level input)
            doms = [domains.get(n, ("entity", n)) for n in op.inputs]
            domains[op.output_name] = next(
                (d for d in doms if d[0] != "graph"), doms[0]
            )
        elif op.kind == "product":
            d1 = domains.get(op.inputs[0])
            d2 = domains.get(op.inputs[1])
            # a product of a graph-level and node-level tensor is node-level
            pick = d1 if (d1 and d1[0] != "graph") else (d2 or d1)
            domains[op.output_name] = pick or ("graph", "")
        elif op.kind == "extend_adjacencies":
            domains[op.output_names[0]] = ("edge", op.adj_name)
            domains[op.output_names[1]] = ("edge", op.adj_name)
    return domains


def _interleave_passes(model_ir):
    """(stage_idx, stage, mp_idx, mp) for every interleave message passing."""
    for si, stage in enumerate(model_ir.stages):
        for mi, mp in enumerate(stage.passes):
            if mp.aggregation.kind == "interleave":
                yield si, stage, mi, mp


def interleave_tag(dst: str, si: int, mi: int) -> str:
    """Unique batch-key suffix for one interleave message passing.

    Interleave companions were once keyed by destination alone — two
    interleave MPs to the same destination then silently overwrote each
    other's permutation/slice maps (found by the parallel DSL fuzz: the
    fast and scatter paths read DIFFERENT stale halves and disagreed)."""
    return f"{dst}_s{si}m{mi}"


def infer_label_domain(model_ir) -> Tuple[str, str]:
    """Domain of the predict op's output rows (where labels align).

    Same first-non-graph rule as the model back-end's predict evaluation: a
    graph-level input broadcasts over any node/edge-level co-input's rows,
    so the output lands on the first non-graph domain."""
    domains = infer_readout_domains(model_ir)
    op = model_ir.predict_op()
    doms = [domains.get(n, ("entity", n)) for n in op.inputs]
    return next((d for d in doms if d[0] != "graph"), doms[0])


# --------------------------------------------------------------------------
# Batch building
# --------------------------------------------------------------------------



# slots per windowed-sort chunk (see slice_sort_* below): the largest gather
# footprint that still runs near the TPU's random-row-gather peak
_SLICE_SORT_CHUNK = 131072

# dense-incidence cap: a [n_dst, n_src] bf16 multiplicity matrix replaces the
# whole gather + segment-sum round trip of a direct-assignation sum
# aggregation with ONE MXU matmul (out = M @ states; AD's transpose
# d_states = M^T @ d_out replaces the backward too). Reading M is sequential
# HBM traffic, which beats descriptor-bound random row gathers up to this
# size. M scales quadratically with graph size while the gathers scale
# linearly, so there is a crossover: measured on v5e, dense wins at 33M
# entries (245 vs 174 Medges/s) and 134M (189 vs 155), and breaks even at
# 536M (1 GB M) — the default cap sits between the last two.
_DENSE_INC_MAX_ENTRIES = int(
    os.environ.get("IGNNITION_TPU_DENSE_INC_MAX_ENTRIES", 160_000_000)
)
# ... and a floor: for small graphs the step is so cheap that shipping M to
# the device every batch costs more end-to-end than the gathers it saves
# (measured: 28 vs 81 steps/s on a 3k-edge streaming workload, identical
# metrics). Below this many padded edges the gather path wins.
_DENSE_INC_MIN_EDGES = int(
    os.environ.get("IGNNITION_TPU_DENSE_INC_MIN_EDGES", 16384)
)


def dense_agg_adjacencies(model_ir) -> Set[str]:
    """Adjacencies consumed by a single-source source-local vector
    aggregation (sum / convolution / per-destination attention) — the
    eligible set for the dense-incidence matmul paths (ops/segment.py
    direct_segment_sum_dense / dense_attention_aggregate). Source-local
    covers both direct assignation AND MLP-of-hs_source message chains
    (frontend.ir.is_source_local): the model back-end evaluates the chain per
    NODE and the matmul consumes the node-level message table."""
    from ..frontend.ir import is_source_local

    out: Set[str] = set()
    for mp in model_ir.all_passes():
        kind = mp.aggregation.kind
        if kind not in ("sum", "convolution", "attention"):
            continue
        # sums decompose per source (GnnModel._one_source_sum), so every
        # source-local source of a multi-source sum is eligible; attention/
        # convolution dense paths handle a single source only
        if kind != "sum" and len(mp.sources) != 1:
            continue
        if kind == "attention" and mp.aggregation.attention_softmax == "reference":
            continue
        for src in mp.sources:
            if is_source_local(src.ops):
                out.add(src.adj_name)
    return out


def slot_param_adjacencies(model_ir) -> Dict[str, bool]:
    """Adjacencies whose per-edge message MLP reads `edge_params` through a
    slot-eligible chain (frontend.ir.is_slot_eligible — the ONE shared
    predicate) feeding an ordered / sum / attention aggregation.
    build_batch relays their edge params into the [max_len, n_dst, P] slot
    layout (`params_slice_{adj}`) so the slice/slot-rate message paths
    cover edge-param chains too (model/builder.py _slot_messages).

    Maps adj name -> True when an ORDERED aggregation consumes it (the
    [max_len, n_dst] layout is inherent to the scan, so the slot padding
    cap does not apply); False means only capped consumers (sum/attention)
    — build_batch then skips emission when the slot count exceeds
    ir.SLOT_PAD_CAP x edges (a skewed-in-degree graph would otherwise
    materialize a quadratic params_slice the model back-end refuses to read)."""
    from ..frontend.ir import is_slot_eligible

    out: Dict[str, bool] = {}
    for mp in model_ir.all_passes():
        if mp.aggregation.kind not in ("ordered", "sum", "attention"):
            continue
        for src in mp.sources:
            if (
                is_slot_eligible(src.ops)
                and "edge_params" in src.ops[0].inputs
            ):
                uncapped = mp.aggregation.kind == "ordered"
                out[src.adj_name] = out.get(src.adj_name, False) or uncapped
    return out


def block_sum_adjacencies(model_ir) -> Set[str]:
    """Adjacencies eligible for the BLOCK-DIAGONAL batched-matmul sum path.

    The dense incidence matrix of a merged batch of G graphs is
    block-diagonal by graph, so for G equal-sized graphs `M @ states` is a
    [G, bd, bs] batched matmul over per-graph blocks — G x fewer HBM bytes
    than the [G*bd, G*bs] dense matrix, restoring linear throughput scaling
    with batch size (the dense matrix grows quadratically and falls off its
    cap; see PERF.md). Eligibility matches the dense set — sum, convolution,
    and (non-reference-quirk) attention all have block-form lowerings
    (ops/segment.py direct_segment_sum_blocks /
    dense_attention_aggregate_blocks)."""
    return dense_agg_adjacencies(model_ir)



# env escape hatch: IGNNITION_TPU_NATIVE_AUX=0 forces the numpy path
_USE_NATIVE_AUX = os.environ.get("IGNNITION_TPU_NATIVE_AUX", "1") != "0"


def _rle_multiplicities_into(flat, src, dst, n_src):
    """Run-length encode sorted (dst, src) pair keys straight into the
    output buffer — np.add.at into f32 + astype costs ~5x more host time.

    Returns False (buffer untouched beyond partial zeros) when the buffer
    is int8 and a multiplicity exceeds 127 — the caller falls back to
    bf16 (exact for integers up to 256)."""
    if not len(dst):
        return True
    keys = dst.astype(np.int64) * n_src + src
    keys.sort()
    starts = np.concatenate([[0], np.flatnonzero(np.diff(keys)) + 1])
    cnts = np.diff(np.concatenate([starts, [len(keys)]]))
    if flat.dtype == np.int8 and cnts.max(initial=0) > 127:
        return False
    flat[keys[starts]] = cnts.astype(np.float32)
    return True


def _append_dense_inc(
    out, src, dst, e_real, n_src_pad, n_dst_pad, want, int8=False
):
    """Dense incidence (multiplicity) matrix for direct-assignation vector
    aggregations: one MXU matmul replaces the per-edge gather, the
    segment-sum kernel, AND the backward's cotangent gathers (see
    _DENSE_INC_MAX_ENTRIES / _DENSE_INC_MIN_EDGES).

    int8=True stores the matrix as int8 (exact for multiplicities <= 127,
    bf16 fallback above): the matmul paths astype on load and XLA fuses
    the convert into the operand stream — measured 1.6-1.8x on the
    isolated fwd+bwd dense matmul (tools/exp_int8_inc.py), halving the
    dominant HBM stream of the dense stages. The flash-GAT kernels
    upcast the int8 tiles in-register (bit-identical, 1.08x isolated),
    so attention matrices ride the same storage."""
    if not (
        want
        and n_dst_pad * n_src_pad <= _DENSE_INC_MAX_ENTRIES
        and len(dst) >= _DENSE_INC_MIN_EDGES
    ):
        return
    dtype = np.int8 if int8 else ml_dtypes.bfloat16
    flat = np.zeros(n_dst_pad * n_src_pad, dtype)
    if not _rle_multiplicities_into(flat, src[:e_real], dst[:e_real], n_src_pad):
        flat = np.zeros(n_dst_pad * n_src_pad, ml_dtypes.bfloat16)
        _rle_multiplicities_into(flat, src[:e_real], dst[:e_real], n_src_pad)
    out["dense_inc"] = flat.reshape(n_dst_pad, n_src_pad)


def adjacency_aux_arrays(
    src: np.ndarray,
    dst: np.ndarray,
    emask: np.ndarray,
    n_src_pad: int,
    n_dst_pad: int,
    max_len: int,
    bwd_len: Optional[int] = None,
    want_dense_inc: bool = False,
    dense_inc_int8: bool = False,
) -> Dict[str, np.ndarray]:
    """Host-precomputed companions of one destination-sorted edge list.

    Everything the compute path would otherwise derive on device with
    scatters/searchsorted (slow on TPU):
      row_ptr            CSR pointers over destinations
      lens               real in-degree per destination
      src_perm           stable sort of edges by source
      src_sorted         source ids in that order (packed-kernel fallback ids)
      src_row_ptr        CSR pointers over sources (for gather transposes)
      dst_in_src_order   destination id of each source-sorted edge
      emask_src_order    edge mask in source-sorted order
      slice_src          [max_len, n_dst] source node of each (t, dst) slot
                         (direct-assignation ordered updates read source
                         states through this instead of materializing
                         per-edge messages); invalid slots -> last source row
      slice_sort_*       sort of slice_src's flattened slots by source, for
                         the transpose (a sorted segment sum)

    The heavy index computations run in the native C++ core when built
    (native/aux.cpp, O(E) counting sorts that release the GIL — the numpy
    argsorts hold it, defeating multi-worker batch producers); the numpy
    path below is the reference implementation and fallback, and
    tests/test_native_aux.py enforces their exact equality.
    """
    if dst.size and np.any(np.diff(dst) < 0):
        raise ValueError(
            "internal invariant violated: edge list is not destination-sorted"
        )
    e_real = int(np.count_nonzero(emask))
    out = None
    if _USE_NATIVE_AUX:
        from .native_loader import adjacency_aux_native

        out = adjacency_aux_native(
            src,
            dst,
            emask,
            n_src_pad,
            n_dst_pad,
            int(max_len),
            -1 if bwd_len is None else int(bwd_len),
            _SLICE_SORT_CHUNK,
        )
    if out is not None:
        _append_dense_inc(
            out, src, dst, e_real, n_src_pad, n_dst_pad, want_dense_inc,
            int8=dense_inc_int8,
        )
        return out
    out = {}
    # real edges are a prefix (padding edges are appended); CSR pointers are
    # computed over REAL edges only, so the Pallas kernels' per-segment
    # [lo, hi) bounds exclude padding edges without any mask multiply
    row_ptr = np.searchsorted(dst[:e_real], np.arange(n_dst_pad + 1)).astype(
        np.int32
    )
    out["row_ptr"] = row_ptr
    lens = np.bincount(dst[emask > 0], minlength=n_dst_pad).astype(np.float32)
    out["lens"] = lens
    perm = np.argsort(src, kind="stable").astype(np.int32)
    out["src_perm"] = perm
    src_sorted = src[perm].astype(np.int32)
    out["src_sorted"] = src_sorted
    # padding edges carry src == n_src_pad - 1 and follow all real edges in
    # the stable source sort, so the real edges are a prefix here too
    out["src_row_ptr"] = np.searchsorted(
        src_sorted[:e_real], np.arange(n_src_pad + 1)
    ).astype(np.int32)
    out["dst_in_src_order"] = dst[perm].astype(np.int32)
    out["emask_src_order"] = emask[perm].astype(np.float32)

    # src-side (out-degree) slice map for the sum-aggregation backward:
    # d_src[s] = sum_t ct[bwd_slice_dst[t, s]] masked by t < out_lens[s] —
    # eight small table gathers beat the edge-order gather + segment kernel.
    # Only emitted when the max out-degree is bounded (hub sources would
    # blow the [L_out, n_src] table up).
    src_row_ptr = out["src_row_ptr"]
    out_lens = np.diff(src_row_ptr).astype(np.int64)
    l_out = int(out_lens.max()) if out_lens.size else 0
    if bwd_len is None:
        # bucket to a multiple of 4 so batch shapes stay stable across steps
        l_out = ((l_out + 3) // 4) * 4 if 0 < l_out <= 64 else 0
    else:
        l_out = int(bwd_len)  # caller-fixed (re-pad to a shared meta)
    if l_out > 0:
        bwd_slice = np.full((l_out, n_src_pad), n_dst_pad - 1, dtype=np.int32)
        dst_src_order = out["dst_in_src_order"]
        starts = src_row_ptr[:-1].astype(np.int64)
        for t in range(l_out):
            valid = out_lens > t
            idx = starts + t
            bwd_slice[t, valid] = dst_src_order[idx[valid]]
        out["bwd_slice_dst"] = bwd_slice
        out["out_lens"] = out_lens.astype(np.float32)

    _append_dense_inc(
        out, src, dst, e_real, n_src_pad, n_dst_pad, want_dense_inc,
        int8=dense_inc_int8,
    )

    L = int(max_len)
    slice_src = np.full((L, n_dst_pad), n_src_pad - 1, dtype=np.int32)
    lens_i = lens.astype(np.int64)
    starts = row_ptr[:-1].astype(np.int64)
    for t in range(L):
        valid = lens_i > t
        idx = starts + t
        slice_src[t, valid] = src[idx[valid]]
    out["slice_src"] = slice_src
    out.update(slice_sort_companions(slice_src, n_src_pad))
    return out


def interleave_slice_companions(
    mp, perm: np.ndarray, arrays: Mapping[str, np.ndarray], node_pad, max_len
) -> Dict[str, np.ndarray]:
    """Fast-interleave index companions (recurrent updates).

    A slice map over the CONCATENATION of the source entities' node tables:
    ilv_slice[t, d] = combined row of the message at interleaved position t
    for destination d (entity-k padding row when that slot is empty — zero
    after the model back-end's node-mask multiply). Lets the ordered-update
    slice-gather machinery (ops.segment.gather_state_slices) replace the
    per-edge scatter + take_along_axis permutation entirely
    (model/builder.py fast_ilv). Composes the per-adjacency slice_src maps
    with the per-graph interleave permutation host-side.
    """
    dst = mp.destination
    block_lens = [max_len[s.adj_name] for s in mp.sources]
    offsets = np.concatenate([[0], np.cumsum(block_lens)])[:-1]
    gid = np.asarray(arrays[f"graph_id_{dst}"])  # [n_dst_pad]
    rows = np.asarray(perm)[gid]  # [n_dst_pad, t_out] out-slot -> in-slot
    ent_sizes = [node_pad[s.entity] for s in mp.sources]
    ent_off = np.concatenate([[0], np.cumsum(ent_sizes)])[:-1]
    n_comb = int(sum(ent_sizes))
    comb = np.full(rows.shape, n_comb - 1, np.int64)
    for src_s, off_in, e_off in zip(mp.sources, offsets, ent_off):
        l_k = max_len[src_s.adj_name]
        ss = np.asarray(arrays[f"slice_src_{src_s.adj_name}"])  # [l_k, n_dst]
        sel = (rows >= off_in) & (rows < off_in + l_k)
        d_idx, t_idx = np.nonzero(sel)
        lt = rows[d_idx, t_idx] - off_in
        comb[d_idx, t_idx] = e_off + ss[lt, d_idx]
    comb_t = np.ascontiguousarray(comb.T).astype(np.int32)  # [t_out, n_dst]
    cs = slice_sort_companions(comb_t, n_comb)
    return {
        "ilv_slice": comb_t,
        "ilv_sort_perm": cs["slice_sort_perm"],
        "ilv_sort_ids": cs["slice_sort_ids"],
        "ilv_sort_row_ptr": cs["slice_sort_row_ptr"],
    }


def slice_sort_companions(
    slice_src: np.ndarray, n_src_pad: int
) -> Dict[str, np.ndarray]:
    """Windowed sort companions of a [T, n_dst] slice-source table, for the
    gather_state_slices backward (ops/segment.py _gss_bwd).

    Windowed sort: XLA row gathers fall off a ~5x/row cliff once the
    SOURCE array exceeds ~262k rows (measured on v5e). Slots are sorted
    within ~equal windows of <= _SLICE_SORT_CHUNK slots; the backward then
    gathers each window from a SLICED (small) source with LOCAL indices.
    Window c's sources get segment ids offset by c*n_src_pad, so one
    sorted segment sum over windows*n_src segments still works, followed
    by a dense [windows, n_src, D] reduction.

    Runs natively (native/aux.cpp ign_slice_sort, O(slots) counting sorts,
    GIL released) when the library is built; numpy argsort fallback below,
    exact-parity tested (tests/test_native_aux.py)."""
    if _USE_NATIVE_AUX:
        from .native_loader import slice_sort_native

        out = slice_sort_native(slice_src, n_src_pad, _SLICE_SORT_CHUNK)
        if out is not None:
            return out
    flat = slice_src.ravel()
    n_slots = flat.size
    n_chunks = max(1, -(-n_slots // _SLICE_SORT_CHUNK))
    w = -(-n_slots // n_chunks)  # equal-ish window size, derivable device-side
    perms = []
    ids = []
    for c in range(n_chunks):
        lo, hi = c * w, min((c + 1) * w, n_slots)
        p = np.argsort(flat[lo:hi], kind="stable").astype(np.int32)
        perms.append(p)  # LOCAL window indices
        ids.append(flat[lo:hi][p].astype(np.int64) + c * n_src_pad)
    sp = np.concatenate(perms)
    sorted_ids = np.concatenate(ids)
    return {
        "slice_sort_perm": sp,
        "slice_sort_ids": sorted_ids.astype(np.int32),
        "slice_sort_row_ptr": np.searchsorted(
            sorted_ids, np.arange(n_chunks * n_src_pad + 1)
        ).astype(np.int32),
    }


def build_batch(
    samples: Sequence[GraphSample],
    model_ir,
    padding: Optional[PaddingConfig] = None,
    training: bool = True,
    normalizations: Optional[Mapping[str, object]] = None,
    target: Optional[BatchMeta] = None,
) -> Tuple[Dict[str, np.ndarray], BatchMeta]:
    """Merge samples into one padded batch.

    Returns (arrays, meta). Arrays are numpy; move to device with jnp.asarray
    or feed directly to a jitted function.

    `normalizations` maps normalization names to callables `(value, key) ->
    value`; feature and label normalizations declared in the IR are applied
    here, host-side (the reference applies them in a tf.data map,
    generate_model.py:179-186 — preprocessing, not model).

    `target` pins every padded size to an existing BatchMeta (serving
    artifacts, cross-host shape alignment): the returned meta equals
    `target`, block-diagonal incidence is emitted exactly where `target`
    has it (using its per-graph slot sizes), and a friendly ValueError is
    raised when any real size does not fit. Additional readout inputs
    (model_ir.additional_inputs) still pad by `padding` — their sizes are
    not recorded in BatchMeta.
    """
    padding = padding or PaddingConfig()
    if normalizations is None:
        from ..utils.registry import normalizations as _global_registry

        normalizations = _global_registry()
    num_graphs = len(samples)
    entities = model_ir.entities
    adj_info = model_ir.adjacency_info()

    # sequence-shaped multi-source aggregations (interleave, concat) can
    # have EMPTY slots inside the masked sequence length; the fast slice
    # paths realize those gaps by pointing at the entity's LAST padded node
    # row (zero after the node-mask multiply). That row must therefore be a
    # real padding row — these source entities always get at least one.
    needs_pad_row = {
        src.entity
        for mp in model_ir.all_passes()
        if mp.aggregation.kind in ("interleave", "concat")
        or (mp.aggregation.kind == "ordered" and len(mp.sources) > 1)
        for src in mp.sources
    }

    # target pinning: per-entity slot sizes implied by the target's
    # block-diagonal incidence shapes (graph g's rows must occupy
    # [g*slot, (g+1)*slot) for those entities)
    pinned_slots: Dict[str, int] = {}
    if target is not None:
        if target.num_graphs != num_graphs:
            raise ValueError(
                f"target meta was built for {target.num_graphs} graphs per "
                f"batch, got {num_graphs} samples"
            )
        for a in adj_info:
            blk = dict(target.inc_blocks).get(a.name)
            if blk is None:
                continue
            _, bd_, bs_ = blk
            for ent, size in ((a.src, bs_), (a.dst, bd_)):
                if pinned_slots.setdefault(ent, size) != size:
                    raise ValueError(
                        "target meta has inconsistent per-graph block sizes "
                        f"for entity '{ent}'"
                    )

    feature_entities = {}
    feature_norm = {}
    for e in entities:
        for f in e.features:
            feature_entities[f.name] = e.name
            feature_norm[f.name] = f.normalization

    def normalize(name, value, norm_key):
        if norm_key is None or str(norm_key) == "None":
            return value
        fn = normalizations.get(norm_key)
        if fn is None:
            raise KeyError(
                f"the normalization function '{norm_key}' is not registered; "
                f"pass it via the normalizations registry"
            )
        return np.asarray(fn(value, name), dtype=np.float32)

    # ---- node counts and offsets ----
    node_offsets: Dict[str, List[int]] = {e.name: [] for e in entities}
    node_totals: Dict[str, int] = {e.name: 0 for e in entities}
    for s in samples:
        for e in entities:
            node_offsets[e.name].append(node_totals[e.name])
            node_totals[e.name] += s.num_nodes.get(e.name, 0)
    if target is not None:
        node_pad_t = dict(target.node_pad)
        node_pad = dict(node_pad_t)
        for e in entities:
            slot = pinned_slots.get(e.name)
            if slot is not None:
                mx = max((s.num_nodes.get(e.name, 0) for s in samples), default=0)
                if (
                    e.name in needs_pad_row
                    and num_graphs * slot == node_pad_t[e.name]
                ):
                    mx += 1  # no global tail: the last block keeps a masked row
                if mx > slot or num_graphs * slot > node_pad_t[e.name]:
                    raise ValueError(
                        f"entity '{e.name}' does not fit the target meta: "
                        f"max per-graph count {mx} vs block slot {slot} "
                        f"(node pad {node_pad_t[e.name]})"
                    )
                node_offsets[e.name] = [g * slot for g in range(num_graphs)]
            elif node_totals[e.name] + (
                1 if e.name in needs_pad_row else 0
            ) > node_pad_t[e.name]:
                raise ValueError(
                    f"entity '{e.name}' does not fit the target meta: "
                    f"{node_totals[e.name]} real rows vs padded "
                    f"{node_pad_t[e.name]}"
                    + (
                        " (sequence-shaped aggregations need one masked "
                        "padding row)"
                        if e.name in needs_pad_row
                        and node_totals[e.name] <= node_pad_t[e.name]
                        else ""
                    )
                )
    elif padding.per_graph:
        # uniform per-graph blocks: graph g's entity block occupies
        # [g*size, (g+1)*size) regardless of its real count, so the merged
        # batch is always uniform (block-diagonal incidence eligible)
        def _slot(e):
            mx = max((s.num_nodes.get(e.name, 0) for s in samples), default=1)
            slot = padding.pad_size(mx)
            if e.name in needs_pad_row and slot == mx:
                # guarantee a masked row in the LAST graph's block with a
                # minimal sub-bucket bump (see _pad below)
                slot = ((mx + 16) // 16) * 16
            return slot

        per_graph_size = {e.name: _slot(e) for e in entities}
        node_offsets = {
            e.name: [g * per_graph_size[e.name] for g in range(num_graphs)]
            for e in entities
        }
        node_pad = {
            e.name: num_graphs * per_graph_size[e.name] for e in entities
        }
    else:

        def _pad(e):
            n = node_totals[e.name]
            p = padding.pad_size(n)
            if e.name in needs_pad_row and p == n:
                # minimal sub-bucket bump: one masked row without jumping a
                # whole padding bucket (2048 -> 2304 measured a 4% step tax
                # on the Q-size family; 2048 -> 2064 is ~free)
                p = ((n + 16) // 16) * 16
            return p

        node_pad = {e.name: _pad(e) for e in entities}

    arrays: Dict[str, np.ndarray] = {}

    for e in entities:
        n_real, n_pad = node_totals[e.name], node_pad[e.name]
        mask = np.zeros(n_pad, dtype=np.float32)
        # padding nodes belong to a sentinel graph slot (last graph) but are
        # masked everywhere it matters
        gid = np.full(n_pad, max(num_graphs - 1, 0), dtype=np.int32)
        for g, s in enumerate(samples):
            n = s.num_nodes.get(e.name, 0)
            off = node_offsets[e.name][g]
            mask[off : off + n] = 1.0
            gid[off : off + n] = g
        arrays[f"node_mask_{e.name}"] = mask
        arrays[f"graph_id_{e.name}"] = gid
        arrays[f"num_{e.name}"] = np.asarray(n_real, dtype=np.int32)

        for f in e.features:
            buf = np.zeros((n_pad, f.size), dtype=np.float32)
            for g, s in enumerate(samples):
                v = s.features[f.name]
                v = normalize(f.name, v, feature_norm[f.name])
                off = node_offsets[e.name][g]
                buf[off : off + v.shape[0]] = v
            arrays[f.name] = buf

    # ---- adjacencies ----
    edge_pad: Dict[str, int] = {}
    max_len: Dict[str, int] = {}
    # adjacencies concatenated on the feature axis (concat axis=2) must share
    # one padded max_len (the reference concatenates [N, L, D] blocks on axis
    # 2, generate_model.py:503)
    concat2_groups = [
        [src.adj_name for src in mp.sources]
        for mp in model_ir.all_passes()
        if mp.aggregation.kind == "concat" and mp.aggregation.concat_axis == 2
    ]
    for a in adj_info:
        e_total = sum(len(s.adjacencies[a.name].src_idx) for s in samples)
        ml = 1
        for s in samples:
            seq = s.adjacencies[a.name].seq
            if len(seq):
                ml = max(ml, int(seq.max()) + 1)
        if target is not None:
            e_pad = target.edges(a.name)
            ml_pad = target.maxlen(a.name)
            if e_total > e_pad or ml > ml_pad:
                raise ValueError(
                    f"adjacency '{a.name}' does not fit the target meta: "
                    f"{e_total} edges / max_len {ml} vs padded "
                    f"{e_pad} / {ml_pad}"
                )
        else:
            e_pad = padding.pad_size(e_total)
            ml_pad = padding.pad_len(ml)
        edge_pad[a.name] = e_pad
        max_len[a.name] = ml_pad
    if target is None:
        for group in concat2_groups:
            common = max(max_len[a] for a in group)
            for a in group:
                max_len[a] = common
    dense_adjs = dense_agg_adjacencies(model_ir)
    slot_param_adjs = slot_param_adjacencies(model_ir)
    block_adjs = block_sum_adjacencies(model_ir)
    inc_blocks_meta: Dict[str, Tuple[int, int, int]] = {}
    bwd_len_map: Dict[str, int] = {}
    # per-adjacency destination-sort permutation over the real-edge prefix
    # (sorted[i] = insertion_order[order[i]]) — edge-domain labels and
    # user-facing edge predictions must follow the same reordering
    edge_sort_order: Dict[str, np.ndarray] = {}
    for a in adj_info:
        e_pad = edge_pad[a.name]
        # padding edges point at the LAST padded source/destination rows so
        # the edge list stays sorted by destination (real edges are
        # destination-ordered per sample with increasing per-sample offsets)
        # AND sorts as a suffix in the source-sorted view — required by the
        # Pallas sorted-COO segment kernels, whose real-edge-only CSR bounds
        # then exclude padding without mask multiplies
        src = np.full(e_pad, node_pad[a.src] - 1, dtype=np.int32)
        dst = np.full(e_pad, node_pad[a.dst] - 1, dtype=np.int32)
        seq_arr = np.zeros(e_pad, dtype=np.int32)
        emask = np.zeros(e_pad, dtype=np.float32)
        params = (
            np.zeros((e_pad, a.edge_param_dim), dtype=np.float32)
            if a.has_params
            else None
        )
        pos = 0
        for g, s in enumerate(samples):
            arrs = s.adjacencies[a.name]
            n = len(arrs.src_idx)
            src[pos : pos + n] = arrs.src_idx + node_offsets[a.src][g]
            dst[pos : pos + n] = arrs.dst_idx + node_offsets[a.dst][g]
            seq_arr[pos : pos + n] = arrs.seq
            emask[pos : pos + n] = 1.0
            if params is not None and arrs.params is not None:
                params[pos : pos + n] = arrs.params
            pos += n
        # destination-sort the real edges: samples list adjacency dicts in
        # INSERTION order (reference semantics), which need not follow the
        # entity numbering — but all downstream compute depends only on
        # (dst, seq), and the sorted-COO fast paths / CSR companions require
        # global destination order (stable sort keeps per-dst seq ascending)
        order = np.argsort(dst[:pos], kind="stable")
        edge_sort_order[a.name] = order
        src[:pos] = src[:pos][order]
        dst[:pos] = dst[:pos][order]
        seq_arr[:pos] = seq_arr[:pos][order]
        if params is not None:
            params[:pos] = params[:pos][order]
        arrays[f"src_{a.name}"] = src
        arrays[f"dst_{a.name}"] = dst
        arrays[f"seq_{a.name}"] = seq_arr
        arrays[f"edge_mask_{a.name}"] = emask
        if params is not None:
            arrays[f"params_{a.name}"] = params
        # block-diagonal incidence for uniform merged batches: graph g's
        # real src rows occupy [g*bs, (g+1)*bs) in the merged table (offsets
        # are cumsums of uniform real counts), so the batched matmul needs no
        # gathers — pure reshapes around one [G, bd, bs] dot_general
        want_blocks = a.name in block_adjs and num_graphs >= 2
        if target is not None:
            # emit blocks exactly where the target meta has them, at its
            # block shape (node offsets already follow the pinned slots)
            blk = dict(target.inc_blocks).get(a.name)
            want_blocks = blk is not None
        if want_blocks:
            ns_list = [s.num_nodes.get(a.src, 0) for s in samples]
            nd_list = [s.num_nodes.get(a.dst, 0) for s in samples]
            if target is not None:
                _, bd_, bs_ = dict(target.inc_blocks)[a.name]
                uniform = True
            elif padding.per_graph:
                # uniform block layout by construction; blocks span the
                # whole per-graph slot (real rows are a prefix of each)
                bs_ = node_pad[a.src] // num_graphs
                bd_ = node_pad[a.dst] // num_graphs
                uniform = bs_ > 0 and bd_ > 0
            else:
                bs_, bd_ = ns_list[0], nd_list[0]
                uniform = (
                    bs_ > 0
                    and bd_ > 0
                    and all(v == bs_ for v in ns_list)
                    and all(v == bd_ for v in nd_list)
                )
            if target is not None or (
                uniform
                and num_graphs * bd_ * bs_ <= _DENSE_INC_MAX_ENTRIES
                and len(dst) >= _DENSE_INC_MIN_EDGES
            ):
                # int8 storage (bf16 fallback on multiplicity overflow) —
                # see _append_dense_inc
                blk_dtype = np.int8
                while True:
                    blocks = np.zeros((num_graphs, bd_ * bs_), blk_dtype)
                    ok = True
                    for g, s in enumerate(samples):
                        arrs = s.adjacencies[a.name]
                        ok = ok and _rle_multiplicities_into(
                            blocks[g],
                            arrs.src_idx.astype(np.int64),
                            arrs.dst_idx.astype(np.int64),
                            bs_,
                        )
                    if ok or blk_dtype != np.int8:
                        break
                    blk_dtype = ml_dtypes.bfloat16
                arrays[f"inc_blocks_{a.name}"] = blocks.reshape(
                    num_graphs, bd_, bs_
                )
                inc_blocks_meta[a.name] = (num_graphs, bd_, bs_)
        # host-precomputed index companions (CSR pointers, in-degrees,
        # source-sorted views, per-(t,dst) slice sources) — on-device
        # equivalents cost scatters/searchsorted every iteration
        aux = adjacency_aux_arrays(
            src,
            dst,
            emask,
            node_pad[a.src],
            node_pad[a.dst],
            max_len[a.name],
            bwd_len=(
                dict(target.bwd_len).get(a.name, 0)
                if target is not None
                else None
            ),
            want_dense_inc=a.name in dense_adjs
            and a.name not in inc_blocks_meta,
            dense_inc_int8=True,
        )
        if target is not None and "out_lens" in aux:
            fixed = dict(target.bwd_len).get(a.name, 0)
            if fixed and aux["out_lens"].max(initial=0) > fixed:
                raise ValueError(
                    f"adjacency '{a.name}' does not fit the target meta: max "
                    f"out-degree {int(aux['out_lens'].max())} exceeds the "
                    f"target's backward slice height {fixed}"
                )
        for key, value in aux.items():
            arrays[f"{key}_{a.name}"] = value
        bwd_len_map[a.name] = (
            aux["bwd_slice_dst"].shape[0] if "bwd_slice_dst" in aux else 0
        )
        if params is not None and a.name in slot_param_adjs:
            # edge params relaid into the [max_len, n_dst, P] slot layout so
            # the slice/slot-rate message paths cover edge-param chains
            # (invalid slots zero; consumers mask by in-degree). Capped
            # consumers (sum/attention) skip emission when the slot padding
            # exceeds the model back-end's cap — it would refuse the layout anyway
            from ..frontend.ir import SLOT_PAD_CAP

            slot_count = max_len[a.name] * node_pad[a.dst]
            if slot_param_adjs[a.name] or slot_count <= SLOT_PAD_CAP * e_pad:
                real = emask > 0
                ps = np.zeros(
                    (max_len[a.name], node_pad[a.dst]) + params.shape[1:],
                    params.dtype,
                )
                ps[seq_arr[real], dst[real]] = params[real]
                arrays[f"params_slice_{a.name}"] = ps

    # ---- interleave permutations ----
    # For each interleave destination, a per-graph permutation of the merged
    # message time axis: out_slot -> in_slot, where the input axis is the
    # concatenation of per-source padded blocks in the order the sources
    # appear in the message passing (see model/aggregations.py).
    interleave_len: Dict[str, int] = {}
    for _si, _stage, _mi, mp in _interleave_passes(model_ir):
        dst = mp.destination
        tag = interleave_tag(dst, _si, _mi)
        block_lens = [max_len[src.adj_name] for src in mp.sources]
        offsets = np.concatenate([[0], np.cumsum(block_lens)])[:-1]
        t_out = int(sum(block_lens))
        interleave_len[tag] = t_out
        perm = np.zeros((num_graphs, t_out), dtype=np.int32)
        for g, s in enumerate(samples):
            p = np.full(t_out, -1, dtype=np.int32)
            used_out = np.zeros(t_out, dtype=bool)
            for src, off in zip(mp.sources, offsets):
                idx = s.interleave.get((src.entity, dst))
                if idx is None:
                    raise KeyError(
                        f"sample {g} lacks an interleave index vector for "
                        f"({src.entity} -> {dst})"
                    )
                k = min(len(idx), max_len[src.adj_name])
                p[idx[:k]] = off + np.arange(k, dtype=np.int32)
                used_out[idx[:k]] = True
            # route padding input slots to the unused output slots
            free_out = np.where(~used_out)[0]
            used_in = set(int(v) for v in p[p >= 0])
            free_in = np.asarray(
                [i for i in range(t_out) if i not in used_in], dtype=np.int32
            )
            p[free_out] = free_in[: len(free_out)]
            perm[g] = p
        arrays[f"interleave_perm_{tag}"] = perm

        if mp.update.kind == "recurrent":
            for key, value in interleave_slice_companions(
                mp, perm, arrays, node_pad, max_len
            ).items():
                arrays[f"{key}_{tag}"] = value
    # ---- labels ----
    label_pad = 0
    if training and any(s.label is not None for s in samples):
        unlabeled = [g for g, s in enumerate(samples) if s.label is None]
        if unlabeled:
            raise ValueError(
                f"samples {unlabeled} in this batch have no label while "
                f"others do; training batches must be uniformly labeled "
                f"(filter unlabeled samples out, or build with "
                f"training=False for prediction)"
            )
        domain = infer_label_domain(model_ir)
        _, norm_key, _ = model_ir.output_info()
        label_name = model_ir.output_info()[0]
        if domain[0] == "entity":
            n_pad = node_pad[domain[1]]
            label = np.zeros(n_pad, dtype=np.float32)
            lmask = np.zeros(n_pad, dtype=np.float32)
            for g, s in enumerate(samples):
                v = s.label
                off = node_offsets[domain[1]][g]
                label[off : off + len(v)] = v
                lmask[off : off + len(v)] = 1.0
            label_pad = n_pad
        elif domain[0] == "graph":
            label = np.zeros(num_graphs, dtype=np.float32)
            lmask = np.ones(num_graphs, dtype=np.float32)
            for g, s in enumerate(samples):
                v = np.asarray(s.label).reshape(-1)
                if v.size != 1:
                    raise ValueError(
                        f"graph-level labels must be one scalar per graph "
                        f"(sample {g} has {v.size} values for the pooled "
                        f"prediction); for per-node targets predict on the "
                        f"entity domain instead"
                    )
                label[g] = float(v[0])
            label_pad = num_graphs
        else:  # edge domain
            adj = domain[1]
            e_pad = edge_pad[adj]
            label = np.zeros(e_pad, dtype=np.float32)
            lmask = np.zeros(e_pad, dtype=np.float32)
            pos = 0
            for s in samples:
                v = s.label
                label[pos : pos + len(v)] = v
                lmask[pos : pos + len(v)] = 1.0
                pos += len(v)
            # samples list edge labels in the adjacency dict's insertion
            # order; the merged edge arrays were destination-sorted above —
            # reorder the label the same way so row i matches edge i
            order = edge_sort_order.get(adj)
            if order is not None and len(order):
                label[: len(order)] = label[: len(order)][order]
                lmask[: len(order)] = lmask[: len(order)][order]
            label_pad = e_pad
        safe = np.where(lmask > 0, label, 1.0)  # keep norm fns off padding zeros
        label = np.where(
            lmask > 0,
            normalize(label_name, safe, norm_key),
            label,
        ).astype(np.float32)
        arrays["label"] = label
        arrays["label_mask"] = lmask

    if not training:
        # predict batches of edge-domain models carry the inverse sort
        # permutation so user-facing predictions can be returned in each
        # sample's original (insertion-order) edge order:
        # preds_original = preds_sorted[label_perm]
        domain = infer_label_domain(model_ir)
        if domain[0] == "edge":
            e_pad_d = edge_pad[domain[1]]
            perm = np.arange(e_pad_d, dtype=np.int32)
            order = edge_sort_order.get(domain[1])
            if order is not None and len(order):
                inv = np.empty(len(order), dtype=np.int32)
                inv[order] = np.arange(len(order), dtype=np.int32)
                perm[: len(order)] = inv
            arrays["label_perm"] = perm

    # ---- additional readout inputs ----
    extra_layout: Dict[str, str] = {}
    extra_pad_map: Dict[str, int] = {}
    for name in model_ir.additional_inputs():
        vals = [
            np.asarray(s.extras[name]).reshape(len(s.extras[name]), -1)
            for s in samples
        ]
        # entity-shaped inputs (one row per node of some entity in every
        # sample) must follow that entity's block layout — per-graph slots
        # and pinned target metas place node rows at block offsets, not
        # contiguously. Row-count matching is a heuristic (the dataset
        # format carries no domain metadata, reference input_fn declares
        # additional inputs as flat [None] vectors): if counts coincide
        # with several entities whose layouts differ, we warn and pick the
        # first declared one.
        matches = [
            e.name
            for e in entities
            if all(
                v.shape[0] == s.num_nodes.get(e.name, 0)
                for v, s in zip(vals, samples)
            )
        ]
        layouts_differ = len(
            {
                (tuple(node_offsets[m]), node_pad[m])
                for m in matches
            }
        ) > 1
        if layouts_differ:
            logging.getLogger("ignnition_tpu_torch").warning(
                "additional readout input '%s' matches the node counts of "
                "several entities (%s) with different layouts; assuming "
                "'%s'",
                name,
                ", ".join(matches),
                matches[0],
            )
        ent = matches[0] if matches else None
        extra_layout[name] = ent or ""
        if ent is not None:
            buf = np.zeros(
                (node_pad[ent], vals[0].shape[1]), dtype=vals[0].dtype
            )
            for g, v in enumerate(vals):
                off = node_offsets[ent][g]
                buf[off : off + len(v)] = v
        else:
            flat = np.concatenate(vals, axis=0)
            pad_n = padding.pad_size(flat.shape[0])
            if target is not None:
                t = dict(getattr(target, "extra_pad", ())).get(name)
                if t is not None:
                    if flat.shape[0] > t:
                        raise ValueError(
                            f"additional input '{name}' does not fit the "
                            f"target meta: {flat.shape[0]} rows exceed the "
                            f"target's {t}"
                        )
                    pad_n = t
            extra_pad_map[name] = pad_n
            buf = np.zeros((pad_n,) + flat.shape[1:], dtype=flat.dtype)
            buf[: flat.shape[0]] = flat
        arrays[name] = np.squeeze(buf, axis=-1) if buf.shape[-1] == 1 else buf

    meta = BatchMeta(
        num_graphs=num_graphs,
        node_pad=tuple(sorted(node_pad.items())),
        edge_pad=tuple(sorted(edge_pad.items())),
        max_len=tuple(sorted(max_len.items())),
        interleave_len=tuple(sorted(interleave_len.items())),
        label_pad=label_pad,
        bwd_len=tuple(sorted(bwd_len_map.items())),
        inc_blocks=tuple(sorted(inc_blocks_meta.items())),
        extra_layout=tuple(sorted(extra_layout.items())),
        extra_pad=tuple(sorted(extra_pad_map.items())),
    )
    return arrays, meta


# --------------------------------------------------------------------------
# Re-padding to a common meta (for stacking data-parallel batches)
# --------------------------------------------------------------------------


def merge_metas(metas: Sequence[BatchMeta], model_ir=None) -> BatchMeta:
    """Elementwise max of batch metas (num_graphs must already agree).

    Pass `model_ir` when the model has interleave passes: their combined
    sequence length is the SUM of the merged per-adjacency max_lens — which
    can exceed the elementwise max of the per-batch sums (batches with
    swapped long/short blocks), and repad_to_meta rebuilds the permutation
    arrays at that sum."""
    ng = {m.num_graphs for m in metas}
    if len(ng) != 1:
        raise ValueError(f"cannot merge metas with different num_graphs: {ng}")

    def _max(field):
        out: Dict[str, int] = {}
        for m in metas:
            for k, v in getattr(m, field):
                out[k] = max(out.get(k, 0), v)
        return tuple(sorted(out.items()))

    # bwd_len: 0 means "out-degree unbounded, slice map not emitted" — if any
    # batch opted out, the merged batch must too (a smaller cap would drop
    # cotangent contributions)
    bwd: Dict[str, int] = {}
    for m in metas:
        for k, v in m.bwd_len:
            bwd[k] = 0 if (k in bwd and min(bwd[k], v) == 0) or v == 0 else max(
                bwd.get(k, v), v
            )

    # inc_blocks: block shapes depend on per-graph REAL counts, so stacked
    # device batches can only share the block path when every batch emitted
    # identical shapes — otherwise drop (repad removes the arrays)
    ib: Dict[str, Tuple[int, int, int]] = dict(metas[0].inc_blocks)
    for m in metas[1:]:
        d = dict(m.inc_blocks)
        ib = {k: v for k, v in ib.items() if d.get(k) == v}

    # extra_layout is a per-batch row-count heuristic; silently stamping
    # batch 0's choice onto a batch that resolved an additional input to a
    # DIFFERENT entity would shard that batch's rows by the wrong blocks
    layouts = {m.extra_layout for m in metas}
    if len(layouts) > 1:
        raise ValueError(
            "cannot stack batches whose additional readout inputs resolved "
            f"to different entity layouts: {sorted(layouts)}"
        )

    max_len = _max("max_len")
    ilv = dict(_max("interleave_len"))
    if model_ir is not None and ilv:
        ml = dict(max_len)
        for _si, _stage, _mi, mp in _interleave_passes(model_ir):
            tag = interleave_tag(mp.destination, _si, _mi)
            if tag in ilv:
                ilv[tag] = int(sum(ml[s.adj_name] for s in mp.sources))

    return BatchMeta(
        num_graphs=next(iter(ng)),
        node_pad=_max("node_pad"),
        edge_pad=_max("edge_pad"),
        max_len=max_len,
        interleave_len=tuple(sorted(ilv.items())),
        label_pad=max(m.label_pad for m in metas),
        bwd_len=tuple(sorted(bwd.items())),
        inc_blocks=tuple(sorted(ib.items())),
        extra_layout=metas[0].extra_layout,
        extra_pad=_max("extra_pad"),
    )


def repad_to_meta(
    arrays: Dict[str, np.ndarray],
    meta: BatchMeta,
    target: BatchMeta,
    model_ir,
) -> Dict[str, np.ndarray]:
    """Grow a batch's padding to `target` (every target size >= current).

    Trailing zero-padding is semantics-preserving for node/edge/label arrays
    (masks already gate everything); interleave permutations are rebuilt to
    the new block offsets.
    """
    out = dict(arrays)
    node_pad_t, node_pad_c = dict(target.node_pad), dict(meta.node_pad)
    edge_pad_t, edge_pad_c = dict(target.edge_pad), dict(meta.edge_pad)

    def pad_rows(a: np.ndarray, rows: int, fill=0) -> np.ndarray:
        if a.shape[0] >= rows:
            return a
        width = ((0, rows - a.shape[0]),) + ((0, 0),) * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    feature_entities = {}
    for e in model_ir.entities:
        for f in e.features:
            feature_entities[f.name] = e.name

    for e in model_ir.entities:
        n = node_pad_t[e.name]
        out[f"node_mask_{e.name}"] = pad_rows(out[f"node_mask_{e.name}"], n)
        out[f"graph_id_{e.name}"] = pad_rows(
            out[f"graph_id_{e.name}"], n, fill=max(meta.num_graphs - 1, 0)
        )
        for f in e.features:
            out[f.name] = pad_rows(out[f.name], n)

    adj_info = {a.name: a for a in model_ir.adjacency_info()}
    # loop-invariant IR walks and target-meta dict views, hoisted: repad
    # runs per batch on the host data path (multi-worker producers)
    dense_adjs = dense_agg_adjacencies(model_ir)
    slot_param_adjs = slot_param_adjacencies(model_ir)
    inc_blocks_t = dict(target.inc_blocks)
    max_len_t = dict(target.max_len)
    bwd_len_t = dict(target.bwd_len)
    for name in edge_pad_t:
        ne = edge_pad_t[name]
        for prefix in ("src_", "dst_", "seq_", "edge_mask_", "params_"):
            k = prefix + name
            if k in out:
                if prefix in ("src_", "dst_") and name in adj_info:
                    a = adj_info[name]
                    fill = node_pad_t[a.dst if prefix == "dst_" else a.src] - 1
                    # existing padding rows must also move to the new last row
                    # to preserve sortedness / the suffix invariant
                    cur = out[k]
                    emask = out.get("edge_mask_" + name)
                    if emask is not None:
                        cur = np.where(emask[: len(cur)] > 0, cur, fill)
                    out[k] = pad_rows(cur, ne, fill=fill)
                else:
                    out[k] = pad_rows(out[k], ne)
        if name in adj_info and f"row_ptr_{name}" in out:
            a = adj_info[name]
            for stale in (
                f"bwd_slice_dst_{name}",
                f"out_lens_{name}",
                f"dense_inc_{name}",
            ):
                out.pop(stale, None)
            # blocks only cover REAL rows, which trailing padding growth
            # never touches — keep them iff the target meta kept them
            if name not in inc_blocks_t:
                out.pop(f"inc_blocks_{name}", None)
            for key, value in adjacency_aux_arrays(
                out[f"src_{name}"],
                out[f"dst_{name}"],
                out[f"edge_mask_{name}"],
                node_pad_t[a.src],
                node_pad_t[a.dst],
                max_len_t[name],
                bwd_len=bwd_len_t.get(name, 0),
                want_dense_inc=name in dense_adjs
                and name not in inc_blocks_t,
                dense_inc_int8=True,
            ).items():
                out[f"{key}_{name}"] = value
            if name in slot_param_adjs and f"params_{name}" in out:
                # the slot relayout is shaped [max_len, n_dst, P]. Presence
                # must be a pure function of the TARGET meta, not of what
                # this batch happened to emit (the cap check
                # runs on per-batch sizes, so equal-target batches could
                # disagree and crash np.stack) — re-evaluate build_batch's
                # eligibility rule at the target sizes, then rebuild or drop
                from ..frontend.ir import SLOT_PAD_CAP

                slot_count = max_len_t[name] * node_pad_t[a.dst]
                if slot_param_adjs[name] or slot_count <= SLOT_PAD_CAP * ne:
                    params = out[f"params_{name}"]
                    emask = out[f"edge_mask_{name}"]
                    real = emask > 0
                    ps = np.zeros(
                        (max_len_t[name], node_pad_t[a.dst])
                        + params.shape[1:],
                        params.dtype,
                    )
                    ps[out[f"seq_{name}"][real], out[f"dst_{name}"][real]] = (
                        params[real]
                    )
                    out[f"params_slice_{name}"] = ps
                else:
                    out.pop(f"params_slice_{name}", None)

    # additional readout inputs: entity-shaped extras grow with their
    # entity's node padding (same trailing-zeros convention as features);
    # flat extras grow to the target's recorded extra_pad (left
    # unpadded they crash np.stack on differing batches)
    extra_pad_t = dict(getattr(target, "extra_pad", ()))
    for name, ent in getattr(target, "extra_layout", ()):
        if name not in out:
            continue
        if ent:
            out[name] = pad_rows(out[name], node_pad_t[ent])
        elif name in extra_pad_t:
            out[name] = pad_rows(out[name], extra_pad_t[name])

    if out.get("label") is not None and "label" in out:
        out["label"] = pad_rows(out["label"], target.label_pad)
        out["label_mask"] = pad_rows(out["label_mask"], target.label_pad)
    if "label_perm" in out:
        ne = target.edges(infer_label_domain(model_ir)[1])
        if ne > len(out["label_perm"]):
            # padding slots map to themselves (real edges stay a prefix)
            out["label_perm"] = np.concatenate(
                [
                    out["label_perm"],
                    np.arange(len(out["label_perm"]), ne, dtype=np.int32),
                ]
            )

    # interleave permutations: remap input slots between block layouts
    ml_c, ml_t = dict(meta.max_len), dict(target.max_len)
    for _si, _stage, _mi, mp in _interleave_passes(model_ir):
        dst = mp.destination
        tag = interleave_tag(dst, _si, _mi)
        key = f"interleave_perm_{tag}"
        if key not in out:
            continue
        adjs = [s.adj_name for s in mp.sources]
        offs_c = np.cumsum([0] + [ml_c[a] for a in adjs])[:-1]
        offs_t = np.cumsum([0] + [ml_t[a] for a in adjs])[:-1]
        t_old = int(sum(ml_c[a] for a in adjs))
        t_new = int(sum(ml_t[a] for a in adjs))
        if t_old == t_new and all(ml_c[a] == ml_t[a] for a in adjs):
            continue
        old = out[key]
        new = np.zeros((old.shape[0], t_new), np.int32)
        # slot remap depends only on the block offsets, not the graph —
        # build it once as a lookup vector (was rebuilt per graph)
        remap = np.zeros(t_old, np.int32)
        for bi, a in enumerate(adjs):
            remap[offs_c[bi] : offs_c[bi] + ml_c[a]] = offs_t[bi] + np.arange(
                ml_c[a], dtype=np.int32
            )
        for g in range(old.shape[0]):
            p = np.full(t_new, -1, np.int32)
            p[:t_old] = remap[old[g]]
            used = set(int(v) for v in p[p >= 0])
            free = [i for i in range(t_new) if i not in used]
            p[p < 0] = np.asarray(free, np.int32)
            new[g] = p
        out[key] = new

    # fast-interleave companions depend on node padding AND block layout:
    # rebuild them from the repadded slice_src maps + remapped permutation
    for _si, _stage, _mi, mp in _interleave_passes(model_ir):
        tag = interleave_tag(mp.destination, _si, _mi)
        if f"ilv_slice_{tag}" not in out:
            continue
        for key, value in interleave_slice_companions(
            mp, out[f"interleave_perm_{tag}"], out, node_pad_t, ml_t
        ).items():
            out[f"{key}_{tag}"] = value

    return out
