"""Locality-aware node renumbering for destination-sharded (v2) execution
(a copy of `ignnition_tpu/parallel/locality.py`, numpy over the port's own
`GraphSample`: its orders equal the JAX package's bit for bit).

The destination-sharded partitioner (`edgeshard.partition_batch`) cuts each
entity's padded rows into contiguous blocks, and the halo exchanged per
iteration is exactly the set of source rows referenced across a block
boundary. That cut depends entirely on the ROW ORDER the dataset happened to
ship: a graph with real community structure but scrambled ids partitions as
badly as a random one. This module recovers latent locality host-side, as a
pure renumbering applied BEFORE `build_batch`/`partition_batch` — the model
is permutation-equivariant, so results are identical up to row order
(tests/test_torch_locality.py holds the copy to the JAX module).

Pipeline (all numpy, O(E) per pass):

  1. **multi-source BFS** over the union bipartite incidence seeds a 1-D
     layout (Cuthill-McKee-style: connected regions land contiguously —
     gives the barycenter sweeps a non-degenerate start even when the input
     numbering carries zero signal);
  2. **weighted-barycenter sweeps** refine it: every node moves to the mean
     coordinate of its neighbors, then coordinates are re-ranked globally —
     the classic bandwidth-reduction heuristic (minimizing Σ|pos_u - pos_v|
     over edges minimizes window-crossing incidences under contiguous-block
     partitioning);
  3. **balanced pairwise-swap refinement** (when the shard count is known):
     only block MEMBERSHIP matters for the cut, so nodes are swapped between
     blocks in equal numbers whenever the paired move reduces boundary
     edges — the lever that still works on expander-like (truly random)
     incidence where no 1-D layout exists.

No reference counterpart (the reference framework is single-process;
SURVEY §2.4 mandates the parallel tier from the blueprint side).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["locality_order", "reorder_sample", "boundary_edge_count"]


def _entity_offsets(sample, entities: List[str]) -> Tuple[Dict[str, int], int]:
    offs, total = {}, 0
    for ent in entities:
        offs[ent] = total
        total += int(sample.num_nodes.get(ent, 0))
    return offs, total


def _union_edges(sample, model_ir, offs) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected union incidence as (u, v) global-id endpoint arrays (each
    edge contributes both directions). Reverse adjacencies (link->path AND
    path->link) both appear; duplicate pairs just double the weight, which
    is harmless for every pass below."""
    us, vs = [], []
    for a in model_ir.adjacency_info():
        arrs = sample.adjacencies.get(a.name)
        if arrs is None or len(arrs.src_idx) == 0:
            continue
        u = arrs.src_idx.astype(np.int64) + offs[a.src]
        v = arrs.dst_idx.astype(np.int64) + offs[a.dst]
        us.extend((u, v))
        vs.extend((v, u))
    if not us:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(us), np.concatenate(vs)


def _csr(u: np.ndarray, v: np.ndarray, n: int):
    order = np.argsort(u, kind="stable")
    indices = v[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=n), out=indptr[1:])
    return indptr, indices


def _neighbors_of(indptr, indices, nodes: np.ndarray) -> np.ndarray:
    counts = indptr[nodes + 1] - indptr[nodes]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    rep_start = np.repeat(indptr[nodes], counts)
    cum = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], counts)
    return indices[rep_start + within]


def _bfs_positions(indptr, indices, n: int) -> np.ndarray:
    """Level-synchronous multi-component BFS order; new components seed from
    the lowest-degree unvisited node (reverse-Cuthill-McKee flavour)."""
    deg = (indptr[1:] - indptr[:-1]).copy()
    visited = np.zeros(n, bool)
    pos = np.empty(n, np.int64)
    counter = 0
    # seeds come in ascending-degree order; a pointer over the pre-sorted
    # list replaces a full argmin per component (review-found: quadratic
    # on graphs with many isolated nodes). Stable sort == argmin tie rule.
    seed_order = np.argsort(deg, kind="stable")
    seed_ptr = 0
    while counter < n:
        while visited[seed_order[seed_ptr]]:
            seed_ptr += 1
        seed = int(seed_order[seed_ptr])
        frontier = np.asarray([seed], np.int64)
        visited[seed] = True
        while frontier.size:
            pos[frontier] = counter + np.arange(frontier.size)
            counter += frontier.size
            nb = _neighbors_of(indptr, indices, frontier)
            nb = nb[~visited[nb]]
            if nb.size:
                nb = np.unique(nb)
                visited[nb] = True
            frontier = nb
    return pos


def _barycenter(coord, u, v, n, rounds: int) -> np.ndarray:
    deg = np.bincount(u, minlength=n).astype(np.float64)
    for _ in range(rounds):
        s = np.bincount(u, weights=coord[v], minlength=n)
        new = np.where(deg > 0, s / np.maximum(deg, 1.0), coord)
        order = np.argsort(new, kind="stable")
        coord = np.empty(n, np.float64)
        coord[order] = np.arange(n, dtype=np.float64)
    return coord


def _refine_blocks(
    blk: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    ent_id: np.ndarray,
    n_entities: int,
    n_model: int,
    passes: int,
) -> np.ndarray:
    """Balanced pairwise-swap refinement of block membership.

    For every ordered block pair (b1, b2) and one entity at a time, nodes of
    b1 whose edges mostly lead to b2 swap with nodes of b2 leaning toward
    b1, largest combined gain first, while the paired gain stays positive —
    per-block sizes never change, so the contiguous-split capacities hold."""
    n = blk.shape[0]
    for _ in range(passes):
        moved = 0
        for ent in range(n_entities):
            # counts[node, b] = edges incident to `node` whose OTHER endpoint
            # currently lives in block b
            counts = np.bincount(
                u * n_model + blk[v], minlength=n * n_model
            ).reshape(n, n_model)
            is_ent = ent_id == ent
            cur = counts[np.arange(n), blk]
            for b1 in range(n_model):
                for b2 in range(b1 + 1, n_model):
                    cand1 = np.nonzero(is_ent & (blk == b1)
                                       & (counts[:, b2] > cur))[0]
                    cand2 = np.nonzero(is_ent & (blk == b2)
                                       & (counts[:, b1] > cur))[0]
                    if cand1.size == 0 or cand2.size == 0:
                        continue
                    g1 = counts[cand1, b2] - cur[cand1]
                    g2 = counts[cand2, b1] - cur[cand2]
                    o1 = cand1[np.argsort(-g1, kind="stable")]
                    o2 = cand2[np.argsort(-g2, kind="stable")]
                    # every candidate's own gain is >= 1 (strict filter
                    # above), so every swapped pair has positive combined
                    # gain — swap all size-balanced pairs
                    keep = min(o1.size, o2.size)
                    blk[o1[:keep]] = b2
                    blk[o2[:keep]] = b1
                    cur[o1[:keep]] = counts[o1[:keep], b2]
                    cur[o2[:keep]] = counts[o2[:keep], b1]
                    moved += 2 * keep
        if moved == 0:
            break
    return blk


def boundary_edge_count(
    sample,
    model_ir,
    orders,
    n_model: int,
    node_pad: Optional[Dict[str, int]] = None,
) -> Dict[str, float]:
    """Per-adjacency fraction of edges crossing a contiguous-block boundary
    under the given per-entity orderings — the host-side preview of
    `edgeshard.halo_fractions` (real rows only; pass `node_pad` to use the
    same padded ceil block split partition_batch will)."""
    inv = {
        ent: np.argsort(o, kind="stable").astype(np.int64)
        for ent, o in orders.items()
    }

    def _b(ent):
        # same max(real, padded) floor as _membership: a stale node_pad
        # below the real count must not produce out-of-range block ids
        rows = max(
            int(sample.num_nodes[ent]), (node_pad or {}).get(ent, 0)
        )
        return -(-rows // n_model)

    out = {}
    for a in model_ir.adjacency_info():
        arrs = sample.adjacencies.get(a.name)
        if arrs is None or len(arrs.src_idx) == 0:
            out[a.name] = 0.0
            continue
        sb = inv[a.src][arrs.src_idx.astype(np.int64)] // _b(a.src)
        db = inv[a.dst][arrs.dst_idx.astype(np.int64)] // _b(a.dst)
        out[a.name] = float(np.mean(sb != db))
    return out


def locality_order(
    sample,
    model_ir,
    n_model: Optional[int] = None,
    rounds: int = 12,
    refine_passes: int = 4,
    node_pad: Optional[Dict[str, int]] = None,
) -> Dict[str, np.ndarray]:
    """Per-entity node orderings that minimize the contiguous-block edge cut.

    Returns ``{entity: order}`` with ``order[new_row] = old_row`` (feed to
    `reorder_sample`). When `n_model` is given, block membership is
    additionally refined for that exact shard count (the strongest setting —
    refinement is what still bites on expander-like incidence). `node_pad`
    pins each entity's PADDED row count so refinement splits blocks exactly
    where partition_batch will (ceil(n_pad / n_model)); without it the real
    row count is used."""
    entities = [e.name for e in model_ir.entities]
    offs, n = _entity_offsets(sample, entities)
    if n == 0:
        return {ent: np.empty(0, np.int64) for ent in entities}
    u, v = _union_edges(sample, model_ir, offs)
    ent_sizes = {ent: int(sample.num_nodes.get(ent, 0)) for ent in entities}
    if u.size == 0:
        return {
            ent: np.arange(ent_sizes[ent], dtype=np.int64) for ent in entities
        }
    indptr, indices = _csr(u, v, n)
    coord = _bfs_positions(indptr, indices, n).astype(np.float64)
    coord = _barycenter(coord, u, v, n, rounds)

    ent_id = np.empty(n, np.int64)
    for i, ent in enumerate(entities):
        ent_id[offs[ent] : offs[ent] + ent_sizes[ent]] = i

    if n_model is not None and n_model >= 2:
        # Three candidate layouts — BFS+barycenter refined, the input order
        # refined, and the input order UNREFINED — keep whichever cuts
        # fewer edges. The unrefined-identity candidate makes never-worse
        # unconditional: refinement's paired-swap gains are evaluated on
        # per-pass counts (stale after moves) and double-count a shared
        # edge between two swapped same-entity neighbors, so on
        # non-bipartite adjacencies a refined layout CAN exceed the input
        # cut (bipartite graphs measured safe across a 360-config sweep).
        identity = np.arange(n, dtype=np.float64)
        best = None
        for base, passes in (
            (coord, refine_passes),
            (identity, refine_passes),
            (identity, 0),
        ):
            blk = _membership(
                base, entities, offs, ent_sizes, n_model, node_pad
            )
            if passes:
                blk = _refine_blocks(
                    blk, u, v, ent_id, len(entities), n_model, passes
                )
            cut = int(np.count_nonzero(blk[u] != blk[v]))
            if best is None or cut < best[0]:
                best = (cut, blk, base)
        _, blk, base = best
        # sorting by (block, coordinate) makes contiguous ceil-blocks
        # reproduce the refined membership exactly
        sort_key = blk.astype(np.float64) * (n + 1) + _rerank(base)
    else:
        sort_key = coord

    orders = {}
    for ent in entities:
        lo, sz = offs[ent], ent_sizes[ent]
        orders[ent] = np.argsort(sort_key[lo : lo + sz], kind="stable").astype(
            np.int64
        )
    return orders


def _membership(coord, entities, offs, ent_sizes, n_model, node_pad):
    """Contiguous ceil-split of each entity's coordinate ranking into block
    ids (block size matches partition_batch's padded split when node_pad is
    given)."""
    n = coord.shape[0]
    blk = np.zeros(n, np.int64)
    for ent in entities:
        lo, sz = offs[ent], ent_sizes[ent]
        if sz == 0:
            continue
        rank = np.empty(sz, np.int64)
        rank[np.argsort(coord[lo : lo + sz], kind="stable")] = np.arange(sz)
        rows = (node_pad or {}).get(ent, sz)
        b = -(-max(rows, sz) // n_model)
        blk[lo : lo + sz] = rank // b
    return blk


def _rerank(coord: np.ndarray) -> np.ndarray:
    """Coordinates -> dense [0, 1) ranks (keeps the block key dominant)."""
    out = np.empty(coord.shape[0], np.float64)
    out[np.argsort(coord, kind="stable")] = np.arange(coord.shape[0])
    return out / max(coord.shape[0], 1)


_warned_ambiguous = set()


def _log_ambiguous_extra_once(name, matches):
    if name not in _warned_ambiguous:
        _warned_ambiguous.add(name)
        import logging

        logging.getLogger("ignnition_tpu_torch").warning(
            "additional input '%s' matches the node counts of several "
            "entities (%s) in a sample — locality renumbering skipped for "
            "such samples (correctness over locality)",
            name, ", ".join(matches),
        )


def reorder_sample(sample, model_ir, orders=None, n_model=None):
    """Renumber a GraphSample's nodes by per-entity `orders` (computed here
    via `locality_order` when not given). Returns ``(new_sample, orders)``.

    Every node-indexed field moves together — features, adjacency endpoints,
    entity-domain labels, entity-shaped additional readout inputs — so the
    renumbered sample is the SAME graph: predictions come back permuted by
    `orders[label_entity]`, losses/metrics are unchanged (mask-weighted
    means are permutation-invariant), and edge-domain labels keep their
    per-edge insertion alignment (edges are not reordered — `build_batch`
    re-sorts by destination itself). Interleave slot vectors are per-graph
    time-axis patterns, not node-indexed, and pass through untouched."""
    from ..data.dataset import AdjacencyArrays, GraphSample
    from ..data.graph import infer_label_domain

    if orders is None:
        orders = locality_order(sample, model_ir, n_model=n_model)

    # additional readout inputs follow their entity's rows by COUNT match
    # (build_batch meta.extra_layout). If a sample's extra matches the
    # counts of SEVERAL entities, this per-sample view cannot know which
    # one build_batch will resolve for the whole batch (review-found:
    # guessing 'first declared' here could permute the rows by the wrong
    # entity's order) — leave such samples unreordered; a skipped
    # renumbering only costs locality, never correctness.
    for name, vals in sample.extras.items():
        rows = np.asarray(vals).shape[0]
        matches = [
            ent for ent in orders if rows == sample.num_nodes.get(ent, -1)
        ]
        if len(matches) > 1:
            _log_ambiguous_extra_once(name, matches)
            identity = {
                ent: np.arange(len(o), dtype=np.int64)
                for ent, o in orders.items()
            }
            return sample, identity

    inv = {
        ent: np.argsort(o, kind="stable").astype(np.int64)
        for ent, o in orders.items()
    }

    feature_entities = {}
    for e in model_ir.entities:
        for f in e.features:
            feature_entities[f.name] = e.name

    features = {}
    for name, vals in sample.features.items():
        ent = feature_entities.get(name)
        features[name] = vals[orders[ent]] if ent in orders else vals

    adjacencies = {}
    for a in model_ir.adjacency_info():
        arrs = sample.adjacencies[a.name]
        adjacencies[a.name] = AdjacencyArrays(
            src_idx=inv[a.src][arrs.src_idx.astype(np.int64)].astype(
                arrs.src_idx.dtype
            ),
            dst_idx=inv[a.dst][arrs.dst_idx.astype(np.int64)].astype(
                arrs.dst_idx.dtype
            ),
            seq=arrs.seq,
            params=arrs.params,
        )

    label = sample.label
    dom = infer_label_domain(model_ir)
    if label is not None and dom[0] == "entity":
        label = np.asarray(label)[orders[dom[1]]]

    extras = {}
    for name, vals in sample.extras.items():
        vals = np.asarray(vals)
        # entity-shaped extras follow their entity's rows — the ambiguity
        # guard above ensures at most one entity matches this count
        matches = [
            ent
            for ent in orders
            if vals.shape[0] == sample.num_nodes.get(ent, -1)
        ]
        extras[name] = vals[orders[matches[0]]] if matches else vals

    return (
        GraphSample(
            num_nodes=dict(sample.num_nodes),
            features=features,
            adjacencies=adjacencies,
            interleave=dict(sample.interleave),
            label=label,
            extras=extras,
        ),
        orders,
    )
