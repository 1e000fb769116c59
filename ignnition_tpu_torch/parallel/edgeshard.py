"""Destination sharding (v2): destination-sharded node state with a
boundary halo exchange (counterpart of `ignnition_tpu/parallel/edgeshard.py`;
`partition_dims`, `partition_batch`, `halo_fractions` and
`comm_bytes_per_step` are a copy, numpy over the port's own data layer, so
their arrays equal the JAX package's key for key).

v1 (`parallel/steps.py`, `edge_axis`) replicates every node table and
all-reduces a full [n_dst, D] partial per adjacency per iteration: its
communication grows with the destination count and node memory does not
shrink with the model axis. v2 shards:

  * **node state**: each entity's padded rows split into contiguous blocks
    of B = ceil(node_pad / n_model) rows; rank m of the model axis owns
    rows [m*B, (m+1)*B). Hidden states, feature init, the updates and the
    readout run on the local block: compute and memory scale with the axis;
  * **edges**: each adjacency's destination-sorted edges go to the rank
    owning their destination, so every aggregation is local (the
    per-destination segment structure never crosses ranks);
  * **boundary exchange**: the only rows that cross are the source rows a
    rank's edges read from other owners (the edge-cut halo). Each rank
    gathers the rows each peer needs (`halo_send_*`, host-built) and one
    `all_to_all` per gather trades them (`ops/segment.halo_extend`); the
    local table is then concat(own block, halo) and the edges read remapped
    indices. Per rank, adjacency and iteration it moves n_model * H * D
    values, H the largest boundary between two ranks: proportional to the
    cut, not to n_dst.

Label domains: entity labels shard with their entity's blocks; edge-domain
labels (readouts through `extend_adjacencies`) with their adjacency's
destination-owned edges, the readout's final-state gather going through one
more halo, and `edge_origin_*` maps local predictions back to the merged
batch's edge order on the host. Entity-shaped additional readout inputs
shard by their recorded block layout (`meta.extra_layout`).

The steps (`make_edgeshard_train_step`, `make_edgeshard_apply`) run on the
mesh of `parallel/mesh.py`: each rank takes its [data, model] cell of the
stacked [n_data, n_model, ...] arrays and applies the model with
`node_axis` = its data row's model group. Gradients follow v1's scheme
unchanged (`parallel/steps.py`): every rank's objective is scaled by
1/(n_data * n_model), every all-reduce inside the model (`psum`) sums its
cotangent in the backward, and one all-reduce over the mesh sums every
parameter gradient. The halo's exchange is linear and its backward is its
transpose (`ops/_collectives.all_to_all`), so the sum stays exact. Both
steps are `ShardedStep`s, compiled as `parallel/steps.py` says: on an
NCCL mesh the graph also holds the halo's `all_to_all_start` /
`all_to_all_wait`; the edge-domain forward's reassembly through
`edge_origin_*` runs on the host after it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..batch import resolve_device, to_device
from ..data.graph import BatchMeta, adjacency_aux_arrays, infer_label_domain
from ..model.builder import GnnModel
from ..ops._collectives import all_gather, psum
from ..training.capture import Graphs
from ..training.losses import loss_reduction
from .mesh import Mesh
from .steps import ShardedStep, _check_agreement, _reduce_and_update, _shape_key

_HALO_MULTIPLE = 8  # round the halo height to keep shapes stable


class EdgeShardError(ValueError):
    pass


# --------------------------------------------------------------------------
# host-side partitioner
# --------------------------------------------------------------------------


def partition_dims(stacked: Dict[str, np.ndarray]) -> Dict[str, Dict[str, int]]:
    """Shape-defining dims of a partitioned batch ({'halo': {adj: H},
    'edges': {adj: E_loc}}) — feed back as partition_batch(pad_to=...) so a
    stream of batches keeps ONE static shape."""
    halo = {
        k[len("halo_send_"):]: int(v.shape[-1])
        for k, v in stacked.items()
        if k.startswith("halo_send_")
    }
    edges = {
        k[len("src_"):]: int(v.shape[-1])
        for k, v in stacked.items()
        if k.startswith("src_")
    }
    return {"halo": halo, "edges": edges}


def partition_batch(
    arrays: Dict[str, np.ndarray],
    meta: BatchMeta,
    model_ir,
    n_model: int,
    pad_to: Optional[Dict[str, Dict[str, int]]] = None,
) -> Tuple[Dict[str, np.ndarray], BatchMeta]:
    """Split one merged batch into n_model destination-sharded local batches.

    Returns (stacked arrays with leading [n_model] shard axis, local meta).
    Every local batch is a self-contained GraphBatch over the shard's node
    blocks: local row_ptr/lens companions are recomputed so the single-device
    fast paths (sorted-COO segment sums, masked_update_from_edges) apply
    unchanged; source indices are remapped into the halo-extended table
    layout [0, B_src + n_model*H).
    """
    if n_model < 2:
        raise EdgeShardError("edge partitioning needs n_model >= 2")
    return _partition(arrays, meta, model_ir, n_model, pad_to)


def _partition(arrays, meta, model_ir, n_model: int, pad_to=None):
    """`partition_batch` for any n_model >= 1: one shard is the merged batch
    in the local layout (no halo), what a 1 x 1 mesh steps on."""
    label_dom = infer_label_domain(model_ir)

    entities = model_ir.entities
    adj_info = model_ir.adjacency_info()

    # ---- node blocks ----
    block: Dict[str, int] = {}
    for e in entities:
        n_pad = meta.nodes(e.name)
        block[e.name] = -(-n_pad // n_model)  # ceil

    local: List[Dict[str, np.ndarray]] = [dict() for _ in range(n_model)]

    def slice_rows(a: np.ndarray, ent: str, fill=0) -> List[np.ndarray]:
        """Global node-row array -> per-shard blocks (zero-fill the tail)."""
        b = block[ent]
        out = []
        for k in range(n_model):
            lo, hi = k * b, min((k + 1) * b, a.shape[0])
            part = a[lo:hi]
            if part.shape[0] < b:
                pad = np.full((b - part.shape[0],) + a.shape[1:], fill, a.dtype)
                part = np.concatenate([part, pad], 0)
            out.append(part)
        return out

    for e in entities:
        for key, fill in (
            (f"node_mask_{e.name}", 0),
            (f"graph_id_{e.name}", max(meta.num_graphs - 1, 0)),
        ):
            for k, part in enumerate(slice_rows(arrays[key], e.name, fill)):
                local[k][key] = part
        for f in e.features:
            for k, part in enumerate(slice_rows(arrays[f.name], e.name)):
                local[k][f.name] = part

    # ---- labels (edge-domain labels shard with their adjacency below) ----
    label_pad = 0
    if "label" in arrays:
        if label_dom[0] == "entity":
            ent = label_dom[1]
            for key in ("label", "label_mask"):
                for k, part in enumerate(slice_rows(arrays[key], ent)):
                    local[k][key] = part
            label_pad = block[ent]
        elif label_dom[0] == "graph":  # replicated
            for k in range(n_model):
                local[k]["label"] = arrays["label"]
                local[k]["label_mask"] = arrays["label_mask"]
            label_pad = meta.label_pad

    # ---- additional readout inputs: entity-shaped rows follow their
    # entity's block layout (build_batch recorded the match in
    # meta.extra_layout); flat non-entity inputs have no shardable domain ----
    extra_layout = dict(meta.extra_layout)
    for name in model_ir.additional_inputs():
        ent = extra_layout.get(name, "")
        if not ent:
            raise EdgeShardError(
                f"additional readout input '{name}' is not entity-shaped "
                "(its rows match no entity's node counts) and cannot be "
                "destination-sharded; use the replicated edge_axis strategy"
            )
        for k, part in enumerate(slice_rows(arrays[name], ent)):
            local[k][name] = part

    # ---- adjacencies ----
    edge_pad: Dict[str, int] = {}
    for a in adj_info:
        src = arrays[f"src_{a.name}"]
        dst = arrays[f"dst_{a.name}"]
        seq = arrays[f"seq_{a.name}"]
        emask = arrays[f"edge_mask_{a.name}"]
        params = arrays.get(f"params_{a.name}")
        b_src, b_dst = block[a.src], block[a.dst]

        real = emask > 0
        owner = dst // b_dst  # destination-sorted => owner blocks contiguous
        per_shard_idx = [np.nonzero(real & (owner == k))[0] for k in range(n_model)]

        # halo need-sets: rows of remote owners referenced by each shard
        need: List[List[np.ndarray]] = [[None] * n_model for _ in range(n_model)]
        h = 0
        for k in range(n_model):
            s_k = src[per_shard_idx[k]]
            s_owner = s_k // b_src
            for j in range(n_model):
                if j == k:
                    continue
                rows = np.unique(s_k[s_owner == j])
                need[k][j] = rows
                h = max(h, rows.size)
        if h > 0:
            h = -(-h // _HALO_MULTIPLE) * _HALO_MULTIPLE
        if pad_to is not None:
            h = max(h, int(pad_to.get("halo", {}).get(a.name, 0)))
        use_halo = h > 0
        ext = b_src + (n_model * h if use_halo else 0)

        e_loc = max(idx.size for idx in per_shard_idx)
        e_loc = max(int(np.asarray(meta.edges(a.name)) // n_model), e_loc, 1)
        if pad_to is not None:
            e_loc = max(e_loc, int(pad_to.get("edges", {}).get(a.name, 0)))
        edge_pad[a.name] = e_loc

        for k in range(n_model):
            idx = per_shard_idx[k]
            n = idx.size
            l_src = np.full(e_loc, ext - 1, np.int32)
            l_dst = np.full(e_loc, b_dst - 1, np.int32)
            l_seq = np.zeros(e_loc, np.int32)
            l_mask = np.zeros(e_loc, np.float32)
            l_par = (
                np.zeros((e_loc,) + params.shape[1:], params.dtype)
                if params is not None
                else None
            )
            # remap sources into the extended-table layout
            s_k = src[idx]
            s_owner = s_k // b_src
            rem = s_k - s_owner * b_src
            mapped = rem.copy()
            for j in range(n_model):
                if j == k or need[k][j] is None or need[k][j].size == 0:
                    continue
                sel = s_owner == j
                pos = np.searchsorted(need[k][j], s_k[sel])
                mapped[sel] = b_src + j * h + pos
            l_src[:n] = mapped
            l_dst[:n] = dst[idx] - k * b_dst
            l_seq[:n] = seq[idx]
            l_mask[:n] = 1.0
            if l_par is not None:
                l_par[:n] = params[idx]

            if use_halo:
                # interior/boundary split for comm/compute overlap: interior
                # edges (source rows owned locally) aggregate from the local
                # block while the halo all_to_all is in flight; boundary
                # edges read the received halo rows (builder._halo_gather)
                l_int = np.zeros(e_loc, np.float32)
                l_bnd = np.zeros(e_loc, np.float32)
                l_int[:n] = (s_owner == k).astype(np.float32)
                l_bnd[:n] = (s_owner != k).astype(np.float32)
                local[k][f"interior_emask_{a.name}"] = l_int
                local[k][f"boundary_emask_{a.name}"] = l_bnd

            # edge-domain labels shard with their adjacency's edges: label
            # row i of the merged batch is aligned with (destination-sorted)
            # edge i, so the shard's edge selection IS its label selection.
            # edge_origin_{adj} records each local edge's merged index (-1
            # padding) for host-side reassembly of sharded predictions.
            if label_dom == ("edge", a.name):
                if "label" in arrays:
                    # keep trailing feature dims (multi-unit edge labels),
                    # mirroring the entity-domain slice path
                    l_lab = np.zeros(
                        (e_loc,) + arrays["label"].shape[1:], np.float32
                    )
                    l_lm = np.zeros(
                        (e_loc,) + arrays["label_mask"].shape[1:], np.float32
                    )
                    l_lab[:n] = arrays["label"][idx]
                    l_lm[:n] = arrays["label_mask"][idx]
                    local[k]["label"] = l_lab
                    local[k]["label_mask"] = l_lm
                origin = np.full(e_loc, -1, np.int32)
                origin[:n] = idx
                local[k][f"edge_origin_{a.name}"] = origin
                label_pad = e_loc
            local[k][f"src_{a.name}"] = l_src
            local[k][f"dst_{a.name}"] = l_dst
            local[k][f"seq_{a.name}"] = l_seq
            local[k][f"edge_mask_{a.name}"] = l_mask
            if l_par is not None:
                local[k][f"params_{a.name}"] = l_par

            # local CSR companions: ONLY the index-free ones (row_ptr/lens)
            # — the slice/dense/source-sorted fast paths would gather from
            # halo rows whose empty-slot sentinel is not a zero row, so the
            # builder's generic sorted paths are used under v2
            aux = adjacency_aux_arrays(
                l_src, l_dst, l_mask, ext, b_dst, meta.maxlen(a.name)
            )
            local[k][f"row_ptr_{a.name}"] = aux["row_ptr"]
            local[k][f"lens_{a.name}"] = aux["lens"]

            if use_halo:
                send = np.zeros((n_model, h), np.int32)
                for dest in range(n_model):
                    rows = need[dest][k] if dest != k else None
                    if rows is not None and rows.size:
                        send[dest, : rows.size] = rows - k * b_src
                local[k][f"halo_send_{a.name}"] = send

        # interleave companions are global/per-graph: pass through replicated
    for key in arrays:
        if key.startswith("interleave_perm_"):
            for k in range(n_model):
                local[k][key] = arrays[key]

    stacked = {
        key: np.stack([local[k][key] for k in range(n_model)], 0)
        for key in local[0]
    }
    local_meta = BatchMeta(
        num_graphs=meta.num_graphs,
        node_pad=tuple((e.name, block[e.name]) for e in entities),
        edge_pad=tuple(sorted(edge_pad.items())),
        max_len=meta.max_len,
        interleave_len=meta.interleave_len,
        label_pad=label_pad,
        extra_layout=meta.extra_layout,
        extra_pad=meta.extra_pad,
    )
    return stacked, local_meta


# --------------------------------------------------------------------------
# sharded steps
# --------------------------------------------------------------------------


def _host_only(key: str) -> bool:
    """Arrays of the host's reassembly, which no rank's model reads."""
    return key.startswith("edge_origin_")


def _local_cell(stacked: Dict[str, np.ndarray], mesh: Mesh, device) -> Dict[str, torch.Tensor]:
    """This rank's [data, model] cell of a stacked [n_data, n_model, ...]
    partitioned batch, on `device`."""
    d, m = mesh.require_member()
    want = (mesh.shape["data"], mesh.shape["model"])
    out = {}
    for k, v in stacked.items():
        if _host_only(k):
            continue
        if tuple(np.shape(v)[:2]) != want:
            raise EdgeShardError(
                f"partitioned batch array '{k}' leads with {tuple(np.shape(v)[:2])}; the "
                f"mesh is {want[0]} data x {want[1]} model (stack partition_batch's "
                "outputs on a leading data axis)"
            )
        out[k] = v[d, m]
    return to_device(out, device)


def _checked(stacked, local_meta: BatchMeta, mesh: Mesh, checked: set) -> tuple:
    """Before the first step of a shape: raise on every rank unless the
    mesh's ranks agree on the meta and the partition's shapes (a rank that
    differs would issue other collectives and hang the mesh). Returns the
    shape key."""
    key = _shape_key({k: v for k, v in stacked.items() if not _host_only(k)})
    if key not in checked:
        _check_agreement((key, repr(local_meta)), mesh)
        checked.add(key)
    return key


def make_edgeshard_train_step(
    model: GnnModel,
    optimizer,
    loss_fn: Callable,
    local_meta: BatchMeta,
    mesh: Mesh,
    data_axis: str = "data",
    model_axis: str = "model",
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    graphs: Optional[Graphs] = None,
) -> ShardedStep:
    """`train_step(params, opt_state, stacked_batch, generator=None) ->
    (params, opt_state, loss)` over destination-sharded batches.

    `stacked_batch` holds the `partition_batch` outputs of mesh.shape['data']
    merged batches stacked on a leading data axis ([n_data, n_model, ...];
    one data row: [1, n_model, ...]), the same on every rank; each rank
    copies its cell to `device` (by default the current CUDA device).
    `params` and `opt_state` are each rank's replica and are updated in
    place. The loss combines over the model axis as in the JAX step: entity
    and edge labels as the mask-weighted mean of the ranks' masked means
    (`psum(loss * cnt) / psum(cnt)`), sum-reduction losses as the plain
    sum, graph labels as they are (every rank computed the same pooled
    loss). The returned loss is the mean over the data rows (the sum for
    sum-reduction losses), the same on every rank; the L2 term is not in
    it. `generator` feeds the readout's random layers: each rank passes its
    own, seeded alike, so that the replicas draw one mask (the JAX step's
    one replicated key). compute_dtype: as `GnnModel.apply`'s. graphs: as
    `parallel.make_parallel_train_step`'s; one CUDA graph per partition
    shape on an NCCL mesh."""
    device = resolve_device(device)
    n_data = mesh.shape[data_axis]
    n_model = mesh.shape[model_axis]
    label_dom = infer_label_domain(model.ir)
    reduction = loss_reduction(loss_fn)
    checked: set = set()

    def update(generator, bound, batch) -> Dict[str, torch.Tensor]:
        params, opt_state = bound
        group = mesh.model_group
        preds = model.apply(params, batch, local_meta, compute_dtype=compute_dtype,
                            training=True, generator=generator, node_axis=group)
        if getattr(loss_fn, "takes_groups", False):
            # hinge-family: the all-binary label test spans the effective batch
            loss = loss_fn(batch["label"], preds, batch["label_mask"],
                           groups=(mesh.data_group, group))
        else:
            loss = loss_fn(batch["label"], preds, batch["label_mask"])
        if label_dom[0] in ("entity", "edge"):
            if reduction == "sum":
                loss = psum(loss, group)
            else:
                cnt = torch.sum(batch["label_mask"])
                loss = psum(loss * cnt, group) / torch.clamp_min(psum(cnt, group), 1.0)
        return _reduce_and_update(model, optimizer, params, opt_state, loss, reduction,
                                  n_data, n_model, mesh)

    def train_step(params, opt_state, stacked_batch, generator=None):
        key = _checked(stacked_batch, local_meta, mesh, checked)
        batch = _local_cell(stacked_batch, mesh, device)
        out = sharded.run(("edgeshard_train", local_meta, key, generator), update,
                          (params, opt_state), batch, generator)
        return params, opt_state, out["loss"]

    sharded = ShardedStep("the destination-sharded training step", mesh, device, graphs,
                          train_step)
    return sharded


def make_edgeshard_apply(
    model: GnnModel,
    local_meta: BatchMeta,
    mesh: Mesh,
    data_axis: str = "data",
    model_axis: str = "model",
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    graphs: Optional[Graphs] = None,
) -> ShardedStep:
    """Sharded forward: `apply_fn(params, stacked_batch)` -> the stacked
    predictions, float32, on every rank of the mesh.

    Node-domain predictions are all-gathered over the model axis: the
    blocks are contiguous row ranges, so [n_data, n_model * B, ...] is the
    global padded row order (possibly longer than the merged batch's pad).
    Graph-domain predictions keep one copy: [n_data, num_graphs, ...].
    Edge-domain predictions are all-gathered, then scattered through
    `edge_origin_*` back into the merged batch's edge order: [n_data,
    n_real_edges, ...], the real-edge prefix (padding edges have no origin
    row). Every rank holds the stacked batch, so every rank returns the
    whole result. graphs: as `make_edgeshard_train_step`'s."""
    device = resolve_device(device)
    label_dom = infer_label_domain(model.ir)
    checked: set = set()

    def forward(generator, params, batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            preds = model.apply(params, batch, local_meta, compute_dtype=compute_dtype,
                                node_axis=mesh.model_group)
            if label_dom[0] != "graph":
                preds = all_gather(preds, mesh.model_group, dim=0)
            return {"preds": all_gather(preds[None], mesh.data_group, dim=0)}

    def apply_fn(params, stacked_batch):
        key = _checked(stacked_batch, local_meta, mesh, checked)
        batch = _local_cell(stacked_batch, mesh, device)
        out = sharded.run(("edgeshard_apply", local_meta, key), forward, params,
                          batch)["preds"]
        if label_dom[0] != "edge":
            return out
        origin = np.asarray(stacked_batch[f"edge_origin_{label_dom[1]}"])
        flat = origin.reshape(origin.shape[0], -1)
        if out.shape[1] != flat.shape[1]:
            raise EdgeShardError(f"prediction rows {out.shape[1]} != edge rows {flat.shape[1]}")
        res = torch.zeros((origin.shape[0], int(origin.max()) + 1) + tuple(out.shape[2:]),
                          dtype=out.dtype, device=out.device)
        for d in range(origin.shape[0]):
            valid = flat[d] >= 0
            rows = torch.from_numpy(np.nonzero(valid)[0]).to(out.device)
            res[d, torch.from_numpy(flat[d][valid].astype(np.int64)).to(out.device)] = \
                out[d, rows]
        return res

    sharded = ShardedStep("the destination-sharded forward", mesh, device, graphs, apply_fn)
    return sharded


def halo_fractions(
    stacked: Dict[str, np.ndarray], model_ir
) -> Dict[str, Dict[str, float]]:
    """Interior/boundary edge accounting of a partitioned batch: the fraction
    of real edges whose aggregation can proceed while the halo all_to_all is
    in flight (the overlap structure, builder._halo_gather). Adjacencies
    without a halo are fully interior."""
    out = {}
    for a in model_ir.adjacency_info():
        em = stacked[f"edge_mask_{a.name}"]
        real = float(em.sum())
        im = stacked.get(f"interior_emask_{a.name}")
        interior = real if im is None else float(im.sum())
        out[a.name] = {
            "real_edges": real,
            "interior_edges": interior,
            "boundary_edges": real - interior,
            "boundary_frac": (real - interior) / real if real else 0.0,
        }
    return out


# --------------------------------------------------------------------------
# analytic comm accounting (docs/scaling.md)
# --------------------------------------------------------------------------


def comm_bytes_per_step(
    model_ir,
    meta: BatchMeta,
    stacked: Dict[str, np.ndarray],
    n_model: int,
    dtype_bytes: int = 4,
) -> Dict[str, Dict[str, float]]:
    """Analytic per-shard collective volume per training step: v1 full-psum
    vs v2 halo, per adjacency. psum counts 2x (reduce-scatter + all-gather
    equivalent); all_to_all counts its send volume once."""
    state_dims = model_ir.state_dims()
    iters = model_ir.num_iterations
    out = {}
    for a in model_ir.adjacency_info():
        d = state_dims[a.dst]
        d_src = state_dims[a.src]
        n_dst = meta.nodes(a.dst)
        v1 = 2 * n_dst * d * dtype_bytes * iters  # full [n_dst, D] psum
        key = f"halo_send_{a.name}"
        if key in stacked:
            h = stacked[key].shape[-1]
            v2 = n_model * h * d_src * dtype_bytes * iters
        else:
            v2 = 0.0
        out[a.name] = {
            "v1_full_psum_bytes": float(v1),
            "v2_halo_bytes": float(v2),
            "ratio": float(v2 / v1) if v1 else 0.0,
        }
    return out
