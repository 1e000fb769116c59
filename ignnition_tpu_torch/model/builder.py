"""Compiler back-end for the ported slices: ModelIR -> `GnnModel`
(counterpart of `ignnition_tpu/model/builder.py`), serving and training.

Ported: the flagship RouteNet path, its attention family, the Q-size
model, message neural networks (the mlp_message family) and the
homogeneous-graph models (`examples/graphprop`, `examples/linkpred`). Each
message passing has messages from one or more sources and an update; the
sequence aggregations run the masked scan (`RNN.masked_update_stacked`:
kernels B and C for a GRU).

Messages (`_sources`, one `_Source` record per source): a direct
assignation is the source state table; a chain that reads `hs_source`
alone runs its networks once per source node into a message table
(source-local), which every table lowering below reads as it reads states;
any other chain makes per-edge messages, at first use: a first Dense layer
over {hs_source, hs_dest, edge_params} splits into per-part matmuls at node
rate, gathered per edge (`seg.gather_rows`, `seg.gather_by_dst`: their
backwards are kernel A), else the inputs are concatenated per edge
(`output_name` values included). Under a sum, a network that ends in a
linear Dense layer leaves that layer to the node rate (`post`).

Aggregations, by branch, in the JAX package's order:
  * `ordered`, one source: the time slices are gathered from the message
    table through the host slice map (`seg.gather_state_slices`; its
    backward is kernel A); for a per-edge network over {hs_source, hs_dest,
    edge_params}, one slice gather of `src_table @ Ksrc` plus the
    destination part, then the network's tail over the whole
    [L, n_dst, H] slot tensor (`_slot_messages`), so that the scan is still
    kernel B; else from the sorted edge messages
    (`RNN.masked_update_from_edges`);
  * `interleave`: the sources' tables, zeroed on padding rows, are stacked
    and read through the combined slice map `ilv_slice_*` (one
    `gather_state_slices`, its backward kernel A over `ilv_sort_*`);
  * `concat` (axis 1, time, or 2, features) and multi-source `ordered`: one
    slice gather per source, stacked;
  * any sequence aggregation without its companions: the padded sequences
    of `seg.scatter_to_sequences` (interleave permuted by
    `interleave_perm_*`) into `RNN.masked_update`;
  * `sum`: per source, a per-edge network's slot-rate sum over the slice
    map while the slots stay under `IR.SLOT_PAD_CAP` times the edges
    (`_slot_rate_sum`), else the best of the block-diagonal / dense
    incidence products (message tables) and the CSR sums
    (`_one_source_sum`, kernel A); a factored last layer is applied to
    each part at node rate (`_finish`); the parts add;
  * `attention` (GAT): in the `per_destination` softmax mode over one
    source, under `_SLOT_ATTN` (off by default: the JAX package's default
    is on) a softmax over the slots of the slice map while they stay under
    `IR.SLOT_PAD_CAP` times the edges (`_slot_attention`: a per-edge
    network's slot tensor, or a message table without an incidence matrix),
    else block-diagonal or dense attention over the int8 incidence matrix
    (message tables; kernels D and E), else the per-edge form
    (`_attention`): over the sorted edge messages with row pointers the
    fused softmax-sum (kernel A), else `seg.segment_softmax` and a sum; the
    `reference` mode (the reference's softmax over each graph's
    destinations) and several sources (their edges concatenated) always
    take the per-edge form, its weighted sum kernel A where a single
    source has row pointers;
  * `convolution` (GCN-style, `_convolution`): the messages times the
    pass's kernel summed by the block-diagonal or dense incidence product
    (message tables), else by the sorted sum (kernel A with row pointers),
    plus the destination's own state, over max(in-degree, 1), then the
    aggregation's activation.
Each choice between two lowerings of one function follows the JAX
package's switches (`_SLICE_MLP`, `_SLOT_SUM`, `_SLOT_ATTN`, `_SPLIT_FIRST`,
`_FACTOR_LAST`, `_HALO_OVERLAP`), and `_ITER_REMAT` recomputes each
iteration in the backward.
After a vector aggregation (sum, attention, convolution) the update is one
recurrent cell step or a feed-forward network over [aggregated, state]
(`{dst}_ff_update`, shared per destination).

The readout (`_readout`) runs the JAX package's pipeline: `neural_network`
and `predict` networks, `pooling` of entity rows per graph
(`seg.graph_pool`: the id-keyed kernel for sum and mean), `product`
(element-wise, or the row-wise dot product) and `extend_adjacencies` (the
final states gathered per edge, both backwards kernel A); graph-level
tensors broadcast onto entity rows, and a readout input may be a batch
feature. Networks take every built-in layer kind and the kinds registered
with `register_layer`; in a training step (`apply(training=True,
generator=)`) the readout's Dropout, AlphaDropout and GaussianNoise draw
from the generator, while message and update networks stay deterministic
(a Dropout there is the identity in training too), as in the JAX package.

Under edge sharding (`apply(edge_axis=group)`, the v1 step of
`parallel/steps.py`) the batch holds this rank's block of every edge array:
the lowerings whose companions describe the whole edge array are off, as in
the JAX package (row pointers and the gathers' sorts, the incidence
products, the slice maps, the slot-rate sum, the fused per-edge softmax),
so every aggregation takes its generic branch over the rank's edges (a
sorted sum is the id-keyed kernel, a sequence the padded scatter into
kernel B) and all-reduces the partial over the group.

Under destination sharding (`apply(node_axis=group)`, v2,
`parallel/edgeshard.py`) the batch is this rank's local batch: its block of
every entity's rows and the edges whose destinations it owns, with local
row pointers and in-degrees and no slice map, incidence or source sort (a
halo slot is not a zero row, and those would read it). Every aggregation
and update is local, on the single-device branches that these companions
allow (a sum with row pointers is kernel A, the ordered update
`RNN.masked_update_from_edges`, kernels B and C). Every gather of source
rows reads through the halo (`_halo_gather`: the interior edges from the
local block while the boundary rows travel, one `all_to_all` per gather),
and only the per-graph reductions cross ranks: pooling and the `reference`
softmax's max and denominator.

`apply(params, batch, meta)` is a function of a parameter tree, which the
trainer differentiates (its leaves require grad; the batch's training
companions route each backward through the hand-written transposes of
`ops/segment.py`). `forward(batch, meta)` applies the module's own
parameters, which never require grad: serving records no graph.

Parameters keep the JAX package's tree and keys letter for letter
(`update` -> `{dst}_update` -> `kernel` or `{dst}_ff_update` -> `layers`,
`aggregation` -> `s{si}/m{mi}` -> `kernel1` or `kernel`, `message` ->
`s{si}/m{mi}/src{ki}/op{oi}` -> `layers` -> j -> `kernel`, `readout` ->
`op{i}` -> `layers` -> j -> `kernel`; a key may hold a `/`), so
`params_from_jax` moves a JAX tree across unchanged, and every rebuild of
a tree keeps its structure (`map_params`, `with_leaves`). The module
registers the leaves flat under `flatten_params`' names.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.graph import BatchMeta, infer_readout_domains
from ..data.graph import interleave_tag as IVT
from ..frontend import ir as IR
from ..nn import mlp as MLP
from ..nn import rnn as RNN
from ..nn.layers import SUPPORTED_LAYERS, activation, glorot_uniform
from ..ops import segment as seg
from ..ops._collectives import all_to_all_wait, pmax, psum


class BuildError(ValueError):
    pass


_SEQUENCE_AGGS = ("ordered", "concat", "interleave")

# The JAX package's exact-lowering switches, under its names and defaults
# (its `docs/knobs.md`). Each picks between two lowerings of the same
# function, under the JAX package's conditions. The JAX package reads them
# from `IGNNITION_TPU_*` variables for A/B runs on the TPU; no workload of the
# port wants another value than the default, so the first five are module
# attributes only, which the tests set to hold each branch to the JAX
# package's. A step captured on the card is not bound to them: set them
# before the first step.
# an ordered update over a per-edge network over {hs_source, hs_dest,
# edge_params} runs the network over the [L, n_dst] slot tensor of the slice
# map (`_slot_messages`), else over the sorted edge messages
# (`RNN.masked_update_from_edges`)
_SLICE_MLP = True
# a sum over such a network at slot rate (`_slot_rate_sum`), else the
# per-edge messages' sorted sum
_SLOT_SUM = True
# a first Dense layer over {hs_source, hs_dest, edge_params} as per-part
# matmuls at node rate, else over the per-edge concatenation (and no slot
# route for such a network)
_SPLIT_FIRST = True
# under a sum, a network's last linear Dense layer applied after the sum, at
# node rate (`_finish`), else per edge
_FACTOR_LAST = True
# destination sharding's source gathers overlapped with the halo exchange
# (`_halo_gather`), else extend-then-gather
_HALO_OVERLAP = True
# per-destination attention at slot rate (`_slot_attention`), for per-edge
# networks and for message tables without an incidence matrix, else the
# per-edge form. IGNNITION_TPU_SLOT_ATTN=1 turns it on. The JAX package's
# default is on, for the TPU; the port's is off: on an H100 the
# per-edge form is the faster of the two on both workloads measured (the
# attention family at x4 and the mlp_message network into attention; README)
_SLOT_ATTN = os.environ.get("IGNNITION_TPU_SLOT_ATTN", "0") != "0"
# 'always': each message-passing iteration of a step that records gradients
# runs under `torch.utils.checkpoint` (the JAX `jax.checkpoint`): its
# activations are recomputed in the backward instead of kept, for batches
# that memory bounds; 'never' (the default) keeps them
_ITER_REMAT = os.environ.get("IGNNITION_TPU_ITER_REMAT", "never")
# the lowering switches that a user sets, from the environment: a captured
# step is bound to them (`training.capture.switches`)
SWITCHES = ("_SLOT_ATTN", "_ITER_REMAT")


_SPLIT_INPUTS = ("hs_source", "hs_dest", "edge_params")


def _split_first_kernels(op, k0, w_src: int, w_dst: int, w_ep: int):
    """The rows of a first-Dense kernel by the op's named inputs:
    concat([hs_source | hs_dest | edge_params]) @ k0 == the per-part matmuls
    with (ksrc, kdst, kep); a repeated input adds its slices. None for an
    input the op does not read."""
    ksrc = kdst = kep = None
    lo = 0
    for name in op.inputs:
        w = {"hs_source": w_src, "hs_dest": w_dst}.get(name, w_ep)
        sl = k0[lo : lo + w]
        if name == "hs_source":
            ksrc = sl if ksrc is None else ksrc + sl
        elif name == "hs_dest":
            kdst = sl if kdst is None else kdst + sl
        else:
            kep = sl if kep is None else kep + sl
        lo += w
    if lo != k0.shape[0]:
        raise BuildError(f"first-Dense kernel layout: sliced {lo} rows of {k0.shape[0]}")
    return ksrc, kdst, kep


@dataclass(frozen=True)
class _MessageDims:
    """Widths resolved at build time (the JAX `_MessageDims`)."""

    final_message_dim: Mapping[Tuple[int, int, int], int]  # (stage, mp, source)
    aggregated_dim: Mapping[Tuple[int, int], int]  # (stage, mp) -> update input width
    op_in_dims: Mapping[Tuple[int, int, int, int], int]  # (stage, mp, source, op)
    named_output_dims: Mapping[str, int]  # message-op output_name -> width


def _resolve_dims(model_ir) -> _MessageDims:
    """Each message network's input width, each source's message width and
    each update's input width: a convolution keeps the destination's width
    (its messages must have it), a concat on the feature axis adds its
    sources' message widths, every other aggregation takes the first's. A
    feed-forward update needs a vector aggregation."""
    state_dims = model_ir.state_dims()
    final: Dict[Tuple[int, int, int], int] = {}
    named: Dict[str, int] = {}
    aggregated: Dict[Tuple[int, int], int] = {}
    op_in: Dict[Tuple[int, int, int, int], int] = {}
    for si, stage in enumerate(model_ir.stages):
        for mi, mp in enumerate(stage.passes):
            dst_dim = state_dims[mp.destination]
            widths = []
            for ki, src in enumerate(mp.sources):
                out_dim = state_dims[src.entity]  # direct assignation
                for oi, op in enumerate(src.ops):
                    if op.kind != "mlp":
                        continue
                    in_dim = 0
                    for name in op.inputs:
                        if name == "hs_source":
                            in_dim += state_dims[src.entity]
                        elif name == "hs_dest":
                            in_dim += dst_dim
                        elif name == "edge_params":
                            in_dim += src.edge_param_dim
                        elif name in named:
                            in_dim += named[name]
                        else:
                            raise BuildError(f"message op input '{name}' has unknown width")
                    op_in[(si, mi, ki, oi)] = in_dim
                    out_dim = MLP.output_dim(op.mlp, in_dim)
                    if op.output_name:
                        named[op.output_name] = out_dim
                final[(si, mi, ki)] = out_dim
                widths.append(out_dim)
            agg = mp.aggregation
            if agg.kind == "convolution":
                if widths[0] != dst_dim:
                    raise BuildError(
                        f"convolution aggregation requires message dim "
                        f"({widths[0]}) == destination state dim ({dst_dim})"
                    )
                aggregated[(si, mi)] = dst_dim
            elif agg.kind == "concat" and agg.concat_axis == 2:
                aggregated[(si, mi)] = sum(widths)
            else:
                aggregated[(si, mi)] = widths[0]
            if mp.update.kind == "mlp" and agg.kind in _SEQUENCE_AGGS:
                raise BuildError(
                    f"a feed-forward update requires a single-vector aggregation "
                    f"(sum/attention/convolution), got '{agg.kind}' for "
                    f"destination '{mp.destination}'"
                )
    return _MessageDims(final, aggregated, op_in, named)


def _readout_in_dims(model_ir, dims: _MessageDims, extra_dims=None) -> Dict[int, int]:
    """The input width of each readout network (predict and neural_network
    ops, by op index), from the widths the pipeline gives its tensors (the
    JAX `init`'s `ro_dims`): entity states, message outputs, batch features
    (an entity feature's size, or `extra_dims`), then each op's outputs: a
    network's its last width, a pooling its input's, a dot product 1, an
    element-wise product its first input's, `extend_adjacencies` each
    input's."""
    ro_dims: Dict[str, int] = {f.name: f.size for f in model_ir.all_features()}
    ro_dims.update(model_ir.state_dims())
    ro_dims.update(dims.named_output_dims)
    ro_dims.update(extra_dims or {})

    def width(name):
        if name not in ro_dims:
            raise BuildError(
                f"readout input '{name}' has unknown width (pass its width in extra_dims)"
            )
        return ro_dims[name]

    in_dims: Dict[int, int] = {}
    for i, op in enumerate(model_ir.readout):
        if op.kind in ("predict", "neural_network"):
            in_dims[i] = sum(width(name) for name in op.inputs)
            if op.kind == "neural_network":
                ro_dims[op.output_name] = MLP.output_dim(op.mlp, in_dims[i])
        elif op.kind == "pooling":
            ro_dims[op.output_name] = width(op.inputs[0])
        elif op.kind == "product":
            ro_dims[op.output_name] = (
                1 if op.product == "dot_product" else width(op.inputs[0])
            )
        elif op.kind == "extend_adjacencies":
            ro_dims[op.output_names[0]] = width(op.inputs[0])
            ro_dims[op.output_names[1]] = width(op.inputs[1])
    return in_dims


def _lens(sources, batch, n_dst, edge_axis=None):
    """Real messages per destination and source: the data layer's `lens_*`
    (whole-graph counts, which the edge-sharded step needs as they are), or
    counted from the edge masks (over every rank's edges under
    `edge_axis`)."""
    return [
        batch[f"lens_{s.adj}"] if f"lens_{s.adj}" in batch
        else seg.segment_count(s.dst_idx, n_dst, s.mask, group=edge_axis)
        for s in sources
    ]


def _halo_src_table(batch, a, table, node_axis):
    """A local source-row table extended with the halo rows the peers own
    (`seg.halo_extend` through the batch's `halo_send_*`), the JAX
    `_halo_src_table`; the table itself when not destination-sharded or
    when the adjacency has no halo."""
    send = batch.get(f"halo_send_{a}")
    if node_axis is None or send is None:
        return table
    return seg.halo_extend(table, send, node_axis)


def _halo_gather(batch, a, table, node_axis):
    """Each edge's source row under destination sharding, overlapped with
    the halo exchange (the JAX `_halo_gather`): the exchange is issued, the
    interior edges (source owned here, remapped index < B) gather from the
    local block while it travels, then the boundary edges gather from the
    received rows, and the two masked passes add. Equal to
    `halo_extend(table)[src]` on real edges, zero on padding edges. Without
    the batch's interior mask, or with `_HALO_OVERLAP` off, the synchronous
    extend-then-gather; without a halo, the local gather. The gathers index plainly: their backward is
    autograd's scatter-add. An edge that a pass masks out reads row
    (edge % rows) there, not one clamped row: the scatter-add's sorted
    backward walks a run of equal indices one at a time: a run of every
    boundary (or interior) edge cost 0.35-0.93 s of device time a flagship
    step on an H100 (`chip_smoke.py` phase 13)."""
    src_idx = batch[f"src_{a}"]
    send = batch.get(f"halo_send_{a}")
    if send is None:
        return table[src_idx]
    imask = batch.get(f"interior_emask_{a}")
    if not _HALO_OVERLAP or imask is None:
        return seg.halo_extend(table, send, node_axis)[src_idx]
    bmask = batch[f"boundary_emask_{a}"]
    b = table.shape[0]
    pending = seg.halo_recv(table, send, node_axis, wait=False)
    spread = torch.arange(src_idx.shape[0], device=src_idx.device)
    interior = table[torch.where(imask > 0, src_idx, spread % b)]
    interior = interior * imask[:, None].to(table.dtype)
    recv = all_to_all_wait(pending)
    boundary = recv[torch.where(bmask > 0, src_idx - b, spread % recv.shape[0])]
    return interior + boundary * bmask[:, None].to(table.dtype)


def _gather_src(batch, a, table, edge_axis=None, node_axis=None):
    """Each edge's source row of `table`; with the batch's source sort
    (`src_perm_*`, `src_row_ptr_*`) the backward is kernel A, where
    autograd's scatter-add into a table of many rows takes hundreds of
    milliseconds on the card (PERF.md §5). Under `edge_axis` plain indexing:
    the sort describes the whole edge array, not this rank's block. Under
    `node_axis` through the halo (`_halo_gather`)."""
    if node_axis is not None:
        return _halo_gather(batch, a, table, node_axis)
    if edge_axis is not None:
        return table[batch[f"src_{a}"]]
    return seg.gather_rows(
        table, batch[f"src_{a}"], batch.get(f"src_perm_{a}"), batch.get(f"src_row_ptr_{a}")
    )


def _gather_dst(batch, a, table, edge_axis=None):
    """Each edge's destination row of `table`; with the batch's row pointers
    the backward is kernel A, else (and under `edge_axis`) autograd's
    scatter-add."""
    dst_idx, row_ptr = batch[f"dst_{a}"], batch.get(f"row_ptr_{a}")
    if row_ptr is None or edge_axis is not None:
        return table[dst_idx]
    return seg.gather_by_dst(table, dst_idx, row_ptr)


class _Source:
    """One source of a message passing, as its aggregation reads it (the JAX
    per-source record): `table`, the per-node message table of a direct or
    source-local chain (None for per-edge networks); `pkey`, the parameters
    of the chain's first network, if it has one; `post`, the factored
    last Dense layer (kernel, bias or None) of a per-edge network under a
    sum; `messages`, the per-edge messages [E, D], zero on padding edges,
    made by `make` at first use (the slot routes never read them)."""

    def __init__(self, batch, src, table=None, pkey=None, post=None, make=None,
                 edge_axis=None, node_axis=None):
        a = src.adj_name
        self.spec, self.adj, self.entity, self.pkey = src, a, src.entity, pkey
        self.dst_idx, self.seq = batch[f"dst_{a}"], batch[f"seq_{a}"]
        self.mask = batch[f"edge_mask_{a}"]
        self.table, self.post = table, post
        self._make = make if make is not None else (
            lambda: _gather_src(batch, a, table, edge_axis, node_axis))
        self._messages = None

    @property
    def messages(self) -> torch.Tensor:
        if self._messages is None:
            m = self._make()
            # the mask multiply stays in the graph: it annihilates what a
            # backward credits to padding edges
            self._messages = m * self.mask[:, None].to(m.dtype)
        return self._messages


def _slices(batch, table, map_name, sort_name, suffix):
    """The time slices of `table` read through a slice map and, where the
    batch has them, its sort companions (the backward: kernel A)."""
    return seg.gather_state_slices(
        table, batch[f"{map_name}_{suffix}"],
        *(batch.get(f"{sort_name}_{part}_{suffix}") for part in ("perm", "ids", "row_ptr")),
    )


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------


def flatten_params(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flat view for people and comparisons, in the tree's own order:
    {'update/path_update/kernel': tensor, 'aggregation/s1/m0/kernel1': ...,
    'readout/op0/layers/0/bias': ...}. The names join each leaf's keys by
    `/`; a key may hold a `/` itself (`s1/m0`), so a name does not give the
    tree back: rebuild with `map_params` or `with_leaves`."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def map_params(fn: Callable[[Any], Any], tree):
    """The same tree (dict keys letter for letter, sequences as tuples) with
    `fn` applied to every leaf, in `flatten_params` order."""
    if isinstance(tree, Mapping):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_params(fn, v) for v in tree)
    return fn(tree)


def with_leaves(tree, leaves: Iterable[Any]):
    """`tree`'s structure holding `leaves`, given in `flatten_params` order."""
    it = iter(leaves)
    return map_params(lambda _: next(it), tree)


def params_from_jax(tree) -> Dict[str, Any]:
    """The JAX package's parameter tree (arrays of any kind numpy can read)
    as the same tree of float32 CPU tensors. Keys are unchanged."""
    return map_params(lambda v: torch.from_numpy(np.array(v, dtype=np.float32)), tree)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


class GnnModel(nn.Module):
    """A model compiled from IR. Serving parameters live in `self.params`
    (flat, under `flatten_params`' names); `forward` reads a device
    batch with them and `apply` with any parameter tree."""

    def __init__(self, model_ir):
        super().__init__()
        self.ir = model_ir
        self.state_dims = model_ir.state_dims()
        self.dims = _resolve_dims(model_ir)
        self.domains = infer_readout_domains(model_ir)
        self._structure: Dict[str, Any] = {}
        self.params = nn.ParameterDict()

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    def init(
        self, generator: torch.Generator, extra_dims: Optional[Mapping[str, int]] = None
    ) -> Dict[str, Any]:
        """Draw parameters from `generator` in the JAX package's tree, load
        them into the module (on the CPU) and return the tree.

        extra_dims: widths of readout inputs that come straight from the
        dataset and are not entity features (whose sizes the IR knows)."""
        ir = self.ir
        params: Dict[str, Any] = {"message": {}, "aggregation": {}, "update": {}, "readout": {}}
        upd_in_dims: Dict[str, int] = {}
        for si, stage in enumerate(ir.stages):
            for mi, mp in enumerate(stage.passes):
                for ki, src in enumerate(mp.sources):
                    for oi, op in enumerate(src.ops):
                        if op.kind == "mlp":
                            params["message"][f"s{si}/m{mi}/src{ki}/op{oi}"], _ = MLP.init(
                                generator, op.mlp, self.dims.op_in_dims[(si, mi, ki, oi)]
                            )
                msg_dim = self.dims.final_message_dim[(si, mi, 0)]
                agg_dim = self.dims.aggregated_dim[(si, mi)]
                dst_dim = self.state_dims[mp.destination]
                if mp.aggregation.kind == "attention":
                    # drawn before the pass's update, as in the JAX package
                    params["aggregation"][f"s{si}/m{mi}"] = {
                        "kernel1": glorot_uniform(generator, (msg_dim, msg_dim)),
                        "kernel2": glorot_uniform(generator, (dst_dim, msg_dim)),
                        "attn_kernel": glorot_uniform(generator, (2 * msg_dim, 1)),
                    }
                elif mp.aggregation.kind == "convolution":
                    params["aggregation"][f"s{si}/m{mi}"] = {
                        "kernel": glorot_uniform(generator, (dst_dim, dst_dim)),
                    }
                key = self._update_key(mp)
                if key not in params["update"]:
                    if mp.update.kind == "recurrent":
                        params["update"][key] = RNN.init(
                            generator, mp.update.rnn, in_dim=agg_dim, units=dst_dim
                        )
                    else:
                        params["update"][key], _ = MLP.init(
                            generator, mp.update.mlp, agg_dim + dst_dim, last_units=dst_dim
                        )
                    upd_in_dims[key] = agg_dim
                if upd_in_dims[key] != agg_dim:
                    raise BuildError(
                        f"the message passings updating '{mp.destination}' "
                        f"aggregate to different dimensionalities "
                        f"({upd_in_dims[key]} vs {agg_dim}); the destination's "
                        f"update model is shared"
                    )
        for i, in_dim in _readout_in_dims(ir, self.dims, extra_dims).items():
            params["readout"][f"op{i}"], _ = MLP.init(generator, ir.readout[i].mlp, in_dim)
        self.load_params(params)
        return params

    @staticmethod
    def _update_key(mp) -> str:
        """The destination's update parameters: shared by every pass that
        updates it, recurrent or feed-forward."""
        suffix = "update" if mp.update.kind == "recurrent" else "ff_update"
        return f"{mp.destination}_{suffix}"

    def load_params(self, params, device=None) -> None:
        """Register a parameter tree (JAX layout) on the module."""
        flat = flatten_params(params)
        self._structure = map_params(lambda _: None, params)
        self.params = nn.ParameterDict(
            {
                k: nn.Parameter(
                    torch.as_tensor(v, dtype=torch.float32, device=device),
                    requires_grad=False,
                )
                for k, v in flat.items()
            }
        )

    def param_tree(self) -> Dict[str, Any]:
        """The module's parameters as the nested tree."""
        names = flatten_params(self._structure)
        return with_leaves(self._structure, (self.params[k] for k in names))

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def regularization_loss(self, params) -> torch.Tensor:
        """Sum of all layers' l2 kernel penalties over a parameter tree, in
        the JAX package's order: each pass's message networks, then its
        feed-forward update (once per destination: the passes share it),
        then the readout's networks."""
        parts = []
        counted = set()
        for si, stage in enumerate(self.ir.stages):
            for mi, mp in enumerate(stage.passes):
                parts += [
                    MLP.l2_loss(op.mlp, params["message"][f"s{si}/m{mi}/src{ki}/op{oi}"])
                    for ki, src in enumerate(mp.sources)
                    for oi, op in enumerate(src.ops)
                    if op.kind == "mlp"
                ]
                key = self._update_key(mp)
                if mp.update.kind == "mlp" and key not in counted:
                    counted.add(key)
                    parts.append(MLP.l2_loss(mp.update.mlp, params["update"][key]))
        parts += [
            MLP.l2_loss(op.mlp, params["readout"][f"op{i}"])
            for i, op in enumerate(self.ir.readout)
            if op.kind in ("predict", "neural_network")
        ]
        return sum(parts[1:], parts[0])

    def forward(
        self,
        batch: Mapping[str, torch.Tensor],
        meta: BatchMeta,
        compute_dtype: Optional[torch.dtype] = None,
        edge_axis=None,
        node_axis=None,
    ) -> torch.Tensor:
        """`apply` with the module's own parameters."""
        return self.apply(
            self.param_tree(), batch, meta, compute_dtype=compute_dtype, edge_axis=edge_axis,
            node_axis=node_axis,
        )

    def apply(
        self,
        params,
        batch: Mapping[str, torch.Tensor],
        meta: BatchMeta,
        compute_dtype: Optional[torch.dtype] = None,
        *,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        edge_axis=None,
        node_axis=None,
    ) -> torch.Tensor:
        """Predictions [rows] (last dim squeezed when 1), float32, from the
        parameter tree `params` (JAX layout, float32 tensors).

        compute_dtype (e.g. torch.bfloat16): parameters and hidden states are
        cast to it with explicit casts, as the JAX `apply(compute_dtype=)`
        does, so gradients arrive in float32 on the tree's leaves;
        predictions come back as float32.

        training: the readout's random layers (Dropout, AlphaDropout,
        GaussianNoise) draw from `generator`, and raise without one; with
        training=False they are the identity and `generator` is not read.
        Message and update networks are deterministic either way, as in the
        JAX package.

        edge_axis: edge sharding (v1, `parallel/steps.py`): a process group
        over whose ranks every adjacency's edges are split in contiguous
        blocks (`batch` holds this rank's block of each edge array, and the
        whole of every other array), node tables replicated. Every
        aggregation computes this rank's partial and all-reduces it over
        the group. As in the JAX package, the lowerings whose arrays
        describe the whole edge array are off: row pointers and the sorts
        of the gathers, the dense and block incidence, the slice maps, the
        slot-rate sum and the fused per-edge softmax.

        node_axis: destination sharding (v2, `parallel/edgeshard.py`): the
        model axis's process group, `batch` this rank's local batch
        (`partition_batch`: its block of every entity's rows and the edges
        whose destinations it owns, source indices into the halo-extended
        table) and `meta` the local meta. Aggregations and updates are local;
        source rows come through one `all_to_all` halo per gather, and only
        pooling and the `reference` softmax's per-graph statistics combine
        over the group. Exclusive of edge_axis."""
        if edge_axis is not None and node_axis is not None:
            raise BuildError("edge_axis and node_axis are mutually exclusive")
        ir = self.ir
        if compute_dtype is not None:
            params = map_params(lambda v: v.to(compute_dtype), params)

        # ---- hidden state initialization ----
        states: Dict[str, torch.Tensor] = {}
        for e in ir.entities:
            n = meta.nodes(e.name)
            mask = batch[f"node_mask_{e.name}"]
            parts = [batch[f.name].reshape(n, f.size) for f in e.features]
            total = sum(f.size for f in e.features)
            if total > e.state_dim:
                raise BuildError(
                    f"features of entity '{e.name}' ({total}) exceed its "
                    f"hidden_state_dimension ({e.state_dim})"
                )
            parts.append(
                torch.zeros((n, e.state_dim - total), dtype=torch.float32, device=mask.device)
            )
            state0 = torch.cat(parts, dim=1) * mask[:, None]
            if compute_dtype is not None:
                state0 = state0.to(compute_dtype)
            states[e.name] = state0

        # loop-invariant per-batch tensors (incidence matrices upcast for the
        # sum's library products; attention reads them as int8)
        cache: Dict[Any, torch.Tensor] = {}
        iteration = self._message_passing_iteration
        if _ITER_REMAT == "always" and torch.is_grad_enabled():
            # each iteration's activations recomputed in the backward. The
            # recompute of the first iteration finds the upcasts that its
            # forward put in `cache` (and `seg.gather_state_slices` the
            # whole sort it kept on its tensor), where the forward made
            # them: a cast saves nothing for the backward, so both runs save
            # the same tensors in the same order. The iteration draws no
            # random numbers, so no RNG state is kept, which a CUDA graph's
            # capture could not read. Under `node_axis` the recompute sends
            # the iteration's halo exchanges again, on every rank in the
            # same order: ranks run the same backward
            def iteration(*args, _fn=self._message_passing_iteration):
                return checkpoint(_fn, *args, use_reentrant=False, preserve_rng_state=False)
        for _ in range(ir.num_iterations):
            states = iteration(params, batch, meta, states, cache, edge_axis, node_axis)

        preds = self._readout(params, batch, meta, states, training, generator, edge_axis,
                              node_axis)
        if compute_dtype is not None:
            preds = preds.to(torch.float32)
        return preds

    def _message_passing_iteration(self, params, batch, meta, states, cache, edge_axis=None,
                                   node_axis=None):
        new_states = dict(states)
        edge_vars: Dict[str, torch.Tensor] = {}  # output_name -> per-edge values
        for si, stage in enumerate(self.ir.stages):
            for mi, mp in enumerate(stage.passes):
                dst = mp.destination
                n_dst = meta.nodes(dst)
                dst_states = new_states[dst]
                sources = self._sources(
                    params["message"], si, mi, mp, batch, new_states, dst_states, edge_vars,
                    edge_axis, node_axis,
                )
                up = params["update"][self._update_key(mp)]
                kind = mp.aggregation.kind
                if kind in _SEQUENCE_AGGS:
                    new_state = self._sequence_update(
                        mp, IVT(dst, si, mi), up, sources, dst_states, new_states, batch, meta,
                        edge_axis,
                    )
                else:
                    if kind == "sum":
                        # per source, each on its own best lowering (under edge
                        # sharding each rank's sorted block, all-reduced); the
                        # parts add
                        parts = [
                            self._finish(
                                self._one_source_sum(
                                    s, dst_states, new_states, batch, meta, n_dst, cache
                                ) if edge_axis is None else seg.segment_sum(
                                    s.messages, s.dst_idx, n_dst, indices_are_sorted=True,
                                    group=edge_axis,
                                ),
                                s, batch, n_dst, edge_axis,
                            )
                            for s in sources
                        ]
                        part = sum(parts[1:], parts[0])
                    elif kind == "attention":
                        part = self._attention_aggregate(
                            params["aggregation"][f"s{si}/m{mi}"], mp, sources,
                            dst_states, new_states, batch, meta, n_dst, edge_axis, node_axis,
                        )
                    else:
                        part = self._convolution(
                            params["aggregation"][f"s{si}/m{mi}"], mp.aggregation, sources,
                            dst_states, batch, n_dst, cache, edge_axis,
                        )
                    # the sorted sums return f32 (the kernel's accumulator)
                    aggregated = part.to(dst_states.dtype)
                    if mp.update.kind == "recurrent":
                        new_state = RNN.cell_step(mp.update.rnn, up, aggregated, dst_states)
                    else:
                        x = torch.cat([aggregated, dst_states], dim=1)
                        new_state = MLP.apply(mp.update.mlp, up, x)
                node_mask = batch[f"node_mask_{dst}"]
                new_states[dst] = new_state * node_mask[:, None].to(new_state.dtype)
        return new_states

    # ------------------------------------------------------------------
    # messages
    # ------------------------------------------------------------------

    def _sources(self, mparams, si, mi, mp, batch, states, dst_states, edge_vars,
                 edge_axis=None, node_axis=None):
        """One `_Source` per source of a message passing (the JAX message
        creation): a direct or source-local chain becomes a per-node message
        table; any other chain per-edge messages, made at first use."""
        out = []
        for ki, src in enumerate(mp.sources):
            keys = lambda oi, _ki=ki: mparams[f"s{si}/m{mi}/src{_ki}/op{oi}"]
            if IR.is_source_local(src.ops):
                # the chain is a function of the source state: run it once per node
                table = states[src.entity]
                for oi, op in enumerate(src.ops):
                    if op.kind == "direct":
                        table = states[src.entity]
                    else:
                        x = torch.cat([states[src.entity]] * len(op.inputs), dim=1)
                        table = MLP.apply(op.mlp, keys(oi), x)
                out.append(_Source(batch, src, table=table, edge_axis=edge_axis,
                                   node_axis=node_axis))
                continue
            s = self._per_edge_source(
                mp, src, keys, batch, states, dst_states, edge_vars, edge_axis, node_axis
            )
            if any(op.output_name for op in src.ops):
                s.messages  # publishes its named outputs in the JAX order
            out.append(s)
        return out

    def _per_edge_source(self, mp, src, keys, batch, states, dst_states, edge_vars,
                         edge_axis=None, node_axis=None):
        """A chain over per-edge inputs. A network whose first layer is Dense
        over {hs_source, hs_dest, edge_params} runs that layer as per-part
        matmuls at node rate, and the parts meet per edge (split first);
        any other network concatenates its inputs per edge. Under a sum, a
        last network ending in a linear Dense layer stops before it: that
        layer is `post`, applied after the sum (factor last). Under
        `node_axis` the split first layer's source part is multiplied on the
        local block and its `units`-wide rows travel through the halo."""
        a = src.adj_name
        ops = src.ops
        last = len(ops) - 1
        factor_last = (
            _FACTOR_LAST
            and mp.aggregation.kind == "sum"
            and ops[last].kind == "mlp"
            and not ops[last].output_name
            and len(ops[last].mlp.layers) >= 2
            and MLP.can_factor_last(ops[last].mlp)
        )
        post = MLP.last_dense(ops[last].mlp, keys(last)) if factor_last else None
        edge_params = batch.get(f"params_{a}")

        def by_src(table):
            return _gather_src(batch, a, table, edge_axis, node_axis)

        def by_dst(table):
            return _gather_dst(batch, a, table, edge_axis)

        def make():
            gathered = {}

            def gathered_src():
                if "src" not in gathered:
                    gathered["src"] = by_src(states[src.entity])
                return gathered["src"]

            messages = None
            for oi, op in enumerate(ops):
                if op.kind == "direct":
                    messages = gathered_src()
                    continue
                p = keys(oi)
                prefix = factor_last and oi == last
                if (
                    _SPLIT_FIRST
                    and MLP.can_split_first(op.mlp)
                    and op.inputs
                    and all(n in _SPLIT_INPUTS for n in op.inputs)
                ):
                    k0 = p["layers"][0]["kernel"]
                    ksrc, kdst, kep = _split_first_kernels(
                        op, k0, states[src.entity].shape[1], dst_states.shape[1],
                        edge_params.shape[1] if edge_params is not None else 0,
                    )
                    pre = []
                    if ksrc is not None:
                        pre.append(by_src(states[src.entity] @ ksrc))
                    if kdst is not None:
                        pre.append(by_dst(dst_states @ kdst))
                    if kep is not None:
                        pre.append(edge_params.to(k0.dtype) @ kep)
                    pre = sum(pre[1:], pre[0])
                    finish = MLP.prefix_from_first_preact if prefix else MLP.apply_from_first_preact
                    messages = finish(op.mlp, p, pre)
                else:
                    inputs = []
                    for name in op.inputs:
                        if name == "hs_source":
                            inputs.append(gathered_src())
                        elif name == "hs_dest":
                            inputs.append(by_dst(dst_states))
                        elif name == "edge_params":
                            inputs.append(edge_params.to(dst_states.dtype))
                        else:
                            inputs.append(edge_vars[name])
                    x = torch.cat(inputs, dim=1)
                    messages = (MLP.apply_prefix if prefix else MLP.apply)(op.mlp, p, x)
                if op.output_name:
                    edge_vars[op.output_name] = messages
            return messages

        pkey = keys(0) if ops[0].kind == "mlp" else None
        return _Source(batch, src, pkey=pkey, post=post, make=make)

    def _slot_messages(self, s, dst_states, states, batch, meta, n_dst,
                       want_prefix=False, capped=True, enabled=True):
        """The [L, n_dst, D] slot tensor of one source over its in-degree
        slice map, or None where the batch or the chain does not allow it: a
        message table's slice gather, or for a per-edge network over
        {hs_source, hs_dest, edge_params} one slice gather of
        `src_table @ Ksrc`, the node-rate destination part broadcast over the
        slots and the edge params relaid in the slot layout, then the
        network's tail (or, with `want_prefix`, all but its last layer) over
        the whole tensor: every layer acts on the last axis. `capped` skips
        slot counts past `IR.SLOT_PAD_CAP` times the edges (an ordered update
        scans the slot layout anyway, so it passes False). `enabled`: the
        caller's switch. A per-edge network needs `_SPLIT_FIRST`. Invalid
        slots hold finite values that every consumer masks by the
        in-degree."""
        a = s.adj
        if not enabled or f"slice_src_{a}" not in batch or f"lens_{a}" not in batch:
            return None
        L = meta.maxlen(a)
        if capped and L * n_dst > IR.SLOT_PAD_CAP * meta.edges(a):
            return None
        if s.table is not None:
            return _slices(batch, s.table, "slice_src", "slice_sort", a)
        ops, pkey = s.spec.ops, s.pkey
        if not _SPLIT_FIRST or pkey is None or not IR.is_slot_eligible(ops) or (
            "edge_params" in ops[0].inputs and f"params_slice_{a}" not in batch
        ):
            return None
        op = ops[0]
        k0 = pkey["layers"][0]["kernel"]
        params_slice = batch.get(f"params_slice_{a}")
        ksrc, kdst, kep = _split_first_kernels(
            op, k0, states[s.entity].shape[1], dst_states.shape[1],
            params_slice.shape[-1] if params_slice is not None else 0,
        )
        pre = None
        if ksrc is not None:
            pre = _slices(batch, states[s.entity] @ ksrc, "slice_src", "slice_sort", a)
        if kep is not None:
            part = params_slice.to(k0.dtype) @ kep
            pre = part if pre is None else pre + part
        if kdst is not None:
            part = (dst_states @ kdst)[None]
            # an hs_dest-only chain: each of a destination's edges carries the
            # same message, so it is broadcast over the slots
            pre = part.expand((L,) + part.shape[1:]) if pre is None else pre + part
        tail = MLP.prefix_from_first_preact if want_prefix else MLP.apply_from_first_preact
        if all(layer.kind in SUPPORTED_LAYERS for layer in op.mlp.layers):
            return tail(op.mlp, pkey, pre)
        # a custom layer may act on more than the last axis: it sees the
        # slots as [L * n_dst, H] rows, as in the JAX package
        rows = tail(op.mlp, pkey, pre.reshape(-1, pre.shape[-1]))
        return rows.reshape(pre.shape[0], pre.shape[1], -1)

    # ------------------------------------------------------------------
    # aggregations
    # ------------------------------------------------------------------

    def _sequence_update(self, mp, tag, up, sources, dst_states, states, batch, meta,
                         edge_axis=None):
        """An ordered, interleave or concat aggregation into the masked scan,
        by the first branch the batch's companions and the messages allow,
        in the JAX package's order: the ordered update through the slice map
        (`_slot_messages`: a message table's slices, or a per-edge network's
        slot tensor), then without it over the edge messages; the interleave
        of message tables through the combined slice map; concat and
        multi-source ordered of message tables through one slice map per
        source; else the padded sequences of every source's edge messages
        (`interleave_perm_*` reorders an interleave's time axis). Under
        `edge_axis` only the last: each rank scatters its edges and the
        padded sequences are all-reduced."""
        agg = mp.aggregation
        spec = mp.update.rnn
        n_dst = meta.nodes(mp.destination)
        s0 = sources[0]
        a0 = s0.adj
        sharded = edge_axis is not None

        def lens():
            return _lens(sources, batch, n_dst, edge_axis)

        def zero_padding_rows(s):
            # empty slots read a padding row: it must hold exact zeros
            return s.table * batch[f"node_mask_{s.entity}"][:, None].to(s.table.dtype)

        if (
            agg.kind == "ordered" and len(sources) == 1 and f"row_ptr_{a0}" in batch
            and not sharded
        ):
            # a message table's slices always; a per-edge network's slot
            # tensor under `_SLICE_MLP`
            xs = self._slot_messages(s0, dst_states, states, batch, meta, n_dst, capped=False,
                                     enabled=_SLICE_MLP or s0.table is not None)
            if xs is not None:
                return RNN.masked_update_stacked(spec, up, xs, batch[f"lens_{a0}"], dst_states)
            return RNN.masked_update_from_edges(
                spec, up, s0.messages, batch[f"row_ptr_{a0}"][:-1], s0.seq, s0.dst_idx,
                batch[f"lens_{a0}"], dst_states, meta.maxlen(a0),
            )
        tables = not sharded and all(s.table is not None for s in sources)
        one_width = tables and len({int(s.table.shape[1]) for s in sources}) == 1
        if agg.kind == "interleave" and f"ilv_slice_{tag}" in batch and one_width:
            combined = torch.cat([zero_padding_rows(s) for s in sources], 0)
            xs = _slices(batch, combined, "ilv_slice", "ilv_sort", tag)
            return RNN.masked_update_stacked(spec, up, xs, sum(lens()), dst_states)
        axis = agg.concat_axis if agg.kind == "concat" else 1
        if (
            agg.kind in ("concat", "ordered")
            and tables
            and all(f"slice_src_{s.adj}" in batch for s in sources)
            and (
                one_width if axis != 2
                else len({meta.maxlen(s.adj) for s in sources}) == 1
            )
        ):
            blocks = [
                _slices(batch, zero_padding_rows(s), "slice_src", "slice_sort", s.adj)
                for s in sources
            ]
            if axis == 2:
                return RNN.masked_update_stacked(
                    spec, up, torch.cat(blocks, 2), lens()[0], dst_states
                )
            return RNN.masked_update_stacked(
                spec, up, torch.cat(blocks, 0), sum(lens()), dst_states
            )
        blocks = [
            seg.scatter_to_sequences(
                s.messages, s.dst_idx, s.seq, n_dst, meta.maxlen(s.adj), group=edge_axis
            )
            for s in sources
        ]
        if axis == 2:
            aggregated, final_len = torch.cat(blocks, 2), lens()[0]
        else:
            aggregated, final_len = torch.cat(blocks, 1), sum(lens())
            if agg.kind == "interleave":
                rows = batch[f"interleave_perm_{tag}"][batch[f"graph_id_{mp.destination}"]]
                index = rows[:, :, None].expand(-1, -1, aggregated.shape[2])
                aggregated = torch.gather(aggregated, 1, index)
        return RNN.masked_update(
            spec, up, aggregated.to(dst_states.dtype), final_len, dst_states
        )

    @staticmethod
    def _upcast(batch, key, dtype, cache):
        """An int8 incidence matrix in the compute dtype, once per batch."""
        if (key, dtype) not in cache:
            cache[(key, dtype)] = batch[key].to(dtype)
        return cache[(key, dtype)]

    def _slot_rate_sum(self, s, dst_states, states, batch, meta, n_dst):
        """A per-edge network's sum at slot rate: its slot tensor (the prefix
        where `s.post` factors the last layer out), slots past each
        destination's in-degree zeroed, summed over the slots. No per-edge
        gather and no segment sum, forward or backward (the slice gather's
        backward is kernel A). None for message tables, which the incidence
        products and CSR sums serve, and where `_slot_messages` gives none."""
        if s.table is not None:
            return None
        slots = self._slot_messages(
            s, dst_states, states, batch, meta, n_dst, want_prefix=s.post is not None,
            enabled=_SLOT_SUM,
        )
        if slots is None:
            return None
        t = torch.arange(slots.shape[0], device=slots.device)
        valid = t[:, None] < batch[f"lens_{s.adj}"][None, :]
        return torch.sum(slots * valid[:, :, None].to(slots.dtype), dim=0)

    @staticmethod
    def _finish(part, s, batch, n_dst, edge_axis=None):
        """A factored last Dense layer applied to a source's sum at node rate:
        sum_e (g_e @ K + b) = (sum_e g_e) @ K + deg * b."""
        if s.post is None:
            return part
        kernel, bias = s.post
        out = part.to(kernel.dtype) @ kernel
        if bias is not None:
            deg = batch.get(f"lens_{s.adj}")
            if deg is None:
                deg = seg.segment_count(s.dst_idx, n_dst, s.mask, group=edge_axis)
            out = out + deg.to(out.dtype)[:, None] * bias
        return out

    def _one_source_sum(self, s, dst_states, states, batch, meta, n_dst, cache):
        """Best available sum lowering for one destination-sorted source, in
        the JAX package's order: a per-edge network's slot-rate sum; for a
        message table the block-diagonal matmul > the dense-incidence matmul
        > the CSR sums (kernel A); else, and last, the sorted sum of the edge
        messages (kernel A with row pointers)."""
        slots = self._slot_rate_sum(s, dst_states, states, batch, meta, n_dst)
        if slots is not None:
            return slots
        a, table = s.adj, s.table
        row_ptr = batch.get(f"row_ptr_{a}")
        if table is not None:
            if f"inc_blocks_{a}" in batch:
                blocks = self._upcast(batch, f"inc_blocks_{a}", table.dtype, cache)
                return seg.direct_segment_sum_blocks(table, blocks, n_dst)
            if f"dense_inc_{a}" in batch:
                inc = self._upcast(batch, f"dense_inc_{a}", table.dtype, cache)
                return seg.direct_segment_sum_dense(table, inc)
            if row_ptr is not None and f"bwd_slice_dst_{a}" in batch:
                return seg.direct_segment_sum_sliced(
                    table, batch[f"src_{a}"], row_ptr, n_dst,
                    batch[f"bwd_slice_dst_{a}"], batch[f"out_lens_{a}"],
                )
            if row_ptr is not None and f"dst_in_src_order_{a}" in batch:
                return seg.direct_segment_sum(
                    table, batch[f"src_{a}"], row_ptr, n_dst,
                    batch[f"dst_in_src_order_{a}"], batch[f"src_row_ptr_{a}"],
                )
        return seg.segment_sum(
            s.messages, s.dst_idx, n_dst, row_ptr=row_ptr, indices_are_sorted=True
        )

    def _attention_aggregate(self, ap, mp, sources, dst_states, states, batch, meta, n_dst,
                             edge_axis=None, node_axis=None):
        """GAT attention by the best lowering the batch and the messages
        allow, in the JAX package's order, in the `per_destination` mode
        over one source: at slot rate (`_slot_attention`, under `_SLOT_ATTN`)
        for a per-edge network and for a message table without an incidence
        matrix; block-diagonal attention > dense attention over the
        incidence matrix for a message table (both kernels D and E; the int8
        matrix goes in as it is); else, and always in the `reference` mode
        or over several sources, the per-edge form (`_attention`). Under
        `edge_axis` always the per-edge form; under `node_axis` the local
        batch has neither slice map nor incidence."""
        s = sources[0]
        a, table = s.adj, s.table
        reference = mp.aggregation.attention_softmax == "reference"
        one = len(sources) == 1 and not reference and edge_axis is None
        incidence = f"inc_blocks_{a}" in batch or f"dense_inc_{a}" in batch
        if one and node_axis is None and _SLOT_ATTN and not (table is not None and incidence):
            out = self._slot_attention(ap, s, dst_states, states, batch, meta, n_dst)
            if out is not None:
                return out
        if one and table is not None:
            if f"inc_blocks_{a}" in batch:
                return seg.dense_attention_aggregate_blocks(
                    table, dst_states, batch[f"inc_blocks_{a}"],
                    ap["kernel1"], ap["kernel2"], ap["attn_kernel"], n_dst,
                )
            if f"dense_inc_{a}" in batch:
                return seg.dense_attention_aggregate(
                    table, dst_states, batch[f"dense_inc_{a}"],
                    ap["kernel1"], ap["kernel2"], ap["attn_kernel"],
                )
        return self._attention(ap, mp, sources, dst_states, batch, meta, n_dst, edge_axis,
                               node_axis)

    def _slot_attention(self, ap, s, dst_states, states, batch, meta, n_dst):
        """Per-destination GAT at slot rate (the JAX `_slot_attention`) over
        the [L, n_dst] slot tensor of the source's slice map
        (`_slot_messages`: a message table's slices or a per-edge network's
        slot tensor): scores[t, d] = LeakyReLU(a1 . (K1 m[t, d]) + a2 . (K2
        h_d)), a softmax over each destination's slots t < in-degree with
        its statistics in f32, out[d] = sum_t w[t, d] m[t, d]. No per-edge
        gather, no segment sum and no incidence matrix, forward or
        backward; the slice gather's backward is kernel A. A slot past the
        in-degree holds finite values and gets weight 0: its score is
        masked before `exp` sees it, and the max of a destination without
        messages is taken as 0 (its row comes out zero), so no gradient
        meets an infinity. The max is detached: the softmax does not depend
        on it. Nothing is read back to the host. None where the slot tensor
        is not allowed."""
        slots = self._slot_messages(s, dst_states, states, batch, meta, n_dst)
        if slots is None:
            return None
        length, n, dm = slots.shape
        d1 = ap["kernel1"].shape[1]
        s_src = ((slots.reshape(length * n, dm) @ ap["kernel1"]) @ ap["attn_kernel"][:d1])
        s_dst = (dst_states @ ap["kernel2"]) @ ap["attn_kernel"][d1:]
        scores = F.leaky_relu(s_src.reshape(length, n) + s_dst.reshape(1, n), 0.2)
        t = torch.arange(length, device=slots.device)
        valid = t[:, None] < batch[f"lens_{s.adj}"][None, :]
        sf = scores.to(torch.float32)
        mx = torch.where(valid, sf, torch.full_like(sf, float("-inf"))).amax(dim=0).detach()
        mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        zero = torch.zeros_like(sf)
        ex = torch.where(valid, torch.exp(torch.where(valid, sf - mx, zero)), zero)
        den = ex.sum(dim=0)
        w = (ex / torch.where(den > 0, den, torch.ones_like(den))).to(slots.dtype)
        return torch.einsum("ln,lnd->nd", w, slots)

    def _attention(self, ap, mp, sources, dst_states, batch, meta, n_dst, edge_axis=None,
                   node_axis=None):
        """Per-edge GAT attention (the JAX `_attention`) over the sources'
        edges, concatenated when there are several. Scores decompose into a
        per-edge source scalar and a per-node destination scalar gathered
        per edge: for one sorted source with row pointers 8 lanes wide, as
        in the JAX package (`seg.gather_by_dst`'s transpose is kernel A),
        else by plain indexing. Then, by softmax mode:
          * `per_destination` with row pointers: the fused
            `seg.sorted_softmax_aggregate` (kernel A);
          * `per_destination` otherwise: `seg.segment_softmax` weights;
          * `reference`: `_reference_weights`;
        and the weighted messages summed per destination: kernel A for one
        source with row pointers, else the library's unsorted sum (the JAX
        package's XLA sum, in the input dtype). Under `edge_axis` the row
        pointers are off: one sorted source's sum is the id-keyed kernel
        over this rank's block, the softmax's max and denominator and the
        sum are all-reduced."""
        single = len(sources) == 1
        s0 = sources[0]
        sorted_single = single and f"row_ptr_{s0.adj}" in batch
        row_ptr = batch[f"row_ptr_{s0.adj}"] if sorted_single and edge_axis is None else None
        if single:
            messages, dst_idx, mask = s0.messages, s0.dst_idx, s0.mask
        else:
            messages = torch.cat([s.messages for s in sources], 0)
            dst_idx = torch.cat([s.dst_idx for s in sources], 0)
            mask = torch.cat([s.mask for s in sources], 0)
        d1 = ap["kernel1"].shape[1]
        s_src = ((messages @ ap["kernel1"]) @ ap["attn_kernel"][:d1]).reshape(-1)
        s_dst_node = (dst_states @ ap["kernel2"]) @ ap["attn_kernel"][d1:]
        if row_ptr is not None:
            s_dst8 = s_dst_node.expand(s_dst_node.shape[0], 8)
            s_dst = seg.gather_by_dst(s_dst8, dst_idx, row_ptr)[:, 0]
        else:
            s_dst = s_dst_node[dst_idx, 0]
        scores = F.leaky_relu(s_src + s_dst, 0.2)
        if mp.aggregation.attention_softmax == "reference":
            weights = self._reference_weights(
                scores, sources, dst_idx, mask, batch, meta, mp.destination, n_dst, edge_axis,
                node_axis,
            )
        elif row_ptr is not None:
            return seg.sorted_softmax_aggregate(messages, scores, dst_idx, n_dst, mask, row_ptr)
        else:
            weights = seg.segment_softmax(scores, dst_idx, n_dst, mask, group=edge_axis)
        return seg.segment_sum(
            messages * weights[:, None], dst_idx, n_dst, row_ptr=row_ptr,
            indices_are_sorted=sorted_single, group=edge_axis,
        )

    @staticmethod
    def _reference_weights(scores, sources, dst_idx, mask, batch, meta, dst, n_dst,
                           edge_axis=None, node_axis=None):
        """The `reference` softmax (the reference's axis-0 softmax of its
        scattered [n_dst, max_len, 1] scores, per graph): the masked scores
        scattered into each destination's sequence slots (a source's slots
        follow the earlier sources' real messages), a softmax over the
        destination axis per graph and slot, empty slots counting as exp(0)
        and padding destinations excluded, and each edge's coefficient
        picked back. The per-graph max is detached: the softmax does not
        depend on it. Under `edge_axis` the scattered scores are all-reduced
        (each rank's slots are its own edges'). Under `node_axis` a graph's
        destinations may lie on several ranks: its max (detached) and its
        denominator combine over the group."""
        lens = _lens(sources, batch, n_dst, edge_axis)
        seqs = []
        offset = torch.zeros(n_dst, dtype=torch.float32, device=scores.device)
        for s, l in zip(sources, lens):
            seqs.append(s.seq + offset[s.dst_idx].to(s.seq.dtype))
            offset = offset + l
        seq = torch.cat(seqs, 0).to(torch.int64)
        max_len = sum(meta.maxlen(s.adj) for s in sources)
        scattered = seg.scatter_to_sequences(
            (scores * mask)[:, None], dst_idx, seq, n_dst, max_len, group=edge_axis
        )[:, :, 0]
        real = (batch[f"node_mask_{dst}"] > 0)[:, None]
        graph_id = batch[f"graph_id_{dst}"]
        ng = meta.num_graphs
        gmax = pmax(seg.segment_max(
            torch.where(real, scattered, torch.full_like(scattered, -1e30)).detach(),
            graph_id, ng,
        ), node_axis)
        ex = torch.exp(scattered - gmax[graph_id]) * real
        den = psum(seg.segment_sum(ex, graph_id, ng), node_axis)
        coeff = ex / torch.where(den > 0, den, torch.ones_like(den))[graph_id]
        picked = coeff.reshape(n_dst * max_len)[dst_idx.to(torch.int64) * max_len + seq]
        return picked * mask

    def _convolution(self, cp, agg, sources, dst_states, batch, n_dst, cache, edge_axis=None):
        """GCN-style aggregation (the JAX package's, lowerings in its order):
        the sum of each destination's messages times the pass's kernel, by
        the block-diagonal > dense incidence product of the message table @
        kernel (one source); else the sorted sum of the per-edge messages
        @ kernel (one source: kernel A with row pointers; several sources:
        their edges concatenated, an unsorted sum). Then the destination's
        own state is added, the total divided by max(in-degree, 1), and the
        aggregation's activation applied. The products return the compute
        dtype and kernel A f32; the sum with the states promotes, as in the
        JAX package, and the caller casts the result back. Under `edge_axis`
        the incidence products and the row pointers are off and the sums
        all-reduced."""
        kernel = cp["kernel"]
        s = sources[0]
        table_ok = len(sources) == 1 and s.table is not None and edge_axis is None
        if table_ok and f"inc_blocks_{s.adj}" in batch:
            table = s.table @ kernel
            blocks = self._upcast(batch, f"inc_blocks_{s.adj}", table.dtype, cache)
            nsum = seg.direct_segment_sum_blocks(table, blocks, n_dst)
        elif table_ok and f"dense_inc_{s.adj}" in batch:
            table = s.table @ kernel
            inc = self._upcast(batch, f"dense_inc_{s.adj}", table.dtype, cache)
            nsum = seg.direct_segment_sum_dense(table, inc)
        elif len(sources) == 1:
            nsum = seg.segment_sum(
                s.messages @ kernel, s.dst_idx, n_dst,
                row_ptr=batch.get(f"row_ptr_{s.adj}") if edge_axis is None else None,
                indices_are_sorted=True, group=edge_axis,
            )
        else:
            messages = torch.cat([t.messages for t in sources], 0)
            dst_idx = torch.cat([t.dst_idx for t in sources], 0)
            nsum = seg.segment_sum(messages @ kernel, dst_idx, n_dst, group=edge_axis)
        deg = sum(_lens(sources, batch, n_dst, edge_axis))
        total = nsum + dst_states
        normalized = total / torch.clamp_min(deg.to(torch.float32), 1.0)[:, None]
        return activation(agg.activation)(normalized)

    def _readout(self, params, batch, meta, states, training, generator, edge_axis=None,
                 node_axis=None):
        """The readout pipeline (the JAX `_readout`). Intermediates live in
        `ro`, each tagged with its domain (`infer_readout_domains`), so that
        a graph-level tensor broadcasts onto entity rows where it meets one.
        Its networks draw from `generator` in training. Returns the predict
        op's output."""
        ro: Dict[str, torch.Tensor] = {}

        def domain_of(name):
            return self.domains.get(name, ("entity", name))

        def fetch(name):
            if name in ro:
                return ro[name]
            if name in states:
                return states[name]
            if name in batch:
                v = batch[name].to(torch.float32)
                return v if v.dim() > 1 else v[:, None]
            raise BuildError(f"readout input '{name}' is not available")

        def broadcast_to(x, from_dom, to_dom):
            if from_dom == to_dom or from_dom[0] != "graph" or to_dom[0] != "entity":
                return x
            return x[batch[f"graph_id_{to_dom[1]}"]]

        result = None
        for i, op in enumerate(self.ir.readout):
            if op.kind in ("predict", "neural_network"):
                doms = [domain_of(name) for name in op.inputs]
                target = next((d for d in doms if d[0] != "graph"), doms[0])
                xs = [broadcast_to(fetch(n), d, target) for n, d in zip(op.inputs, doms)]
                # concatenating bf16 states with f32 features promotes to f32
                x = torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]
                out = MLP.apply(
                    op.mlp, params["readout"][f"op{i}"], x,
                    deterministic=not training, generator=generator,
                )
                if op.kind == "predict":
                    result = out[:, 0] if out.shape[-1] == 1 else out
                else:
                    ro[op.output_name] = out
            elif op.kind == "pooling":
                name = op.inputs[0]
                dom = domain_of(name)
                if dom[0] != "entity":
                    raise BuildError(
                        f"pooling over domain {dom} is not supported (input '{name}')"
                    )
                ro[op.output_name] = seg.graph_pool(
                    fetch(name), batch[f"graph_id_{dom[1]}"], meta.num_graphs,
                    batch[f"node_mask_{dom[1]}"], op.pooling, group=node_axis,
                )
            elif op.kind == "product":
                d1, d2 = domain_of(op.inputs[0]), domain_of(op.inputs[1])
                target = d1 if d1[0] != "graph" else d2
                x1 = broadcast_to(fetch(op.inputs[0]), d1, target)
                x2 = broadcast_to(fetch(op.inputs[1]), d2, target)
                if op.product == "dot_product":
                    # the row-wise dot product: the reference's recorded
                    # width 1, as in the JAX package
                    ro[op.output_name] = torch.sum(x1 * x2, dim=-1, keepdim=True)
                else:
                    ro[op.output_name] = x1 * x2
            elif op.kind == "extend_adjacencies":
                # each edge's source and destination rows; both backwards are
                # kernel A over real edges only (a padding edge's cotangent is
                # zero under the masked loss), where the JAX package's plain
                # indexing also sums the padding edges' zeros; under
                # `edge_axis` plain indexing of this rank's edges, as there;
                # under `node_axis` the final states go through one more halo
                a = op.adj_name
                if node_axis is not None:
                    table = _halo_src_table(batch, a, fetch(op.inputs[0]), node_axis)
                    ro[op.output_names[0]] = table[batch[f"src_{a}"]]
                else:
                    ro[op.output_names[0]] = _gather_src(batch, a, fetch(op.inputs[0]),
                                                         edge_axis)
                ro[op.output_names[1]] = _gather_dst(batch, a, fetch(op.inputs[1]), edge_axis)
        return result


def build(model_ir) -> GnnModel:
    return GnnModel(model_ir)
