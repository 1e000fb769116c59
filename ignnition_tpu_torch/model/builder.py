"""Compiler back-end for the ported slices: ModelIR -> `GnnModel`
(counterpart of `ignnition_tpu/model/builder.py`), serving and training.

Ported: the flagship RouteNet path and its attention family. Each message
passing has one source with direct-assignation messages and a recurrent
update; its aggregation is one of
  * `ordered`: the time slices are gathered from the source state table
    through the host slice map (`seg.gather_state_slices`) and run through
    the masked scan (`RNN.masked_update_stacked`, kernels B and C for GRU);
  * `sum`: the best of the block-diagonal / dense incidence products and
    the CSR sums (`_one_source_sum`, kernel A), then one cell step;
  * `attention` (per-destination GAT softmax): block-diagonal or dense
    attention over the int8 incidence matrix (kernels D and E), else the
    per-edge form over the sorted edge list (`_attention`, kernel A), then
    one cell step.
The readout is `predict` through a Dense feed-forward network. Any other
DSL feature raises NotImplementedError naming it, when the model is built.

`apply(params, batch, meta)` is a function of a parameter tree, which the
trainer differentiates (its leaves require grad; the batch's training
companions route each backward through the hand-written transposes of
`ops/segment.py`). `forward(batch, meta)` applies the module's own
parameters, which never require grad: serving records no graph.

Parameters keep the JAX package's tree and keys letter for letter
(`update` -> `{dst}_update` -> `kernel`, `aggregation` -> `s{si}/m{mi}` ->
`kernel1`, `readout` -> `op{i}` -> `layers` -> j -> `kernel`; a key may hold
a `/`), so `params_from_jax` moves a JAX tree across unchanged, and every
rebuild of a tree keeps its structure (`map_params`, `with_leaves`). The
module registers the leaves flat under `flatten_params`' names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.graph import BatchMeta
from ..nn import mlp as MLP
from ..nn import rnn as RNN
from ..nn.layers import glorot_uniform
from ..ops import segment as seg


class BuildError(ValueError):
    pass


def _unported(feature: str) -> NotImplementedError:
    return NotImplementedError(f"{feature} is not ported to ignnition_tpu_torch yet")


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
        self._check_supported()
        self._structure: Dict[str, Any] = {}
        self.params = nn.ParameterDict()

    def _check_supported(self) -> None:
        ir = self.ir
        for stage in ir.stages:
            for mp in stage.passes:
                if len(mp.sources) != 1:
                    raise _unported(
                        f"multi-source message passing (destination '{mp.destination}')"
                    )
                if any(op.kind != "direct" for op in mp.sources[0].ops):
                    raise _unported(
                        "message neural networks (a message other than "
                        "direct_assignation)"
                    )
                if mp.aggregation.kind not in ("ordered", "sum", "attention"):
                    raise _unported(f"the '{mp.aggregation.kind}' aggregation")
                if (
                    mp.aggregation.kind == "attention"
                    and mp.aggregation.attention_softmax != "per_destination"
                ):
                    raise _unported(
                        f"the '{mp.aggregation.attention_softmax}' attention softmax "
                        f"mode (attention_softmax; only per_destination is ported)"
                    )
                if mp.update.kind != "recurrent":
                    raise _unported("feed-forward (neural network) updates")
        entity_names = set(ir.entity_names)
        for op in ir.readout:
            if op.kind != "predict":
                raise _unported(f"the '{op.kind}' readout")
            for name in op.inputs:
                if name not in entity_names:
                    raise _unported(
                        f"readout input '{name}' (only entity states are ported)"
                    )

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------

    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Draw parameters from `generator` in the JAX package's tree, load
        them into the module (on the CPU) and return the tree."""
        ir = self.ir
        params: Dict[str, Any] = {"message": {}, "aggregation": {}, "update": {}, "readout": {}}
        upd_in_dims: Dict[str, int] = {}
        for si, stage in enumerate(ir.stages):
            for mi, mp in enumerate(stage.passes):
                agg_dim = self.state_dims[mp.sources[0].entity]  # direct messages
                dst_dim = self.state_dims[mp.destination]
                if mp.aggregation.kind == "attention":
                    # drawn before the pass's update, as in the JAX package
                    params["aggregation"][f"s{si}/m{mi}"] = {
                        "kernel1": glorot_uniform(generator, (agg_dim, agg_dim)),
                        "kernel2": glorot_uniform(generator, (dst_dim, agg_dim)),
                        "attn_kernel": glorot_uniform(generator, (2 * agg_dim, 1)),
                    }
                key = f"{mp.destination}_update"
                if key not in params["update"]:
                    params["update"][key] = RNN.init(
                        generator, mp.update.rnn, in_dim=agg_dim, units=dst_dim
                    )
                    upd_in_dims[key] = agg_dim
                if upd_in_dims[key] != agg_dim:
                    raise BuildError(
                        f"the message passings updating '{mp.destination}' "
                        f"aggregate to different dimensionalities "
                        f"({upd_in_dims[key]} vs {agg_dim}); the destination's "
                        f"update model is shared"
                    )
        for i, op in enumerate(ir.readout):
            in_dim = sum(self.state_dims[name] for name in op.inputs)
            params["readout"][f"op{i}"], _ = MLP.init(generator, op.mlp, in_dim)
        self.load_params(params)
        return params

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
        """Sum of all layers' l2 kernel penalties over a parameter tree (the
        readout networks: message and feed-forward update networks are not
        ported)."""
        total = None
        for i, op in enumerate(self.ir.readout):
            part = MLP.l2_loss(op.mlp, params["readout"][f"op{i}"])
            total = part if total is None else total + part
        return total

    def forward(
        self,
        batch: Mapping[str, torch.Tensor],
        meta: BatchMeta,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """`apply` with the module's own parameters."""
        return self.apply(self.param_tree(), batch, meta, compute_dtype=compute_dtype)

    def apply(
        self,
        params,
        batch: Mapping[str, torch.Tensor],
        meta: BatchMeta,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """Predictions [rows] (last dim squeezed when 1), float32, from the
        parameter tree `params` (JAX layout, float32 tensors).

        compute_dtype (e.g. torch.bfloat16): parameters and hidden states are
        cast to it with explicit casts, as the JAX `apply(compute_dtype=)`
        does, so gradients arrive in float32 on the tree's leaves;
        predictions come back as float32."""
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
        for _ in range(ir.num_iterations):
            states = self._message_passing_iteration(params, batch, meta, states, cache)

        preds = self._readout(params, states)
        if compute_dtype is not None:
            preds = preds.to(torch.float32)
        return preds

    def _message_passing_iteration(self, params, batch, meta, states, cache):
        new_states = dict(states)
        for si, stage in enumerate(self.ir.stages):
            for mi, mp in enumerate(stage.passes):
                dst = mp.destination
                dst_states = new_states[dst]
                src = mp.sources[0]
                a = src.adj_name
                # direct assignation: the message table is the source state
                table = new_states[src.entity]
                up = params["update"][f"{dst}_update"]
                if mp.aggregation.kind == "ordered":
                    if f"row_ptr_{a}" not in batch or f"slice_src_{a}" not in batch:
                        raise _unported(
                            "the ordered update without the host slice map "
                            "(masked_update_from_edges)"
                        )
                    xs = seg.gather_state_slices(
                        table,
                        batch[f"slice_src_{a}"],
                        batch.get(f"slice_sort_perm_{a}"),
                        batch.get(f"slice_sort_ids_{a}"),
                        batch.get(f"slice_sort_row_ptr_{a}"),
                    )
                    new_state = RNN.masked_update_stacked(
                        mp.update.rnn, up, xs, batch[f"lens_{a}"], dst_states
                    )
                else:
                    if mp.aggregation.kind == "sum":
                        part = self._one_source_sum(
                            table, batch, meta, a, meta.nodes(dst), cache
                        )
                    else:
                        part = self._attention_aggregate(
                            params["aggregation"][f"s{si}/m{mi}"], table, dst_states,
                            batch, a, meta.nodes(dst),
                        )
                    # the sorted sums return f32 (the kernel's accumulator)
                    aggregated = part.to(dst_states.dtype)
                    new_state = RNN.cell_step(mp.update.rnn, up, aggregated, dst_states)
                node_mask = batch[f"node_mask_{dst}"]
                new_states[dst] = new_state * node_mask[:, None].to(new_state.dtype)
        return new_states

    @staticmethod
    def _upcast(batch, key, dtype, cache):
        """An int8 incidence matrix in the compute dtype, once per batch."""
        if (key, dtype) not in cache:
            cache[(key, dtype)] = batch[key].to(dtype)
        return cache[(key, dtype)]

    def _one_source_sum(self, table, batch, meta, a, n_dst, cache):
        """Best available sum lowering for one destination-sorted source, in
        the JAX package's order: block-diagonal matmul > dense-incidence
        matmul > gather + CSR sum (kernel A) > sum of masked edge messages."""
        if f"inc_blocks_{a}" in batch:
            blocks = self._upcast(batch, f"inc_blocks_{a}", table.dtype, cache)
            return seg.direct_segment_sum_blocks(table, blocks, n_dst)
        if f"dense_inc_{a}" in batch:
            inc = self._upcast(batch, f"dense_inc_{a}", table.dtype, cache)
            return seg.direct_segment_sum_dense(table, inc)
        row_ptr = batch.get(f"row_ptr_{a}")
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
        messages = table[batch[f"src_{a}"]]
        messages = messages * batch[f"edge_mask_{a}"][:, None].to(messages.dtype)
        return seg.segment_sum(messages, batch[f"dst_{a}"], n_dst, row_ptr=row_ptr)

    def _attention_aggregate(self, ap, table, dst_states, batch, a, n_dst):
        """Per-destination GAT attention over one destination-sorted source
        with direct messages, by the best lowering the batch allows:
        block-diagonal attention > dense attention over the incidence matrix
        (both kernels D and E; the int8 matrix goes in as it is) > per-edge
        attention (`_attention`, kernel A). The JAX package's slot-rate
        lowering (`_slot_attention`), which it would try first where there
        is no incidence matrix, is not ported: the per-edge form computes
        the same function."""
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
        return self._attention(ap, table, dst_states, batch, a, n_dst)

    def _attention(self, ap, table, dst_states, batch, a, n_dst):
        """Per-edge GAT attention in the `per_destination` mode over a sorted
        edge list: scores decompose into a per-edge source scalar and a
        per-node destination scalar gathered per edge (8 lanes wide, as in
        the JAX package; `seg.gather_by_dst`'s transpose is kernel A), then
        the fused `seg.sorted_softmax_aggregate`."""
        row_ptr = batch.get(f"row_ptr_{a}")
        if row_ptr is None:
            raise _unported(
                "per-edge attention without CSR row pointers (segment_softmax)"
            )
        dst_idx, mask = batch[f"dst_{a}"], batch[f"edge_mask_{a}"]
        messages = table[batch[f"src_{a}"]]
        messages = messages * mask[:, None].to(messages.dtype)  # zero padding edges
        d1 = ap["kernel1"].shape[1]
        s_src = ((messages @ ap["kernel1"]) @ ap["attn_kernel"][:d1]).reshape(-1)
        s_dst_node = (dst_states @ ap["kernel2"]) @ ap["attn_kernel"][d1:]
        s_dst8 = s_dst_node.expand(s_dst_node.shape[0], 8)
        s_dst = seg.gather_by_dst(s_dst8, dst_idx, row_ptr)[:, 0]
        scores = F.leaky_relu(s_src + s_dst, 0.2)
        return seg.sorted_softmax_aggregate(messages, scores, dst_idx, n_dst, mask, row_ptr)

    def _readout(self, params, states):
        """The predict op over the final entity states."""
        result = None
        for i, op in enumerate(self.ir.readout):
            xs = [states[name] for name in op.inputs]
            x = torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]
            out = MLP.apply(op.mlp, params["readout"][f"op{i}"], x)
            result = out[:, 0] if out.shape[-1] == 1 else out
        return result


def build(model_ir) -> GnnModel:
    return GnnModel(model_ir)
