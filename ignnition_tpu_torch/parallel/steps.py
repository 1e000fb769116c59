"""Batch stacking and the data- and edge-parallel steps over a ('data',
'model') mesh (counterpart of `ignnition_tpu/parallel/steps.py`;
`edge_array_keys` and `stack_batches` are a copy, numpy over the port's own
`merge_metas` / `repad_to_meta`).

Two strategies compose on the mesh of `parallel/mesh.py`:

  * **graph-batch data parallelism** ('data' axis): the step takes the
    stacked batch (one merged, identically padded batch per data row, on a
    leading axis) and each rank runs the full model on its row;
  * **edge-partitioned model parallelism** ('model' axis, v1 "replicated"):
    each adjacency's edge arrays are split into contiguous blocks over the
    ranks of a data row while node tables stay replicated, and every
    aggregation all-reduces its partial over the row (`GnnModel.apply`'s
    `edge_axis`).

A rank's inputs are the block that the JAX package's shard_map gives the
same device under `batch_partition_specs`: its data row, and its block of
every edge array (the labels too, for edge-domain models).

Gradients, exactly the JAX step's: every rank scales its loss by
1/(n_data * n_model) (1/n_model for sum-reduction losses) and the L2 term
by 1/(n_data * n_model); each all-reduce inside the model sums its
cotangent in the backward (`ops/_collectives.psum`); one all-reduce over
the mesh then sums every parameter gradient, and with it the loss that
the step reports. Every rank applies the same update to its replica.

Compiled steps: the JAX package jits each sharded function it builds, and
here each is a `ShardedStep` whose calls go through the owner's
`training.capture.Graphs`, one CUDA graph per key: the train steps' keys
are `_shape_key` plus the meta (and the generator), the forwards'
`_shape_key` plus the meta. The Python checks and the numpy slicing of the
rank's part run on the host before the graph, as the JAX package's Python
runs before its jitted call; the graph holds the forward, the loss and its
collectives, the backward, the flat gradient all-reduce and the update.
Whether a step captures is decided once, when it is built, from the
mesh's backend: NCCL captures; gloo stages every collective through the
host, which a graph cannot hold, so a gloo mesh steps eagerly, as the CPU
always does; so does every step while the pallas kernel switch is 'never'
(`training.capture`). `captured` and `why_eager` say which and why.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..batch import resolve_device, to_device
from ..data.graph import BatchMeta, infer_label_domain, merge_metas, repad_to_meta
from ..model.builder import GnnModel, flatten_params, with_leaves
from ..ops._collectives import all_gather, psum
from ..training.capture import Graphs, kernel_modes_why_eager
from ..training.losses import loss_reduction
from ..utils.trace import span
from .mesh import Mesh


# the profiler's name for a step's gradient all-reduce, a span of
# `utils.trace` (the model axis's all-reduces show as `_AllReduceSum` and
# `_AllReduceSumBackward`)
GRADIENT_ALL_REDUCE = "parallel.all_reduce_gradients"


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


# --------------------------------------------------------------------------
# sharded steps
# --------------------------------------------------------------------------


def batch_partition_specs(
    model_ir,
    sample_batch: Dict[str, Any],
    data_axis: Optional[str] = "data",
    model_axis: Optional[str] = "model",
) -> Dict[str, Tuple[Optional[str], ...]]:
    """The mesh axis of each dimension of each stacked batch array (the JAX
    package's PartitionSpec, as a tuple): the leading stacked axis ->
    data_axis; edge arrays additionally split their edge dimension over
    model_axis. Labels of edge-domain models (readouts through
    extend_adjacencies) lie on the edge axis too, so they split with it."""
    ekeys = set(edge_array_keys(model_ir))
    if infer_label_domain(model_ir)[0] == "edge":
        ekeys.update(("label", "label_mask", "label_perm"))
    specs = {}
    for k, v in sample_batch.items():
        dims: List[Optional[str]] = [data_axis]
        if k in ekeys:
            dims.append(model_axis)
        nd = np.ndim(v)
        while len(dims) < nd:
            dims.append(None)
        specs[k] = tuple(dims[:nd])
    return specs


def _model_axis(mesh: Mesh, model_axis: Optional[str]) -> Optional[str]:
    return model_axis if (model_axis and mesh.shape.get(model_axis, 1) > 1) else None


def _shape_key(stacked: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, tuple(np.shape(v))) for k, v in stacked.items()))


def _local_batch(stacked: Dict[str, Any], specs, mesh: Mesh, device) -> Dict[str, torch.Tensor]:
    """This rank's part of a stacked batch on `device`: its data row of
    every array and, where the spec names the model axis, its contiguous
    block of the edge dimension. An edge count that does not divide by the
    model axis raises, as the JAX package's sharding does."""
    d, m = mesh.require_member()
    n_model = mesh.shape["model"]
    out = {}
    for k, v in stacked.items():
        if np.shape(v)[0] != mesh.shape["data"]:
            raise ValueError(
                f"stacked batch array '{k}' has {np.shape(v)[0]} rows on its leading "
                f"axis; the mesh's data axis is {mesh.shape['data']}"
            )
        x = v[d]
        if len(specs[k]) > 1 and specs[k][1] is not None:
            e = np.shape(x)[0]
            if e % n_model:
                raise ValueError(
                    f"'{k}' has {e} padded edges, which do not divide into "
                    f"{n_model} blocks of the mesh's model axis (pad edges to a "
                    f"multiple of it: PaddingConfig(mode='multiple'))"
                )
            b = e // n_model
            x = x[m * b:(m + 1) * b]
        out[k] = x
    return to_device(out, device)


def _check_agreement(key, mesh: Mesh) -> None:
    """Raise on every rank unless all ranks of the mesh step with the same
    batch shapes: a rank whose padded meta differs would issue other
    collectives than the rest, and the mesh would hang."""
    keys = [None] * mesh.size
    dist.all_gather_object(keys, repr(key), group=mesh.group)
    if len(set(keys)) != 1:
        raise ValueError(
            "the ranks of the mesh hold batches of different padded shapes "
            f"(rank {dist.get_rank()} of {len(set(keys))} distinct shapes): every "
            "rank must step with the same BatchMeta (a fixed padding bucket, "
            "PaddingConfig(mode='multiple', min_size=...), and the same stream)"
        )


def _why_eager(mesh: Mesh, graphs: Graphs) -> Optional[str]:
    """Why a sharded step over `mesh` cannot be captured into CUDA graphs,
    or None when it can: on the card, every process group of the mesh over
    NCCL."""
    if not graphs.on_card:
        return f"it runs on {graphs.device.type}, where every step runs eagerly"
    if mesh.coords is None:
        return "this rank lies outside the mesh"
    groups = (mesh.group, mesh.model_group, mesh.data_group)
    backends = sorted({str(dist.get_backend(g)) for g in groups})
    if backends != ["nccl"]:
        return (f"the mesh's collectives run over {' and '.join(backends)}, which stages "
                "them through the host: a CUDA graph cannot hold them")
    return None


class ShardedStep:
    """A sharded step or forward over a mesh (what a factory of this module
    or of `parallel.edgeshard` returns): calling it runs the step. Each key
    goes through `graphs` (the owner's, or one of its own) as a captured
    step (`training.capture`): on the card over NCCL a key's first call is
    the warm-up, which reaches every collective of the step on the capture's
    stream (NCCL builds a communicator at its first collective, which no
    capture may hold), its second captures and replays, later calls replay.
    `call`: what calling it runs, the factory's function, which steps
    through `run`. `why_eager`: why its calls do not go through CUDA graphs
    (a gloo mesh, the CPU, the pallas switch at 'never'), None when they do
    (`captured`); `last`: the
    captured step of the latest call (`.last` says how that call ran)."""

    def __init__(self, what: str, mesh: Mesh, device, graphs: Optional[Graphs],
                 call: Callable):
        self.what = what
        self.graphs = graphs if graphs is not None else Graphs(device)
        self._why_eager = _why_eager(mesh, self.graphs)
        self.last = None
        self._call = call

    @property
    def why_eager(self) -> Optional[str]:
        """The mesh's reason, else the kernel switches' (as a captured
        step's `why_eager`)."""
        return self._why_eager or kernel_modes_why_eager()

    @property
    def captured(self) -> bool:
        return self.why_eager is None

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)

    def run(self, key, fn: Callable, bound, inputs: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None):
        """`fn(generator, bound, inputs)` through the captured step of
        `key`, made at the key's first call. fn's outputs carry no autograd
        graph: with torch 2.11 and NCCL 2.28 a warm-up's output attached to a
        graph through an `all_to_all`, kept past the call, fails the capture
        of the next (the steps here return detached tensors)."""
        self.graphs.register(generator)
        self.last = self.graphs.step(functools.partial(fn, generator), key, self.what,
                                     owner=self, why_eager=self._why_eager)
        return self.last(bound, inputs)


def make_parallel_train_step(
    model: GnnModel,
    optimizer,
    loss_fn: Callable,
    meta: BatchMeta,
    mesh: Mesh,
    data_axis: str = "data",
    model_axis: Optional[str] = "model",
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    graphs: Optional[Graphs] = None,
) -> ShardedStep:
    """`train_step(params, opt_state, stacked_batch, generator=None) ->
    (params, opt_state, loss)` over `mesh`.

    `stacked_batch` is the whole stacked batch (numpy arrays or host
    tensors, leading dimension = the data axis), the same on every rank of
    the mesh; each rank copies its part to `device` (by default the current
    CUDA device) and runs the full model on it with the model axis's
    collectives inside each aggregation. `params` (leaves that require
    grad) and `opt_state` are each rank's replica and are updated in place;
    the returned loss is the mean over the data rows (the sum for
    sum-reduction losses), the same on every rank. `generator` feeds the
    readout's random layers: each rank passes its own, seeded alike and
    advanced in step, so that the replicas draw one mask (the JAX package's
    one replicated key). The L2 term is not in the loss, as in the JAX
    step. compute_dtype: as `GnnModel.apply`'s (the JAX step takes none).
    graphs: the owner's `training.capture.Graphs` (a `Trainer`'s), whose
    pool, side stream and registered generators the step's CUDA graphs
    share; by default one of its own. A `ShardedStep`: one CUDA graph per
    batch shape on an NCCL mesh, eager on gloo and on the CPU."""
    device = resolve_device(device)
    n_data = mesh.shape[data_axis]
    n_model = mesh.shape.get(model_axis, 1) if model_axis else 1
    use_model_axis = _model_axis(mesh, model_axis)
    edge_labels = infer_label_domain(model.ir)[0] == "edge"
    reduction = loss_reduction(loss_fn)
    checked = set()

    def update(generator, bound, batch) -> Dict[str, torch.Tensor]:
        params, opt_state = bound
        edge_group = mesh.model_group if use_model_axis else None
        preds = model.apply(params, batch, meta, compute_dtype=compute_dtype, training=True,
                            generator=generator, edge_axis=edge_group)
        if getattr(loss_fn, "takes_groups", False):
            # hinge-family: the all-binary label test spans the effective batch
            loss = loss_fn(batch["label"], preds, batch["label_mask"],
                           groups=(mesh.data_group, edge_group))
        else:
            loss = loss_fn(batch["label"], preds, batch["label_mask"])
        if edge_group is not None and edge_labels:
            # edge-domain predictions and labels follow the edge blocks: the
            # partial losses combine into the data row's (a mask-weighted mean
            # of means, or the plain sum for sum-reduction losses)
            if reduction == "sum":
                loss = psum(loss, edge_group)
            else:
                cnt = torch.sum(batch["label_mask"])
                loss = psum(loss * cnt, edge_group) / torch.clamp_min(
                    psum(cnt, edge_group), 1.0)
        return _reduce_and_update(model, optimizer, params, opt_state, loss, reduction,
                                  n_data, n_model, mesh)

    def train_step(params, opt_state, stacked_batch, generator=None):
        mesh.require_member()
        key = _shape_key(stacked_batch)
        if key not in checked:
            _check_agreement((key, repr(meta)), mesh)
            checked.add(key)
        specs = batch_partition_specs(model.ir, stacked_batch, data_axis,
                                      model_axis if use_model_axis else None)
        batch = _local_batch(stacked_batch, specs, mesh, device)
        out = sharded.run(("parallel_train", meta, key, generator), update,
                          (params, opt_state), batch, generator)
        return params, opt_state, out["loss"]

    sharded = ShardedStep("the data-parallel training step", mesh, device, graphs, train_step)
    return sharded


def _reduce_and_update(model, optimizer, params, opt_state, loss, reduction, n_data, n_model,
                       mesh) -> Dict[str, torch.Tensor]:
    """The sharded train steps' tail: the scaled objective's gradients, one
    all-reduce over the mesh of every gradient and the loss report, and the
    update of this rank's replica; {"loss": the reported loss}."""
    reg = model.regularization_loss(params)
    scale = 1.0 if reduction == "sum" else 1.0 / n_data
    objective = (loss * scale + reg / n_data) / n_model
    leaves = list(flatten_params(params).values())
    grads = torch.autograd.grad(objective, leaves, allow_unused=True, materialize_grads=True)
    # one all-reduce over the mesh: every gradient, and the loss report
    report = loss.detach().to(torch.float32).reshape(1) * (scale / n_model)
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads] + [report])
    with span(GRADIENT_ALL_REDUCE):
        dist.all_reduce(flat, group=mesh.group)
    parts = torch.split(flat[:-1], [g.numel() for g in grads])
    grads = [p.reshape(g.shape).to(g.dtype) for p, g in zip(parts, grads)]
    optimizer.step(params, with_leaves(params, grads), opt_state)
    return {"loss": flat[-1]}


def make_parallel_apply(
    model: GnnModel,
    meta: BatchMeta,
    mesh: Mesh,
    data_axis: str = "data",
    model_axis: Optional[str] = "model",
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    graphs: Optional[Graphs] = None,
) -> ShardedStep:
    """Sharded forward: `apply_fn(params, stacked_batch)` -> the stacked
    predictions [n_data, rows, ...], float32, on every rank of the mesh.
    Edge-domain predictions are gathered from the model axis's blocks back
    into the global edge order. graphs: as `make_parallel_train_step`'s; one
    CUDA graph per batch shape on an NCCL mesh."""
    device = resolve_device(device)
    use_model_axis = _model_axis(mesh, model_axis)
    edge_labels = infer_label_domain(model.ir)[0] == "edge"
    checked = set()

    def forward(generator, params, batch) -> Dict[str, torch.Tensor]:
        edge_group = mesh.model_group if use_model_axis else None
        with torch.no_grad():
            preds = model.apply(params, batch, meta, compute_dtype=compute_dtype,
                                edge_axis=edge_group)
            if edge_group is not None and edge_labels:
                preds = all_gather(preds, edge_group, dim=0)
            return {"preds": all_gather(preds[None], mesh.data_group, dim=0)}

    def apply_fn(params, stacked_batch):
        mesh.require_member()
        key = _shape_key(stacked_batch)
        if key not in checked:
            _check_agreement((key, repr(meta)), mesh)
            checked.add(key)
        specs = batch_partition_specs(model.ir, stacked_batch, data_axis,
                                      model_axis if use_model_axis else None)
        batch = _local_batch(stacked_batch, specs, mesh, device)
        return sharded.run(("parallel_apply", meta, key), forward, params, batch)["preds"]

    sharded = ShardedStep("the data-parallel forward", mesh, device, graphs, apply_fn)
    return sharded
