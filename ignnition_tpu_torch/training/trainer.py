"""Training loop: steps, streaming input, checkpoints, evaluation
(counterpart of `ignnition_tpu/training/trainer.py`).

  * loss = model loss + l2 regularization;
  * the forward runs in `compute_dtype` (e.g. bf16) over float32 master
    weights; gradients arrive in float32 on the masters;
  * the optimizer and schedule come from the IR's learning options;
  * gradient accumulation over microbatches stacked on a leading axis, and
    "auto" accumulation from the dataset's edges per graph;
  * batches built on background threads (`batches`), cached on the host or
    on the device, optionally packed into one buffer per dtype
    (`training.packing`) and staged onto the device from a side CUDA stream
    (`_device_prefetch`);
  * checkpoints with `torch.save`, one directory per step, keep-max,
    resume-within-run and warm start of the parameters;
  * evaluation with the reference metric set and optional label
    denormalization, and prediction.

`train_step_fn(meta, layout)`, `accum_train_step_fn(meta, n_accum,
layout)` and `eval_step_fn(meta)` return one cached step per key, as the JAX
package returns the function jitted for that batch shape; on the card each
is captured into a CUDA graph at its second call and replayed from then on
(`training.capture`: the first call is the eager warm-up; `capture.eager()`
runs every call op by op). On the CPU the steps run eagerly. Unlike in the
JAX package, a step updates `state` in place and returns it.
The readout's random layers (Dropout, AlphaDropout, GaussianNoise) draw from
the trainer's own generator on its device (`Trainer.generator`), which
`train` seeds from its `seed` (42, as the JAX package's `PRNGKey(42)`); a
step without such a layer draws nothing. Evaluation, prediction and
serving are deterministic.
Over a mesh (`train(mesh=...)`, `parallel.make_mesh`) each step runs on
every rank the data- and edge-parallel step of `parallel/steps.py` or, with
`model_strategy="dest_shard"`, the destination-sharded step of
`parallel/edgeshard.py` over locality-renumbered samples
(`parallel/locality.py`), through the trainer's `graphs` (captured on an
NCCL mesh, eager over gloo), and only the mesh's first rank writes
checkpoints, TensorBoard, the profile and the log.
Checkpoints do not cross between the packages (orbax there, `torch.save`
here).
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..batch import resolve_device, to_device
from ..data import SampleSpec, build_batch, iter_samples
from ..data.graph import BatchMeta, PaddingConfig
from ..model.builder import GnnModel, flatten_params, map_params, with_leaves
from ..utils import trace
from ..utils.trace import span
from .capture import Graphs
from .losses import get_loss, loss_reduction
from .metrics import MetricAccumulator
from .optimizers import build_optimizer
from .packing import pack_arrays, pack_layout, unpack_arrays

log = logging.getLogger("ignnition_tpu_torch")


@dataclass
class TrainState:
    params: Any  # the JAX package's parameter tree; float32 leaves that require grad
    opt_state: Any
    step: int


def check_mesh(mesh, model_strategy: str) -> None:
    """Raise for a mesh that is not the port's `parallel.Mesh` and for an
    unknown model strategy."""
    from ..parallel import Mesh

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be ignnition_tpu_torch.parallel.Mesh (make_mesh, "
            f"distributed.make_pod_mesh), got {type(mesh).__name__}"
        )
    if model_strategy not in ("replicated", "dest_shard"):
        raise ValueError(
            f"unknown model_strategy {model_strategy!r}: 'replicated' (edge "
            f"sharding, v1) or 'dest_shard' (destination sharding, v2)"
        )


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Trainer:
    def __init__(
        self,
        model: GnnModel,
        padding: Optional[PaddingConfig] = None,
        normalizations: Optional[Mapping[str, Callable]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        """compute_dtype: e.g. torch.bfloat16 for mixed-precision training
        (float32 master weights, bf16 compute). device: where the state lives
        and the steps run; by default the current CUDA device (pass
        device="cpu" for the CPU)."""
        self.device = resolve_device(device)
        self.model = model
        self.ir = model.ir
        self.padding = padding or PaddingConfig()
        self.normalizations = normalizations
        self.compute_dtype = compute_dtype
        self.loss_fn = get_loss(self.ir.learning.loss)
        self.optimizer = build_optimizer(self.ir.learning.optimizer)
        # the training steps' draws (dropout masks, noise), on the device
        self.generator = torch.Generator(device=self.device).manual_seed(42)
        # the steps' CUDA graphs: one pool and side stream, and the generator
        # registered with every graph
        self.graphs = Graphs(self.device, generators=(self.generator,))
        self._train_steps: Dict[Any, Callable] = {}
        self._accum_steps: Dict[Any, Callable] = {}
        self._eval_steps: Dict[Any, Callable] = {}
        self._eval_batches: Dict[Any, list] = {}
        self._sized: set = set()  # metas whose footprint was estimated

    # ------------------------------------------------------------------

    def init_state(
        self, generator: Optional[torch.Generator] = None, params=None
    ) -> TrainState:
        """A fresh state on the trainer's device: parameters drawn from
        `generator` (seed 0 by default), or a copy of the tree `params`."""
        if params is None:
            generator = generator if generator is not None else torch.Generator().manual_seed(0)
            params = self.model.init(generator)
        params = map_params(
            lambda v: torch.as_tensor(v, dtype=torch.float32)
            .to(self.device, copy=True)
            .requires_grad_(True),
            params,
        )
        return TrainState(params, self.optimizer.init(params), 0)

    # ------------------------------------------------------------------

    def _loss(self, params, batch, meta) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        preds = self.model.apply(
            params, batch, meta, compute_dtype=self.compute_dtype,
            training=True, generator=self.generator,
        )
        loss = self.loss_fn(batch["label"], preds, batch["label_mask"])
        reg = self.model.regularization_loss(params)
        return loss + reg, (loss, reg)

    def train_step_fn(self, meta: BatchMeta, layout=None) -> Callable:
        """`step(state, batch) -> (state, {"loss", "reg", "total"})` for
        device batches of shape `meta`: forward, backward and one optimizer
        update of `state` in place. The metrics stay on the device. One step
        per `(meta, layout)`, captured and replayed on the card
        (`training.capture`).

        layout: the packed-transfer layout (`training.packing`); the step
        then takes the per-dtype device buffers and unpacks them to views.

        Before a meta's first step the trainer estimates the step's device
        memory and warns when one card likely cannot hold it
        (`utils.memory.maybe_warn_capacity`), as the JAX trainer does."""
        key = (meta, layout)
        if key not in self._train_steps:
            if meta not in self._sized:
                from ..utils.memory import maybe_warn_capacity

                self._sized.add(meta)
                maybe_warn_capacity(self.ir, meta, log=log, captured=self.graphs.on_card)
            grads = self.grads_fn(meta)

            def update(bound, batch) -> Dict[str, torch.Tensor]:
                params, opt_state = bound
                if layout is not None:
                    batch = unpack_arrays(batch, layout)
                grad_tree, metrics = grads(params, batch)
                self.optimizer.step(params, grad_tree, opt_state)
                return metrics

            self._train_steps[key] = _state_step(
                self.graphs.step(update, ("train",) + key, "the training step"))
        return self._train_steps[key]

    def accum_train_step_fn(self, meta: BatchMeta, n_accum: int, layout=None) -> Callable:
        """One optimizer step over `n_accum` microbatches stacked on a
        leading axis (gradient accumulation): numerically a batch
        `n_accum`x larger, each microbatch run at its own shape. The
        microbatches run in order and their gradients are summed in that
        order, then reduced as the JAX package does:
          * mean-reduction losses: the microbatch mean ~= the big-batch mean
            (exact for equal real counts), so the gradients are averaged;
          * sum-reduction losses (Keras KLDivergence): the big-batch loss is
            the sum of the microbatch sums, so the gradient sum stays, less
            the (n_accum - 1) extra copies of the L2 term's gradient that
            entered every microbatch.
        One step per `(meta, n_accum, layout)`, captured and replayed on the
        card."""
        key = (meta, n_accum, layout)
        if key not in self._accum_steps:
            grads = self.grads_fn(meta)
            is_sum = loss_reduction(self.loss_fn) == "sum"

            def update(bound, stacked) -> Dict[str, torch.Tensor]:
                params, opt_state = bound
                if layout is not None:
                    stacked = unpack_arrays(stacked, layout)
                gsum = lsum = rsum = None
                for i in range(n_accum):
                    g, m = grads(params, {k: v[i] for k, v in stacked.items()})
                    g = list(flatten_params(g).values())
                    if gsum is None:
                        gsum, lsum, rsum = g, m["loss"], m["reg"]
                    else:
                        torch._foreach_add_(gsum, g)
                        lsum, rsum = lsum + m["loss"], rsum + m["reg"]
                if is_sum:
                    reg_total = self.model.regularization_loss(params)
                    if reg_total.requires_grad:
                        reg_grads = torch.autograd.grad(
                            reg_total, list(flatten_params(params).values()),
                            allow_unused=True, materialize_grads=True)
                        torch._foreach_add_(gsum, reg_grads, alpha=-(n_accum - 1))
                    loss = lsum
                else:
                    torch._foreach_div_(gsum, n_accum)
                    loss = lsum / n_accum
                reg = rsum / n_accum
                self.optimizer.step(params, with_leaves(params, gsum), opt_state)
                return {"loss": loss, "reg": reg, "total": loss + reg}

            self._accum_steps[key] = _state_step(
                self.graphs.step(update, ("accum",) + key, "the accumulation step"))
        return self._accum_steps[key]

    def grads_fn(self, meta: BatchMeta) -> Callable:
        """`grads(params, batch) -> (gradient tree, {"loss", "reg", "total"})`:
        the step's forward and backward without the update. A leaf that the
        loss does not read (a BatchNormalization's moving statistics) gets
        a zero gradient, as under `jax.grad`, so that every optimizer sees
        the whole tree."""

        def grads(params, batch):
            total, (loss, reg) = self._loss(params, batch, meta)
            g = torch.autograd.grad(
                total, list(flatten_params(params).values()),
                allow_unused=True, materialize_grads=True,
            )
            return with_leaves(params, g), {
                "loss": loss.detach(), "reg": reg.detach(), "total": total.detach()
            }

        return grads

    def eval_step_fn(self, meta: BatchMeta) -> Callable:
        """`step(params, batch) -> (predictions, loss)`, float32 compute and no
        graph, as the JAX package's evaluation step. One step per meta,
        captured and replayed on the card."""
        if meta not in self._eval_steps:

            def evaluate(params, batch):
                with torch.no_grad():
                    preds = self.model.apply(params, batch, meta)
                    loss = self.loss_fn(batch["label"], preds, batch["label_mask"])
                return preds, loss

            self._eval_steps[meta] = self.graphs.step(evaluate, ("eval", meta),
                                                      "the evaluation step")
        return self._eval_steps[meta]

    # ------------------------------------------------------------------
    # input pipeline
    # ------------------------------------------------------------------

    def batches(
        self,
        data_dir: str,
        batch_size: int,
        shuffle: bool = False,
        repeat: bool = True,
        training: bool = True,
        seed: Optional[int] = None,
        prefetch: int = 4,
        workers: int = 1,
        cache=False,
        sample_transform: Optional[Callable] = None,
    ) -> Iterator[Tuple[Dict[str, Any], BatchMeta]]:
        """Stream (arrays, meta) merged batches of numpy arrays, built on
        background threads (the reference prefetches 10 batches through
        tf.data, generate_model.py:188-198).

        workers > 1 parallelizes archive reading (iter_samples readers: the
        gunzip and the native JSON parse release the GIL) and batch
        construction; batch order and composition then become
        nondeterministic (use with shuffle). Every sample still appears
        exactly once per epoch.

        cache=True materializes every built batch during the first epoch
        and cycles the cached list afterwards (reshuffled per epoch): host
        batch construction then costs one epoch in all. Batch composition is
        frozen after epoch one.

        cache="device" also moves every cached batch to the trainer's device
        once (`batch.to_device`), so steady-state steps copy nothing. The
        dataset must fit in device memory beside the model.

        sample_transform: a GraphSample -> GraphSample function applied to
        every sample before its batch is built (the locality renumbering of
        destination sharding rides it)."""
        if cache:
            if not repeat:
                raise ValueError("cache=True requires repeat=True")
            built = list(
                self.batches(
                    data_dir, batch_size, shuffle=shuffle, repeat=False,
                    training=training, seed=seed, prefetch=prefetch, workers=workers,
                    sample_transform=sample_transform,
                )
            )
            if cache == "device":
                built = [(to_device(a, self.device), m) for a, m in built]
            rng = np.random.default_rng(seed)
            while True:
                order = rng.permutation(len(built)) if shuffle else range(len(built))
                for i in order:
                    yield built[i]

        spec = SampleSpec.from_ir(self.ir, training=training)

        def make(group):
            if sample_transform is not None:
                group = [sample_transform(s) for s in group]
            return build_batch(
                group, self.ir, self.padding, training=training,
                normalizations=self.normalizations,
            )

        def groups():
            group = []
            for s in iter_samples(
                data_dir, spec, shuffle=shuffle, seed=seed, repeat=repeat,
                readers=max(1, workers),  # archive parsing is the host's bottleneck
            ):
                group.append(s)
                if len(group) == batch_size:
                    yield group
                    group = []
            if group:
                yield group

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        # a consumer may abandon this generator early (evaluate() stops after
        # num_batches); the stop event releases the producer threads, which
        # would otherwise block on q.put forever
        stop = threading.Event()

        def put_guarded(target_q, item) -> bool:
            while not stop.is_set():
                try:
                    target_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        if workers <= 1:

            def producer():
                try:
                    for g in groups():
                        if not put_guarded(q, make(g)):
                            return
                except BaseException as e:  # surface errors to the consumer
                    put_guarded(q, e)
                put_guarded(q, None)

            threading.Thread(target=producer, daemon=True).start()
            sentinels_expected = 1
        else:
            gq: queue.Queue = queue.Queue(maxsize=workers * 2)

            def reader():
                try:
                    for g in groups():
                        if not put_guarded(gq, g):
                            return
                except BaseException as e:
                    put_guarded(q, e)
                for _ in range(workers):
                    put_guarded(gq, None)

            def builder():
                try:
                    while True:
                        try:
                            g = gq.get(timeout=0.2)
                        except queue.Empty:
                            if stop.is_set():
                                return
                            continue
                        if g is None:
                            break
                        if not put_guarded(q, make(g)):
                            return
                except BaseException as e:
                    put_guarded(q, e)
                put_guarded(q, None)

            threading.Thread(target=reader, daemon=True).start()
            for _ in range(workers):
                threading.Thread(target=builder, daemon=True).start()
            sentinels_expected = workers

        try:
            done = 0
            while done < sentinels_expected:
                item = q.get()
                if item is None:
                    done += 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def _device_prefetch(self, batch_iter, size: int = 2):
        """Stage upcoming batches onto the device from a background thread.

        On a GPU each batch's arrays go through pinned host memory and are
        copied with `non_blocking` on a side CUDA stream; an event recorded
        after the copies is what the consuming stream waits on, and each
        tensor is marked as used by that stream so that the allocator does
        not hand its memory out again while a step still reads it. A
        replayed step copies the staged arrays into its graph's buffers on
        the consuming stream, so after that wait. The device-side half of
        the reference's tf.data prefetch (generate_model.py:188-198)."""
        device = self.device
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        q: queue.Queue = queue.Queue(maxsize=size)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def stage(arrays):
            if stream is None:
                return to_device(arrays, device), None
            host = {k: v if isinstance(v, torch.Tensor) else to_device({k: v}, "cpu")[k]
                    for k, v in arrays.items()}
            with torch.cuda.stream(stream):
                staged = {
                    k: v.to(device, non_blocking=True)
                    if v.device.type != "cpu" or v.is_pinned()
                    else v.pin_memory().to(device, non_blocking=True)
                    for k, v in host.items()
                }
                event = torch.cuda.Event()
                event.record(stream)
            return staged, event

        def worker():
            try:
                for arrays, meta in batch_iter:
                    with span(trace.DATA_PREFETCH):
                        staged = stage(arrays)
                    if not put((*staged, meta)):
                        return  # consumer gone: drop the staged batches
            except BaseException as e:  # surface errors to the consumer
                put(e)
            put(None)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                staged, event, meta = item
                if event is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(event)
                    for v in staged.values():
                        v.record_stream(current)
                yield staged, meta
        finally:
            # consumer closed early (the loop hit max_steps): release the
            # worker and the device memory its staged batches hold
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    # the JAX package's optimum microbatch scale, measured on a TPU; the
    # port keeps it so that both packages choose the same split
    _TARGET_MICROBATCH_EDGES = 262144

    def _auto_accumulate(self, data_dir: str, batch_size: int) -> Tuple[int, int]:
        """Pick (accumulate_steps, microbatch_graphs) for an effective batch
        of `batch_size` graphs per optimizer step, from the dataset's
        average edges per graph against `_TARGET_MICROBATCH_EDGES`.

        Small-graph workloads resolve to (1, batch_size), plain merged
        batches; large-graph workloads split into an even number of graphs
        per microbatch. Per-graph padding keeps the merged batch whole (its
        uniform blocks take the block-diagonal incidence products)."""
        if self.padding.per_graph:
            return 1, batch_size
        spec = SampleSpec.from_ir(self.ir)
        tot, n = 0, 0
        for s in iter_samples(data_dir, spec):
            tot += sum(len(a.src_idx) for a in s.adjacencies.values())
            n += 1
            if n >= max(batch_size, 8):
                break
        if n == 0 or batch_size <= 1:
            return 1, batch_size
        per_graph = max(tot / n, 1.0)
        micro = max(1, int(self._TARGET_MICROBATCH_EDGES // per_graph))
        if micro >= batch_size:
            return 1, batch_size
        k = -(-batch_size // micro)  # ceil
        micro = -(-batch_size // k)  # even split
        log.info(
            "auto batch strategy: ~%d edges/graph -> %d-way gradient "
            "accumulation over %d-graph microbatches (effective batch "
            "%d%s)",
            int(per_graph), k, micro, k * micro,
            "" if k * micro == batch_size
            else f", rounded up from the requested {batch_size}",
        )
        return k, micro

    def train(
        self,
        state: TrainState,
        data_dir: str,
        max_steps: int,
        batch_size: int = 3,
        shuffle: bool = True,
        log_every: int = 10,
        checkpoint_dir: Optional[str] = None,
        save_secs: int = 300,
        keep_max: int = 20,
        eval_fn: Optional[Callable[[TrainState], Dict[str, float]]] = None,
        eval_secs: int = 300,
        mesh=None,
        model_strategy: str = "replicated",
        accumulate_steps=1,
        input_workers: int = 1,
        cache_batches=False,
        device_prefetch: int = 0,
        pack_transfer: bool = False,
        tensorboard_dir: Optional[str] = None,
        histogram_every: int = 0,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (10, 15),
        locality_reorder="auto",
        seed: int = 42,
    ) -> TrainState:
        """Run the training loop to `max_steps` optimizer steps; `state` is
        updated in place and returned.

        checkpoint_dir: save every `save_secs` (host clock) and at the end,
        keeping the `keep_max` newest; a directory that already holds a
        later step than `state` resumes from its latest checkpoint
        (parameters, optimizer state and step). The batch stream restarts at
        the dataset's start, as in the JAX package.
        seed: seeds `self.generator` once, at the start (the JAX package's
        `rng`, `PRNGKey(42)` by default). A resumed run starts the generator
        anew, as the JAX package does its key, so a resumed run of a model
        with a random readout layer draws other masks than one run without
        a stop; without one it resumes exactly. It also shuffles the batch
        stream, on every path, so that a run repeats its order (the JAX
        package draws a new order at each run on one process); several
        `input_workers` still build batches in no fixed order.
        eval_fn: called with the state every `eval_secs` (host clock).
        accumulate_steps: each optimizer step consumes this many merged
        batches (stacked, then run one after another: accum_train_step_fn).
        "auto" picks the split from the dataset (_auto_accumulate);
        batch_size then means graphs per optimizer step, the reference's
        semantics.
        cache_batches: True caches the built batches on the host after epoch
        one; "device" keeps them on the device (downgraded to the host cache
        under accumulation, whose stacking is host-side).
        device_prefetch: stage this many batches ahead onto the device from
        a side CUDA stream (_device_prefetch); 0 copies each batch in the
        step's own stream.
        pack_transfer: copy each batch as one buffer per device dtype
        (training.packing) instead of one copy per array.
        tensorboard_dir: write the loss scalars every `log_every` steps, and
        parameter histograms every `histogram_every` steps if > 0, through
        `torch.utils.tensorboard` (the reference logs the same set through
        tf.summary, generate_model.py:754-756, 792-793).
        profile_dir: a torch.profiler trace of the steps in
        [profile_steps[0], profile_steps[1]), written as a chrome trace, also
        when the loop ends before the second bound; it holds the program's
        spans (`utils.trace`: the loop's `igt.train.*`, the compiled step's
        `igt.capture.*`, and the input threads' `igt.data.*`).
        mesh: a `parallel.Mesh` ('data' x 'model' ranks of the initialized
        process group): every rank of the mesh calls `train` with the same
        arguments, and each step consumes mesh.shape['data'] merged batches
        (stacked, re-padded to a common bucket) through the data- and
        edge-parallel step (`parallel.make_parallel_train_step`, in the
        trainer's compute dtype). Every rank reads the same stream, shuffled
        by `seed`, and builds the whole group; so input_workers must stay 1
        (several workers build batches in no fixed order). Accumulation is
        1 (the mesh's data axis owns batching), the state is broadcast from
        the mesh's first rank before the first step, and only that rank
        writes checkpoints, TensorBoard, the profile and the log; a resumed
        run reads `checkpoint_dir` on every rank.
        model_strategy: how the mesh's model axis is used: "replicated" (v1:
        edges split over the model axis, node tables replicated,
        aggregations all-reduced; `parallel/steps.py`) or "dest_shard" (v2:
        each merged batch partitioned by destination over the model axis,
        node state sharded, an all_to_all halo per gather;
        `parallel/edgeshard.py`: communication scales with the edge cut,
        memory and compute with the axis). Each step then takes
        mesh.shape['data'] merged batches partitioned and stacked to
        [n_data, n_model, ...] (`_destshard_batch_iter`). Without a mesh, or
        with a model axis of 1, both train on the plain path.
        locality_reorder: renumber each sample's nodes for the model axis
        before the partition (`parallel/locality.py`: the cut, and with it
        the halo, is a function of row order, and the renumbering is a
        permutation under which losses and gradients are unchanged). "auto"
        is on exactly under dest_shard with a model axis of 2 or more;
        True and False apply only there too."""
        check_mesh(mesh, model_strategy)
        writes = True
        if mesh is not None:
            import torch.distributed as dist

            from ..parallel import replicate

            mesh.require_member()
            writes = dist.get_rank() == 0
            if accumulate_steps == "auto":
                accumulate_steps = 1  # the mesh's data axis owns batching
            elif accumulate_steps > 1:
                raise ValueError(
                    "accumulate_steps > 1 is not supported together with a "
                    "mesh (the mesh's data axis owns batching) — raise "
                    "batch_size or the data-axis size instead"
                )
            if input_workers > 1:
                raise ValueError(
                    "input_workers > 1 is not supported together with a mesh: "
                    "every rank must read the same stream in the same order"
                )
        if accumulate_steps == "auto":
            accumulate_steps, batch_size = self._auto_accumulate(data_dir, batch_size)
        self.generator.manual_seed(seed)
        manager = None
        if checkpoint_dir:
            manager = (_make_checkpoint_manager(checkpoint_dir, keep_max) if writes
                       else CheckpointManager(checkpoint_dir, keep_max, create=False))
            # resume-within-run (tf.estimator's model_dir behaviour in the
            # reference, SURVEY.md §5.4)
            latest = manager.latest_step()
            if latest is not None and latest > state.step:
                if writes:
                    log.info("resuming from checkpoint step %d in %s", latest, checkpoint_dir)
                state = restore_checkpoint(manager, state)
            if not writes:
                manager = None
        if mesh is not None:
            replicate((state.params, state.opt_state), mesh)
        writer = _summary_writer(tensorboard_dir) if tensorboard_dir and writes else None
        last_save = time.time()
        last_eval = time.time()

        if cache_batches == "device" and (mesh is not None or accumulate_steps > 1):
            # stacked steps assemble their batches host-side (np.stack):
            # device-cached batches would come back to the host every step
            log.info(
                "cache_batches='device' downgraded to host caching "
                "(stacked steps assemble batches host-side)"
            )
            cache_batches = True
        step_cache: Dict[BatchMeta, Callable] = {}
        dest_shard = (
            mesh is not None and model_strategy == "dest_shard"
            and mesh.shape.get("model", 1) > 1
        )
        if dest_shard:
            reorder = True if locality_reorder == "auto" else bool(locality_reorder)
            batch_iter = self._destshard_batch_iter(
                data_dir, batch_size, mesh, shuffle, seed, cache=cache_batches,
                sample_transform=(self._locality_transform(mesh.shape["model"], batch_size)
                                  if reorder else None),
            )
        elif mesh is not None:
            batch_iter = self._sharded_batch_iter(
                data_dir, batch_size, mesh, shuffle, seed, cache=cache_batches,
            )
        elif accumulate_steps > 1:
            batch_iter = self._stacked_batch_iter(
                data_dir, batch_size, accumulate_steps, shuffle, seed,
                workers=input_workers, cache=cache_batches,
            )
        else:
            batch_iter = self.batches(
                data_dir, batch_size, shuffle=shuffle, repeat=True, seed=seed,
                workers=input_workers, cache=cache_batches,
            )
        layouts: Dict[BatchMeta, Any] = {}
        # nothing left to copy; a mesh step copies its own part of the batch
        on_device = cache_batches == "device" or mesh is not None
        if pack_transfer and not on_device:
            pin = self.device.type == "cuda"

            def _packed(it):
                for arrays, meta in it:
                    lay = layouts.get(meta)
                    if lay is None:
                        lay = layouts[meta] = pack_layout(arrays)
                    yield pack_arrays(arrays, lay, pin=pin), meta

            batch_iter = _packed(batch_iter)
        if device_prefetch > 0 and not on_device:
            batch_iter = self._device_prefetch(batch_iter, device_prefetch)

        profiler = None
        try:
            while True:
                with span(trace.TRAIN_NEXT_BATCH):
                    item = next(batch_iter, None)
                if item is None:
                    break
                arrays, meta = item
                if state.step >= max_steps:
                    break
                if profile_dir and writes and state.step == profile_steps[0]:
                    profiler = _start_profiler(self.device)
                if profiler is not None and state.step >= profile_steps[1]:
                    _stop_profiler(profiler, profile_dir, profile_steps)
                    profiler = None
                if mesh is not None:
                    if meta not in step_cache:
                        from ..parallel import make_edgeshard_train_step, make_parallel_train_step

                        make = make_edgeshard_train_step if dest_shard else make_parallel_train_step
                        step_cache[meta] = make(
                            self.model, self.optimizer, self.loss_fn, meta, mesh,
                            compute_dtype=self.compute_dtype, device=self.device,
                            graphs=self.graphs,
                        )
                    _, _, loss = step_cache[meta](
                        state.params, state.opt_state, arrays, generator=self.generator
                    )
                    state.step += 1
                    # the L2 term is not in the mesh step's loss (the JAX step's)
                    logs = {"loss": loss, "reg": 0.0, "total": loss}
                else:
                    lay = layouts.get(meta)
                    step_fn = (
                        self.accum_train_step_fn(meta, accumulate_steps, layout=lay)
                        if accumulate_steps > 1
                        else self.train_step_fn(meta, layout=lay)
                    )
                    with span(trace.TRAIN_TO_DEVICE):
                        batch = to_device(arrays, self.device, non_blocking=True)
                    state, logs = step_fn(state, batch)
                if log_every and writes and state.step % log_every == 0:
                    with span(trace.TRAIN_LOG):
                        loss, reg, total = (float(logs[k]) for k in ("loss", "reg", "total"))
                        log.info("step %d  loss=%.6f  reg=%.6f  total=%.6f",
                                 state.step, loss, reg, total)
                        if writer is not None:
                            writer.add_scalar("loss", loss, state.step)
                            writer.add_scalar("regularization_loss", reg, state.step)
                            writer.add_scalar("total_loss", total, state.step)
                if writer is not None and histogram_every and state.step % histogram_every == 0:
                    for name, leaf in flatten_params(state.params).items():
                        writer.add_histogram(name, _numpy(leaf), state.step)
                now = time.time()
                if manager is not None and now - last_save >= save_secs:
                    with span(trace.TRAIN_CHECKPOINT):
                        save_checkpoint(manager, state)
                    last_save = now
                if eval_fn is not None and writes and now - last_eval >= eval_secs:
                    with span(trace.TRAIN_EVAL):
                        results = eval_fn(state)
                    log.info("eval @ step %d: %s", state.step, results)
                    last_eval = now
        finally:
            batch_iter.close()
            if profiler is not None:
                # the loop ended before profile_steps[1]: close the trace
                _stop_profiler(profiler, profile_dir, profile_steps)
        if manager is not None:
            save_checkpoint(manager, state)
        if writer is not None:
            writer.close()
        return state

    def _sharded_batch_iter(self, data_dir, batch_size, mesh, shuffle, seed, cache=False):
        """Group the mesh's data axis per step, stacked on the leading axis
        (re-padded to a common bucket). Every rank reads the same stream,
        shuffled by `seed`, and builds the whole group, so that all hold
        the same meta; the step takes each rank's own part."""
        from ..parallel import stack_batches

        n_data = mesh.shape["data"]
        group = []
        for item in self.batches(
            data_dir, batch_size, shuffle=shuffle, repeat=True, seed=seed, cache=cache,
        ):
            group.append(item)
            if len(group) == n_data:
                yield stack_batches(group, self.ir)
                group = []

    def _locality_transform(self, n_model: int, batch_size: int) -> Callable:
        """The per-sample locality renumbering, with a memo keyed by content:
        epochs yield the same samples as fresh objects, and the ordering is a
        function of (adjacencies, node counts, n_model). For single-sample
        batches each entity's padded size is passed on, so that the block
        refinement splits where partition_batch's padded ceil-split will;
        merged batches pass none (their block boundaries depend on the
        merge, and mostly fall on graph boundaries)."""
        import hashlib

        from ..parallel.locality import locality_order, reorder_sample

        memo: Dict[bytes, Dict[str, np.ndarray]] = {}

        def key_of(s) -> bytes:
            h = hashlib.blake2b(digest_size=16)
            for name in sorted(s.adjacencies):
                arrs = s.adjacencies[name]
                h.update(name.encode())
                h.update(np.ascontiguousarray(arrs.src_idx).tobytes())
                h.update(np.ascontiguousarray(arrs.dst_idx).tobytes())
            for ent in sorted(s.num_nodes):
                h.update(f"{ent}={s.num_nodes[ent]};".encode())
            return h.digest()

        def transform(s):
            k = key_of(s)
            orders = memo.get(k)
            if orders is None:
                node_pad = None
                if batch_size == 1:
                    node_pad = {ent: self.padding.pad_size(n) for ent, n in s.num_nodes.items()}
                orders = locality_order(s, self.ir, n_model=n_model, node_pad=node_pad)
                if len(memo) < 4096:  # bounds the host memory on huge datasets
                    memo[k] = orders
            return reorder_sample(s, self.ir, orders=orders)[0]

        return transform

    def _destshard_batch_iter(self, data_dir, batch_size, mesh, shuffle, seed=None,
                              cache=False, sample_transform=None):
        """Destination sharding: group the mesh's data axis, partition each
        merged batch over the model axis (`parallel.partition_batch`) and
        stack to [n_data, n_model, ...]. The partition's shape-defining dims
        (halo heights, local edge pads) only grow (`pad_to`), so that a
        stream settles on one shape. Every rank reads the same stream,
        shuffled by `seed`, and partitions the whole group, so that all hold
        the same meta; the step takes each rank's own cell.

        With cache=True a cached batch's partition is kept, keyed by the
        batch object and the current pad_to, so that steady-state epochs
        partition nothing. Only cached batches, which the cache keeps alive,
        may key it: a transient dict (a re-padded copy) may be freed and its
        id given to another dict."""
        from ..data.graph import merge_metas, repad_to_meta
        from ..parallel import partition_batch, partition_dims

        n_model, n_data = mesh.shape["model"], mesh.shape["data"]
        pad_to: Dict[str, Dict[str, int]] = {"halo": {}, "edges": {}}
        memo: Dict[int, Tuple[Any, Tuple]] = {}

        def pad_key():
            return (tuple(sorted(pad_to["halo"].items())),
                    tuple(sorted(pad_to["edges"].items())))

        def partition_item(arrays, meta, memoize=True):
            if cache and memoize:
                hit = memo.get(id(arrays))
                if hit is not None and hit[0] == pad_key():
                    return hit[1]
            part = partition_batch(arrays, meta, self.ir, n_model, pad_to=pad_to)
            if cache and memoize:
                memo[id(arrays)] = (pad_key(), part)
            return part

        group: list = []
        for item in self.batches(
            data_dir, batch_size, shuffle=shuffle, repeat=True, seed=seed, cache=cache,
            sample_transform=sample_transform,
        ):
            group.append(item)
            if len(group) < n_data:
                continue
            items, group = group, []
            memoize = True
            if len({m for _, m in items}) > 1:
                # grow to a common meta first: these re-padded copies are
                # transient and stay out of the memo
                target = merge_metas([m for _, m in items], self.ir)
                items = [(repad_to_meta(a, m, target, self.ir), target) for a, m in items]
                memoize = False
            while True:
                parts = [partition_item(a, m, memoize) for a, m in items]
                dims = [partition_dims(p[0]) for p in parts]
                grown = False
                for d in dims:
                    for grp in ("halo", "edges"):
                        for adj, v in d[grp].items():
                            if v > pad_to[grp].get(adj, 0):
                                pad_to[grp][adj] = v
                                grown = True
                if not grown or all(d == dims[0] for d in dims):
                    break
            if len({p[1] for p in parts}) != 1:
                continue  # grew mid-group; the next group is partitioned alike
            yield {k: np.stack([p[0][k] for p in parts], 0) for k in parts[0][0]}, parts[0][1]

    def _stacked_batch_iter(self, data_dir, batch_size, n_accum, shuffle, seed=None, workers=1,
                            cache=False):
        """Group `n_accum` merged batches per optimizer step, stacked on a
        leading axis (re-padded to a common bucket)."""
        from ..parallel import stack_batches

        group = []
        for item in self.batches(
            data_dir, batch_size, shuffle=shuffle, repeat=True, seed=seed, workers=workers,
            cache=cache,
        ):
            group.append(item)
            if len(group) == n_accum:
                yield stack_batches(group, self.ir)
                group = []

    def evaluate(
        self,
        state: TrainState,
        data_dir: str,
        num_batches: int = 100,
        batch_size: int = 1,
        denormalization: Optional[Callable] = None,
        label_name: str = "label",
        cache: bool = False,
        shuffle: bool = False,
        seed: Optional[int] = None,
    ) -> Dict[str, float]:
        """The reference metric set and the mean loss over `num_batches`
        batches, in float32 compute.

        cache=True keeps the built eval batches on the Trainer (host
        memory), so the periodic in-training evals pay the host build once.
        shuffle=True evaluates a shuffled stream (the reference's
        shuffle_eval_samples, framework_operations.py:162); with cache=True
        a pool of up to 8x num_batches is built once and a fresh permutation
        of it is drawn per call."""
        acc = MetricAccumulator()
        total_loss, n = None, 0
        if seed is None:
            seed = int(np.random.default_rng().integers(2**31)) if shuffle else 0
        if cache:
            pool = 8 * num_batches if shuffle else num_batches
            key = (data_dir, batch_size, pool)
            if key not in self._eval_batches:
                built = []
                for item in self.batches(data_dir, batch_size, shuffle=False, repeat=False):
                    built.append(item)
                    if len(built) >= pool:
                        break
                self._eval_batches[key] = built
            cached = self._eval_batches[key]
            if shuffle:
                order = np.random.default_rng(seed).permutation(len(cached))
                batch_iter = iter([cached[i] for i in order])
            else:
                batch_iter = iter(cached)
        else:
            batch_iter = self.batches(
                data_dir, batch_size, shuffle=shuffle, repeat=False,
                seed=seed if shuffle else None,
            )
        for arrays, meta in batch_iter:
            if n >= num_batches:
                break
            preds, loss = self.eval_step_fn(meta)(state.params, to_device(arrays, self.device))
            labels = _numpy(arrays["label"])
            preds = _numpy(preds)
            mask = _numpy(arrays["label_mask"]) > 0
            if denormalization is not None:
                labels = np.where(mask, denormalization(labels, label_name), labels)
                preds = np.where(mask, denormalization(preds, label_name), preds)
            acc.update(labels, preds, mask)
            # summed in float64 on the device, as Python floats would be
            loss = loss.detach().to(torch.float64)
            total_loss = loss if total_loss is None else total_loss + loss
            n += 1
        if hasattr(batch_iter, "close"):
            batch_iter.close()
        out = acc.result()
        out["loss"] = float(total_loss) / n if n else 0.0
        return out

    def predict(
        self,
        state_or_params,
        data_dir: str,
        batch_size: int = 1,
        denormalization: Optional[Callable] = None,
        label_name: str = "label",
    ):
        """Yield (per-batch prediction array, the batch's numpy arrays),
        denormalized when a function is given (the reference's predict path,
        framework_operations.py:209-213)."""
        params = getattr(state_or_params, "params", state_or_params)
        for arrays, meta in self.batches(
            data_dir, batch_size, shuffle=False, repeat=False, training=False
        ):
            preds = _numpy(self._predict_fn(meta)(params, to_device(arrays, self.device)))
            if denormalization is not None:
                preds = denormalization(preds, label_name)
            yield preds, arrays

    def _predict_fn(self, meta: BatchMeta) -> Callable:
        key = ("predict", meta)
        if key not in self._eval_steps:

            def predict(params, batch):
                with torch.no_grad():
                    return self.model.apply(params, batch, meta)

            self._eval_steps[key] = self.graphs.step(predict, key, "the prediction step")
        return self._eval_steps[key]


def _state_step(update: Callable) -> Callable:
    """`step(state, batch) -> (state, metrics)` over `update((params,
    opt_state), batch) -> metrics`, a captured step that updates the state's
    tensors in place; the host-side step count is kept here, since a replay
    runs no Python of the update."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span(trace.TRAIN_STEP):
            metrics = update((state.params, state.opt_state), batch)
        state.step += 1
        return state, metrics

    return step


def _summary_writer(directory: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError(
            "tensorboard_dir needs torch.utils.tensorboard, which needs the "
            "tensorboard package; it is not installed"
        ) from e
    return SummaryWriter(directory)


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    # every thread's ops and spans: the input workers' `build_batch` and the
    # device prefetch run off the loop's thread, and the profiler records
    # only the thread that starts it unless asked
    profiler = torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
    )
    profiler.start()
    return profiler


def _stop_profiler(profiler, directory: str, steps: Tuple[int, int]) -> None:
    profiler.stop()
    os.makedirs(directory, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(directory, f"trace_steps_{steps[0]}_{steps[1]}.json"))


# --------------------------------------------------------------------------
# checkpoints (torch.save)
# --------------------------------------------------------------------------

_STATE_FILE = "state.pt"


class CheckpointManager:
    """Checkpoints under `directory`, one directory per step
    (`<directory>/<step>/state.pt`), each written under a temporary name and
    then renamed into place, so a reader never sees half a checkpoint. Keeps
    the `keep_max` newest (all if None)."""

    def __init__(self, directory: str, keep_max: Optional[int] = None, create: bool = True):
        self.directory = os.path.abspath(directory)
        self.keep_max = keep_max
        if create:
            os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, _STATE_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Dict[str, Any]) -> bool:
        """Write `payload` as step `step`; False if that step is already saved."""
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            return False
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        os.replace(tmp, final)
        if self.keep_max:
            for old in self.all_steps()[: -self.keep_max]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        return True

    def restore(self, step: int) -> Dict[str, Any]:
        path = os.path.join(self.directory, str(step), _STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)


def _make_checkpoint_manager(directory: str, keep_max: int) -> CheckpointManager:
    return CheckpointManager(directory, keep_max)


def _flat_cpu(tree) -> Dict[str, Any]:
    """The tree as a flat dict under `flatten_params`' names, tensors on the CPU."""
    return {
        k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
        for k, v in flatten_params(tree).items()
    }


def _copied_into(tree, saved: Mapping[str, Any], what: str, where: str):
    """`tree` with the saved values: tensor leaves copied into in place
    (keeping their device, dtype and requires_grad, so that a captured step
    stays bound to them), other leaves taken as saved."""
    live = flatten_params(tree)
    if set(live) != set(saved):
        raise ValueError(
            f"the checkpoint {where} does not match this model's {what}: "
            f"missing {sorted(set(live) - set(saved))}, unexpected "
            f"{sorted(set(saved) - set(live))}"
        )
    leaves = []
    with torch.no_grad():
        for k, v in live.items():
            if isinstance(v, torch.Tensor):
                # a checkpoint written before the count and Nadam's product
                # were tensors holds them as Python numbers
                value = torch.as_tensor(saved[k])
                if tuple(v.shape) != tuple(value.shape):
                    raise ValueError(
                        f"the checkpoint {where} holds {what} '{k}' of shape "
                        f"{tuple(value.shape)}, this model {tuple(v.shape)}"
                    )
                v.copy_(value)
                leaves.append(v)
            else:
                leaves.append(saved[k])
    return with_leaves(tree, leaves)


def save_checkpoint(manager: CheckpointManager, state: TrainState) -> None:
    manager.save(
        state.step,
        {"params": _flat_cpu(state.params), "opt_state": _flat_cpu(state.opt_state),
         "step": state.step},
    )


def restore_checkpoint(manager: CheckpointManager, state: TrainState) -> TrainState:
    """The latest checkpoint copied into `state`'s tensors (parameters and
    optimizer state) with its step; `state` as it is when there is none."""
    step = manager.latest_step()
    if step is None:
        return state
    saved = manager.restore(step)
    where = os.path.join(manager.directory, str(step))
    _copied_into(state.params, saved["params"], "parameters", where)
    opt_state = _copied_into(state.opt_state, saved["opt_state"], "optimizer state", where)
    return TrainState(state.params, opt_state, int(saved["step"]))


def warm_start(state: TrainState, checkpoint_dir: str) -> TrainState:
    """Restore the parameters (not the optimizer state or the step) from the
    latest checkpoint under `checkpoint_dir`, into `state`'s tensors: the
    reference's warm start restores only kernel/recurrent_kernel/bias
    variables (f_o.py:126-132), which is what the parameter tree holds."""
    manager = CheckpointManager(checkpoint_dir, create=False)
    step = manager.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under '{checkpoint_dir}'")
    saved = manager.restore(step)
    _copied_into(state.params, saved["params"], "parameters",
                 os.path.join(manager.directory, str(step)))
    return state
