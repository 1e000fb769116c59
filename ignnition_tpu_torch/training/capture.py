"""The port's steps captured into CUDA graphs and replayed: the counterpart
of the JAX package's `jax.jit`, which traces each step once per batch shape
and replays one executable.

`Graphs` belongs to one owner (a `Trainer`, a serving model) and holds one
`CapturedStep` per key; the keys are the JAX package's (`(meta, layout)`
for a training step, `(meta, n_accum, layout)` for accumulation, `meta` for
evaluation and serving). On the card a key goes through three states:

  1. its first call runs the step eagerly on the caller's tensors, on the
     owner's side stream: the warm-up (the kernels' library, cuBLAS's
     workspace for that stream, the allocator's first blocks). Its result
     is the eager step's, and nothing else runs;
  2. its second call copies the inputs into static buffers, captures the
     step on the side stream into the owner's memory pool and replays it
     once: the capture records launches and runs none, so the replay is
     this call's step;
  3. every later call copies its inputs into the buffers and replays.

The static buffers are the owner's, not the key's: one flat buffer per input
name and dtype, as large as the largest input of that name any key has
captured, each key reading a view of its front. A stream of batches of many
shapes so holds one batch's worth of inputs, as an eager step does, not one
per shape. When a key needs a buffer larger than the one there is, a larger
one replaces it and the graphs that read the old one are dropped: each
captures again, without a warm-up, at its next call.

The caller gets clones of the graph's outputs, so that the next replay
cannot overwrite what it holds. A graph is bound to the tensors it reads and
updates in place (`bound`: the training state, or the parameters), by
address; a call with other tensors (a new state, a warm start into fresh
tensors) drops the graph and starts the key again at 1, so a graph never
updates a state it was not called with. The generators the owner names
(the trainer's, for dropout and noise) are registered with every graph, so
each replay draws anew from them, as the eager step would. A capture that
fails raises `CaptureError`, naming the key: no step falls back to eager
in silence. The cyclic garbage collector is paused while a step captures
(`paused_gc`).

On the CPU, and inside `eager()` (the counterpart of `jax.disable_jit`),
a step runs op by op from Python at every call, and no graph is touched. A
step made with `why_eager` never captures either: the sharded steps of a
mesh whose collectives run over gloo, which stages them through the host
(`parallel.steps.ShardedStep`). Nor does any step while the pallas kernel
switch (`ops.cuda`) is 'never': kernel A's plain sum reads a row pointer back
to the host, which a capture cannot hold (`kernel_modes_why_eager`); the
other switches' plain versions read nothing back and capture. A graph is
bound to the switches it was captured under as well, the kernel switches and
the lowering switches that a user sets (`switches`): a call under others
drops it, so that no graph stands in for another choice of kernels or
lowerings.

The sharded steps (the steps made with an `owner`) keep a set of static
buffers of their own (`sharded`): every rank of a mesh must warm up,
capture and replay a key at the same call, since a collective captured on
one rank and issued eagerly on another hangs the mesh. Their keys come in the same order on every rank, so their
buffers grow, and drop graphs, alike on every rank; the owner's other steps
(an evaluation that the first rank alone runs) grow only their own set.

A captured step is a function of device tensors only: `fn(bound, inputs)`
may change no Python state, because a replay does not run it. A cache kept
on an input tensor (`ops.segment._whole_sort_perm`) is safe: a capture reads
the static buffers, on which no eager call made a cache, and what it caches
there is recomputed by every replay before it is read. The kernel wrappers'
launch counters see a capture (the launches are made from Python once, while
recording) but not a replay; `recorded` keeps what the capture counted,
and every replay adds it to the counter `capture.replayed_launches`.

Each call runs inside spans named by what it does (`utils.trace`):
`igt.capture.check` (the test that picks its path), then
`igt.capture.eager`, `igt.capture.warm_up`, or `igt.capture.fill` (the
input copies enqueued), `igt.capture.record` (a capture) and
`igt.capture.launch` (the replay), and `igt.capture.outputs` (the clones);
the counters `capture.calls.*`, `capture.drops.*`, `capture.input_copies`
and `capture.input_bytes` count the same boundaries.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import time
from typing import Callable, Dict, Hashable, Mapping, Optional, Sequence

import torch

from ..model.builder import flatten_params, map_params
from ..ops.cuda import launch_counts
from ..utils import trace
from ..utils.trace import count, span

_EAGER = contextvars.ContextVar("ignnition_tpu_torch_eager", default=False)


@contextlib.contextmanager
def eager():
    """Inside this context steps neither capture nor replay: every call runs
    op by op from Python (the JAX package's `jax.disable_jit`)."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def is_eager() -> bool:
    """Whether `eager()` is in force."""
    return _EAGER.get()


def switches() -> tuple:
    """What a graph is bound to besides its tensors: the kernel switches
    (`ops.cuda.modes`) and the lowering switches that a user sets
    (`model.builder.SWITCHES`), as they stand."""
    from ..model import builder
    from ..ops import cuda

    return cuda.modes() + tuple(getattr(builder, name) for name in builder.SWITCHES)


def kernel_modes_why_eager() -> Optional[str]:
    """Why no step captures under the kernel switches as they stand, or None:
    the pallas switch at 'never' gives kernel A's plain sum, which reads a row
    pointer's first entry back to the host, and a CUDA graph cannot hold a
    read back. The other plain versions (B and C's scan, D and E's
    attention) read nothing back: under their switches alone steps capture."""
    from ..ops import cuda

    if cuda.mode("pallas") != "never":
        return None
    return ("IGNNITION_TPU_PALLAS 'never': kernel A's plain sum reads a row pointer back to "
            "the host, which a CUDA graph cannot hold")


@contextlib.contextmanager
def paused_gc():
    """The cyclic garbage collector paused for a block (a capture). A dead
    cycle can hold another step's CUDA graph (a trainer or server no longer
    used), and a collection that runs while this thread captures would
    destroy that graph there: a CUDA call that a capture forbids on its
    thread, which invalidates the capture. torch no longer collects before a
    capture, so such a collection can come at any allocation."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


def _binding(tree) -> tuple:
    """What a graph is bound to: each tensor leaf's address, shape and type
    (None for a leaf that is no tensor)."""
    return tuple(
        (v.data_ptr(), tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else None
        for v in flatten_params(tree).values()
    )


# the counter of each way a call runs
_CALLS = {"eager": "capture.calls.eager", "warm-up": "capture.calls.warm_up",
          "capture": "capture.calls.capture", "replay": "capture.calls.replay"}


def _clone(tree):
    return map_params(lambda v: v.clone() if isinstance(v, torch.Tensor) else v, tree)


class Graphs:
    """The CUDA graphs of one owner: one memory pool, one side stream and
    one set of static input buffers for all of them (an owner's steps never
    run at once, so a replay may reuse what another graph's capture freed,
    and each call fills the buffers before it replays), the generators each
    graph registers, and the captured steps by key (`captured`)."""

    def __init__(self, device, generators: Sequence[torch.Generator] = ()):
        self.device = torch.device(device)
        self.generators = list(generators)
        self.captured: Dict[Hashable, CapturedStep] = {}
        self._pool = None
        self._stream = None
        self._buffers: Dict[tuple, torch.Tensor] = {}  # (name, dtype) -> flat buffer

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def stream(self) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def register(self, generator: Optional[torch.Generator]) -> None:
        """Register `generator` with every graph captured from now on."""
        if generator is not None and all(g is not generator for g in self.generators):
            self.generators.append(generator)

    def static_input(self, name: str, like: torch.Tensor, user: "CapturedStep") -> torch.Tensor:
        """A view of `like`'s shape and dtype into the shared buffer of
        `name` in `user`'s set. A buffer too small is replaced by one of
        `like`'s size, and the graphs other than `user`'s that read the old
        one are dropped."""
        slot = (user.sharded, name, like.dtype)
        buf = self._buffers.get(slot)
        if buf is None or buf.numel() < like.numel():
            if buf is not None:
                for step in self.captured.values():
                    if step is not user and step.reads(slot):
                        step.release()
                        count("capture.drops.buffer")
            buf = self._buffers[slot] = torch.empty(like.numel(), dtype=like.dtype,
                                                    device=self.device)
        return buf[: like.numel()].view(like.shape)

    def static_bytes(self) -> int:
        """The device memory of the static input buffers."""
        return sum(b.numel() * b.element_size() for b in self._buffers.values())

    def step(self, fn: Callable, key: Hashable, what: str, owner=None,
             why_eager: Optional[str] = None) -> "CapturedStep":
        """The captured step of `key`, made at its first request, or at the
        first request of another `owner` (the old one is dropped): `fn(bound,
        inputs)` -> a tree of tensors. `owner`: the sharded step that makes
        it, if any; `why_eager`: why this step never captures (None: it
        captures on the card)."""
        step = self.captured.get(key)
        if step is None or step.owner is not owner:
            if step is not None:
                step.release()
                count("capture.drops.owner")
            step = self.captured[key] = CapturedStep(fn, key, what, self, owner, why_eager)
        return step


class CapturedStep:
    """One key's step (the module docstring's three states). `last` says how
    the latest call ran: "eager", "warm-up", "capture" or "replay"; after a
    capture, `recorded` holds the kernel launches it recorded,
    `capture_seconds` its host time and `pool_bytes` the device memory it
    reserved (the pool's growth)."""

    def __init__(self, fn: Callable, key: Hashable, what: str, graphs: Graphs, owner=None,
                 why_eager: Optional[str] = None):
        self.fn, self.key, self.what, self.graphs = fn, key, what, graphs
        self.owner, self._why_eager = owner, why_eager
        # the set of static buffers it reads: a sharded step's, or the owner's other steps'
        self.sharded = owner is not None
        self.last: Optional[str] = None
        self.recorded: Dict[str, int] = {}
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self._binding: Optional[tuple] = None
        self._graph = None
        self._static: Optional[Dict[str, torch.Tensor]] = None
        self._static_bytes = 0
        self._outputs = None

    @property
    def why_eager(self) -> Optional[str]:
        """Why this step runs eagerly on the card, or None: the reason it was
        made with, else the kernel switches' (`kernel_modes_why_eager`)."""
        return self._why_eager or kernel_modes_why_eager()

    def __call__(self, bound, inputs: Mapping[str, torch.Tensor]):
        with span(trace.CAPTURE_CHECK):
            run, binding = self._path(bound)
        count(_CALLS[run])
        if run == "eager":
            self.last = "eager"
            with span(trace.CAPTURE_EAGER):
                return self.fn(bound, inputs)
        if run == "warm-up":
            self.release()
            out = self._warm_up(bound, inputs)
            self._binding = binding
            self.last = "warm-up"
            return out
        if run == "capture":
            self._capture(bound, inputs)
            self.last = "capture"
        else:
            self._fill(inputs)
            count("capture.replayed_launches", sum(self.recorded.values()))
            self.last = "replay"
        with span(trace.CAPTURE_LAUNCH):
            self._graph.replay()
        with span(trace.CAPTURE_OUTPUTS):
            return _clone(self._outputs)

    def _path(self, bound) -> tuple:
        """How this call runs ("eager", "warm-up", "capture", "replay"), and
        the binding it runs under (None when eager). A key that starts again
        counts why: its bound tensors, or else the switches, changed."""
        if not self.graphs.on_card or is_eager() or self.why_eager is not None:
            return "eager", None
        binding = (_binding(bound), switches())
        if binding != self._binding:
            if self._binding is not None:
                count("capture.drops.binding" if binding[0] != self._binding[0]
                      else "capture.drops.switches")
            return "warm-up", binding
        return ("capture" if self._graph is None else "replay"), binding

    def reads(self, slot: tuple) -> bool:
        """Whether the graph reads the shared buffer of `slot` ((sharded,
        name, dtype))."""
        return self._graph is not None and any(
            (self.sharded, k, v.dtype) == slot for k, v in self._static.items())

    @property
    def input_copies(self) -> int:
        """The copies into the static buffers that a replay begins with."""
        return 0 if self._static is None else len(self._static)

    def release(self) -> None:
        """Drop the graph, its outputs and its views of the buffers; the
        binding stays, so the next call with the same tensors captures."""
        self._graph = self._static = self._outputs = None

    def _warm_up(self, bound, inputs):
        """The eager step on the side stream the capture will use."""
        with span(trace.CAPTURE_WARM_UP):
            side = self.graphs.stream()
            current = torch.cuda.current_stream(self.graphs.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = self.fn(bound, inputs)
            current.wait_stream(side)
            return out

    def _fill(self, inputs: Mapping[str, torch.Tensor]) -> None:
        """Copy `inputs` into the static buffers, on the current stream."""
        with span(trace.CAPTURE_FILL):
            static = self._static
            if set(inputs) != set(static):
                raise ValueError(
                    f"{self.what} for key {self.key!r} was captured with inputs "
                    f"{sorted(static)}, called with {sorted(inputs)}"
                )
            for k, v in inputs.items():
                buf = static[k]
                if tuple(v.shape) != tuple(buf.shape) or v.dtype != buf.dtype:
                    raise ValueError(
                        f"{self.what} for key {self.key!r}: input '{k}' is "
                        f"{tuple(v.shape)} {v.dtype}, captured as {tuple(buf.shape)} {buf.dtype}"
                    )
                buf.copy_(v, non_blocking=True)
        count("capture.input_copies", len(static))
        count("capture.input_bytes", self._static_bytes)

    def _capture(self, bound, inputs: Mapping[str, torch.Tensor]) -> None:
        device = self.graphs.device
        self._static = {k: self.graphs.static_input(k, v, self) for k, v in inputs.items()}
        self._static_bytes = sum(v.numel() * v.element_size() for v in self._static.values())
        self._fill(inputs)
        graph = torch.cuda.CUDAGraph()
        for gen in self.graphs.generators:
            graph.register_generator_state(gen)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            # thread_local: the input pipeline's threads may pin and copy
            # while this thread records
            with span(trace.CAPTURE_RECORD), paused_gc(), torch.cuda.graph(
                graph, pool=self.graphs.pool(), stream=self.graphs.stream(),
                capture_error_mode="thread_local",
            ):
                outputs = self.fn(bound, self._static)
        except Exception as err:
            self._binding = None
            self.release()
            raise CaptureError(
                f"capturing {self.what} for key {self.key!r} into a CUDA graph failed: "
                f"{type(err).__name__}: {err}"
            ) from err
        self.capture_seconds = time.perf_counter() - t0
        after = launch_counts()
        self.recorded = {k: after[k] - before[k] for k in after}
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self._graph, self._outputs = graph, outputs

