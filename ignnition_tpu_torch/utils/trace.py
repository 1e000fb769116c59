"""The port's own tracing: named spans on the profiler's clock and counters.

Spans. `span(name)` is a context that torch.profiler records as an op of
that name while a profiler records, and a shared no-op context otherwise:
reading the flag that `torch.autograd.profiler` keeps costs a fraction of a
microsecond, where an ungated `record_function` costs ~10 us a span on a
CPU. A span is recorded as a host op
(`torch._C._profiler._RecordFunctionFast`), not as a user annotation
(`torch.profiler.record_function`): a user annotation also
leaves a mark on the device's timeline, from the first to the last device
record that its host work launched, which a reader of the device's busy
time would take for work. The spans sit on the same clock as the
profiler's device records, so an idle stretch of the device can be put down
to the host work around the call that launched the work ending it; a
chrome trace (`Trainer.train(profile_dir=)`) carries them to an operator.
The program's spans are named `igt.<layer>.<what>` (`SPANS`).

Counters. `count(name, n)` adds to one process-wide table of ints, always
on, under a lock; `counters()` returns a copy and `reset_counters()` clears
it. The compiled step (`training.capture`) keeps:

- `capture.calls.{eager,warm_up,capture,replay}`: the calls by how they ran;
- `capture.drops.{binding,switches,buffer,owner}`: why a key started again
  (a call with other bound tensors, other switches; another owner's step
  for the key) or a graph was dropped (a larger static buffer replaced the
  one it read);
- `capture.input_copies`, `capture.input_bytes`: the copies into static
  input buffers enqueued before a replay or a capture, and their bytes;
- `capture.replayed_launches`: the hand-written kernels' launches that the
  replays ran (`ops.cuda.launch_counts` counts launches made from Python
  only).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch
import torch.autograd.profiler as _profiler

# the program's spans (the training loop's, the input pipeline's, the
# compiled step's); `parallel.steps.GRADIENT_ALL_REDUCE` is one more
TRAIN_NEXT_BATCH = "igt.train.next_batch"  # the wait on the batch stream
TRAIN_TO_DEVICE = "igt.train.to_device"  # a batch's copies to the device enqueued
TRAIN_STEP = "igt.train.step"  # one call of a training step (`_state_step`)
TRAIN_LOG = "igt.train.log"  # the losses read to the host (a sync), logged
TRAIN_CHECKPOINT = "igt.train.checkpoint"
TRAIN_EVAL = "igt.train.eval"
DATA_BUILD_BATCH = "igt.data.build_batch"
DATA_PREFETCH = "igt.data.prefetch"  # a batch staged on the prefetch stream
CAPTURE_CHECK = "igt.capture.check"  # the binding and switch test that picks the path
CAPTURE_FILL = "igt.capture.fill"  # the static input copies enqueued
CAPTURE_LAUNCH = "igt.capture.launch"  # `CUDAGraph.replay`
CAPTURE_OUTPUTS = "igt.capture.outputs"  # the outputs cloned
CAPTURE_WARM_UP = "igt.capture.warm_up"  # a key's first, eager, call
CAPTURE_RECORD = "igt.capture.record"  # the capture itself
CAPTURE_EAGER = "igt.capture.eager"  # a step run op by op
SPANS = (
    TRAIN_NEXT_BATCH, TRAIN_TO_DEVICE, TRAIN_STEP, TRAIN_LOG, TRAIN_CHECKPOINT, TRAIN_EVAL,
    DATA_BUILD_BATCH, DATA_PREFETCH, CAPTURE_CHECK, CAPTURE_FILL, CAPTURE_LAUNCH,
    CAPTURE_OUTPUTS, CAPTURE_WARM_UP, CAPTURE_RECORD, CAPTURE_EAGER,
)

_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}
_LOCK = threading.Lock()  # steps may run on several threads


def span(name: str):
    """A context recorded as `name` while a torch profiler records; else a
    shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    with _LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    with _LOCK:
        _COUNTS.clear()
