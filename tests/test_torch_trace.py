"""The port's spans and counters (`utils/trace.py`), on the CPU and (cases
marked `cuda`) on the card.

- `span` is a shared no-op context, and makes no profiler record, while no
  profiler records.
- Under torch.profiler an eager training step records `igt.train.step` with
  `igt.capture.eager` inside it, `build_batch` records
  `igt.data.build_batch`, and `Trainer.train(profile_dir=)`'s chrome trace
  holds the loop's spans and the input threads'; no span is a user
  annotation (the kind that also marks the device's timeline).
- The counters count each call by how it ran: on the CPU every call is
  eager; on the card a key's warm-up, capture and replays, the graph that a
  larger buffer drops, and each replay's input copies and kernel launches.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ignnition_tpu_torch as igt
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data import synthetic
from ignnition_tpu_torch.data.graph import merge_metas
from ignnition_tpu_torch.data.synthetic import make_routenet_sample
from ignnition_tpu_torch.utils import trace

from helpers import routenet_description

DIMS = {"link_capacity": 1, "traffic": 1}
PAD = dict(mode="multiple", multiple=64, min_size=64)


@pytest.fixture(autouse=True)
def _fresh_counters():
    trace.reset_counters()
    yield
    trace.reset_counters()


def _trainer(device="cpu"):
    ir = igt.parse_model_description(routenet_description(num_iterations=2, hs=8), DIMS)
    return igt.Trainer(igt.build(ir), igt.PaddingConfig(**PAD), device=device)


def _batches(trainer, n, seed=0, size=(32, 24, 6)):
    """`n` training batches of one meta, each one graph of `size`."""
    rng = np.random.default_rng(seed)
    spec = igt.SampleSpec.from_ir(trainer.ir)
    samples = [igt.convert_sample(make_routenet_sample(rng, *size), spec) for _ in range(n)]
    pad = igt.PaddingConfig(**PAD)
    meta = merge_metas([igt.build_batch([s], trainer.ir, pad)[1] for s in samples], trainer.ir)
    arrays = [igt.build_batch([s], trainer.ir, pad, target=meta)[0] for s in samples]
    return arrays, meta


def _events(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_span_names_are_the_programs():
    assert len(set(trace.SPANS)) == len(trace.SPANS)
    assert all(name.startswith("igt.") for name in trace.SPANS)


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    made = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: made.append(name))
    assert not torch.autograd.profiler._is_profiler_enabled
    first = trace.span(trace.CAPTURE_CHECK)
    assert trace.span(trace.CAPTURE_FILL) is first
    with first:
        with trace.span(trace.TRAIN_STEP):
            pass
    assert made == []


def test_span_records_a_host_op_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span(trace.TRAIN_LOG):
            torch.ones(4).sum()
    (event,) = _events(prof, trace.TRAIN_LOG)
    assert not event.is_user_annotation
    assert _events(prof, "aten::sum")


def test_an_eager_step_records_its_spans():
    trainer = _trainer()
    arrays, meta = _batches(trainer, 1)
    batch = to_device(arrays[0], "cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    step = trainer.train_step_fn(meta)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, batch)
    (outer,) = _events(prof, trace.TRAIN_STEP)
    (check,) = _events(prof, trace.CAPTURE_CHECK)
    (inner,) = _events(prof, trace.CAPTURE_EAGER)
    for e in (check, inner):
        assert outer.time_range.start <= e.time_range.start
        assert e.time_range.end <= outer.time_range.end
    assert check.time_range.end <= inner.time_range.start
    assert not any(e.is_user_annotation for e in (outer, check, inner))
    assert not _events(prof, trace.CAPTURE_LAUNCH)


def test_build_batch_records_its_span():
    trainer = _trainer()
    rng = np.random.default_rng(1)
    sample = igt.convert_sample(make_routenet_sample(rng, 16, 12, 4),
                                igt.SampleSpec.from_ir(trainer.ir))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        igt.build_batch([sample], trainer.ir, igt.PaddingConfig(**PAD))
    assert len(_events(prof, trace.DATA_BUILD_BATCH)) == 1


def test_the_chrome_trace_of_train_holds_the_loops_spans(tmp_path):
    data = tmp_path / "train"
    synthetic.write_dataset(str(data), 2, 4, seed=0, max_path_len=4)
    trainer = _trainer()
    trainer.train(trainer.init_state(), str(data), 4, batch_size=2, shuffle=False,
                  log_every=1, profile_dir=str(tmp_path / "prof"), profile_steps=(1, 3))
    with open(tmp_path / "prof" / "trace_steps_1_3.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for name in (trace.TRAIN_NEXT_BATCH, trace.TRAIN_TO_DEVICE, trace.TRAIN_STEP,
                 trace.TRAIN_LOG, trace.CAPTURE_CHECK, trace.CAPTURE_EAGER):
        assert name in names, name


def test_the_chrome_trace_of_train_holds_the_input_threads_spans(tmp_path):
    """`build_batch` runs on the input workers and the device prefetch on a
    thread of its own; the trace holds both threads' spans. The window
    consumes more batches than the input queues hold, so at least one batch
    is built and staged inside it."""
    data = tmp_path / "train"
    synthetic.write_dataset(str(data), 2, 4, seed=0, max_path_len=4)
    trainer = _trainer()
    trainer.train(trainer.init_state(), str(data), 18, batch_size=2, shuffle=False,
                  input_workers=2, device_prefetch=2, profile_dir=str(tmp_path / "prof"),
                  profile_steps=(1, 17))
    with open(tmp_path / "prof" / "trace_steps_1_17.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    threads = {name: {e["tid"] for e in events if e.get("name") == name}
               for name in (trace.DATA_BUILD_BATCH, trace.DATA_PREFETCH, trace.TRAIN_STEP)}
    assert threads[trace.DATA_BUILD_BATCH] and threads[trace.DATA_PREFETCH], threads
    assert not threads[trace.TRAIN_STEP] & (threads[trace.DATA_BUILD_BATCH]
                                            | threads[trace.DATA_PREFETCH])


def test_counters_count_each_eager_call():
    trainer = _trainer()
    arrays, meta = _batches(trainer, 1)
    batch = to_device(arrays[0], "cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    step = trainer.train_step_fn(meta)
    for i in range(3):
        state, _ = step(state, batch)
        assert trace.counters() == {"capture.calls.eager": i + 1}
    trainer.eval_step_fn(meta)(state.params, batch)
    assert trace.counters() == {"capture.calls.eager": 4}


def test_counters_lose_no_count_across_threads():
    """Eight threads adding at once with a short switch interval: every add
    counts."""
    import sys
    import threading

    def add():
        for _ in range(5000):
            trace.count("shared")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert trace.counters() == {"shared": 8 * 5000}


def test_counters_are_a_copy_and_reset():
    trace.count("x")
    trace.count("x", 4)
    seen = trace.counters()
    seen["x"] = 0
    assert trace.counters() == {"x": 5}
    trace.reset_counters()
    assert trace.counters() == {}


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compiled step captures on the card only")
    return torch.device("cuda", torch.cuda.current_device())


def _calls():
    c = trace.counters()
    return tuple(c.get(f"capture.calls.{k}", 0) for k in ("warm_up", "capture", "replay"))


@pytest.mark.cuda
def test_warm_up_capture_and_replays_count(cuda_device):
    """A key's calls count 1 warm-up, 1 capture, then one replay a call; each
    fill adds the batch's arrays and their bytes, each replay the kernel
    launches its capture recorded."""
    trainer = _trainer(cuda_device)
    arrays, meta = _batches(trainer, 2)
    batches = [to_device(a, cuda_device) for a in arrays]
    state = trainer.init_state(torch.Generator().manual_seed(0))
    step = trainer.train_step_fn(meta)
    captured = trainer.graphs.captured[("train", meta, None)]
    n_in = len(batches[0])
    in_bytes = sum(v.numel() * v.element_size() for v in batches[0].values())
    for i in range(6):
        state, _ = step(state, batches[i % 2])
        replays = max(i - 1, 0)
        assert _calls() == (1, int(i >= 1), replays), i
        c = trace.counters()
        fills = int(i >= 1) + replays
        assert c.get("capture.input_copies", 0) == fills * n_in
        assert c.get("capture.input_bytes", 0) == fills * in_bytes
        assert c.get("capture.replayed_launches", 0) == replays * sum(captured.recorded.values())
    assert sum(captured.recorded.values()) > 0
    assert captured.input_copies == n_in
    assert not any(k.startswith("capture.drops.") for k in trace.counters())


@pytest.mark.cuda
def test_a_larger_shape_counts_the_graph_it_drops(cuda_device):
    """A larger meta's capture replaces the shared buffers and drops the
    smaller meta's graph: `capture.drops.buffer` counts it; that key then
    captures again, and a new state starts the key again (`capture.drops.binding`)."""
    trainer = _trainer(cuda_device)
    small, small_meta = _batches(trainer, 1)
    big, big_meta = _batches(trainer, 1, seed=1, size=(64, 48, 6))
    state = trainer.init_state(torch.Generator().manual_seed(0))
    for meta, arrays in [(small_meta, small[0])] * 2 + [(big_meta, big[0])] * 2:
        state, _ = trainer.train_step_fn(meta)(state, to_device(arrays, cuda_device))
    assert trace.counters().get("capture.drops.buffer") == 1
    assert _calls() == (2, 2, 0)
    state, _ = trainer.train_step_fn(small_meta)(state, to_device(small[0], cuda_device))
    assert _calls() == (2, 3, 0)
    other = trainer.init_state(torch.Generator().manual_seed(1))
    trainer.train_step_fn(small_meta)(other, to_device(small[0], cuda_device))
    assert trace.counters().get("capture.drops.binding") == 1
    assert _calls() == (3, 3, 0)


@pytest.mark.cuda
def test_spans_leave_no_mark_on_the_device_timeline(cuda_device):
    """Under a profile of the card the replay's spans are host records only:
    no device record carries an `igt.` name."""
    trainer = _trainer(cuda_device)
    arrays, meta = _batches(trainer, 1)
    batch = to_device(arrays[0], cuda_device)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    step = trainer.train_step_fn(meta)
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    host = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    device = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert {trace.TRAIN_STEP, trace.CAPTURE_CHECK, trace.CAPTURE_FILL, trace.CAPTURE_LAUNCH,
            trace.CAPTURE_OUTPUTS} <= host
    assert device and not any(n.startswith("igt.") for n in device), sorted(device)[:20]
