"""The readers of the program's spans and counters on made-up windows, and
the split of the device's idle time (`idle.py`) on made-up records."""

import sys
import types

import pytest

from gnnbench import idle
from gnnbench.metrics import input_copies_per_step, step_check_ms_per_step, step_fill_ms_per_step
from gnnbench.trace import Trace

from test_gnnbench_counts import window


def test_span_readers_sum_their_span_a_step():
    t = Trace(window=(10.0, 11.0), steps=2, device=[("k", 10.1, 10.2)], host=[
        ("gnnbench.step", 10.0, 10.4), ("igt.train.step", 10.0, 10.3),
        ("igt.capture.check", 10.0, 10.01), ("igt.capture.fill", 10.01, 10.05),
        ("cudaMemcpyAsync", 10.02, 10.03), ("gnnbench.step", 10.5, 10.9),
        ("igt.capture.check", 10.5, 10.53), ("igt.capture.fill", 10.53, 10.6)])
    w = window(t)
    assert step_check_ms_per_step.read(w) == pytest.approx(1e3 * (0.01 + 0.03) / 2)
    assert step_fill_ms_per_step.read(w) == pytest.approx(1e3 * (0.04 + 0.07) / 2)
    # the profiler's own buffer request inside a span is not the program's time
    t.host.append(("Activity Buffer Request", 10.51, 10.55))
    assert step_check_ms_per_step.read(w) == pytest.approx(1e3 * (0.01 + 0.03 - 0.02) / 2)
    assert step_fill_ms_per_step.read(w) == pytest.approx(1e3 * (0.04 + 0.07 - 0.02) / 2)


def test_span_readers_read_nothing_without_the_programs_spans():
    t = Trace(window=(0.0, 1.0), steps=1, device=[("k", 0.1, 0.2)],
              host=[("gnnbench.step", 0.0, 0.5), ("cudaGraphLaunch", 0.1, 0.2)])
    for m in (step_check_ms_per_step, step_fill_ms_per_step):
        assert m.read(window(t)) is None and m.read(window(None)) is None


def test_input_copies_a_filled_call(monkeypatch):
    name = "ignnition_tpu_torch.utils.trace"
    monkeypatch.delitem(sys.modules, name, raising=False)
    assert input_copies_per_step.read(window(None)) is None  # a program without counters
    counts = {"capture.calls.warm_up": 1, "capture.calls.capture": 1,
              "capture.calls.replay": 9, "capture.input_copies": 450}
    program = types.SimpleNamespace(counters=lambda: dict(counts))
    monkeypatch.setitem(sys.modules, name, program)
    assert input_copies_per_step.read(window(None)) == 45.0
    counts.clear()
    counts["capture.calls.eager"] = 3
    assert input_copies_per_step.read(window(None)) is None  # nothing filled
    counts["capture.calls.replay"] = 2  # filled, and no copies counted
    with pytest.raises(RuntimeError, match="no input copies"):
        input_copies_per_step.read(window(None))
    counts.clear()  # the program loaded, and no call counted
    with pytest.raises(RuntimeError, match="counted no call"):
        input_copies_per_step.read(window(None))


LAUNCHES = {1: ("cudaGraphLaunch", -0.01, 0.0), 2: ("cudaMemcpyAsync", 0.5, 0.51)}


def test_a_gap_closed_by_a_late_launch_is_starved():
    device = [("graph node 1", 0.0, 0.2, 1), ("graph node 2", 0.3, 0.4, 1),
              ("Memcpy HtoD", 0.6, 0.7, 2)]
    r = idle.split((0.0, 1.0), device, LAUNCHES)
    assert r["matched"] == 1.0
    assert r["starved_s"] == pytest.approx(0.2)  # 0.4-0.6: launched at 0.5
    assert r["paused_s"] == pytest.approx(0.1)  # 0.2-0.3: launched before the gap
    assert r["tail_s"] == pytest.approx(0.3) and r["idle_s"] == pytest.approx(0.6)
    host = [("igt.capture.fill", 0.45, 0.55), ("igt.train.step", 0.4, 0.9),
            ("cudaMemcpyAsync", 0.5, 0.51)]
    assert idle.starved_by_span(r, host) == pytest.approx(
        {"igt.capture.fill / cudaMemcpyAsync": 0.2})
    assert idle.starved_by_span(r, host[2:]) == pytest.approx(
        {"(no program span) / cudaMemcpyAsync": 0.2})
    waits = [("cudaStreamSynchronize", 0.35, 0.41)] + host
    assert idle.starved_by_host_at_start(r, waits) == pytest.approx(
        {"cudaStreamSynchronize": 0.2})
    assert idle.starved_by_host_at_start(r, []) == pytest.approx({"(host idle)": 0.2})


def test_no_split_where_launches_go_unmatched():
    device = [("a", 0.0, 0.2, 1)] + [(f"k{i}", 0.3 + i / 100, 0.305 + i / 100, 7)
                                     for i in range(20)]
    r = idle.split((0.0, 1.0), device, LAUNCHES)
    assert r["matched"] == pytest.approx(1 / 21)
    assert r["starved_s"] is None and r["paused_s"] is None and r["starved"] == []
    assert r["idle_s"] > 0
