"""The counts of work against hand counts at a tiny size, and the per-layer
readers on a made-up trace."""

import json
import math

import numpy as np
import pytest

from gnnbench import counts, harness, peaks
from gnnbench.cost import routenet as cost_routenet
from gnnbench.metrics import (device_idle_pct, gather_ms_per_step, gru_scan_roofline,
                              host_ms_per_step, input_copy_ms_per_step, mfu_roofline_pct,
                              segsum_roofline)
from gnnbench.reference import routenet as ref_routenet
from gnnbench.trace import Trace

I32 = np.int32


def config(name):
    with open(harness.HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def routes_sample():
    """3 links, 2 paths: path 0 crosses links 0 then 1, path 1 link 2."""
    lp = (np.array([0, 1, 2], I32), np.array([0, 0, 1], I32), np.array([0, 1, 0], I32))
    pl = (np.array([0, 0, 1], I32), np.array([0, 1, 2], I32), np.array([0, 0, 0], I32))
    return {"num_nodes": {"link": 3, "path": 2},
            "features": {"link_capacity": np.ones((3, 1), np.float32),
                         "traffic": np.ones((2, 1), np.float32)},
            "adjacencies": {"adj_links_paths": lp, "adj_paths_links": pl},
            "label": np.ones(2, np.float32)}


def test_edge_messages():
    # 8 iterations x (3 link-path edges + 3 path-link edges); 3 x (6 + 6)
    assert counts.edge_messages([routes_sample()], config("routenet")["description"]) == 48


def test_routenet_step_cost():
    c = cost_routenet.step([routes_sample()], config("routenet"))
    gru_row = 2 * 96 * 64  # x @ K and h @ R, 96 outputs of 32 + 32 inputs
    readout_row = 2 * (32 * 256 + 256 * 256 + 256 * 1)
    assert c["flops"] == 3 * (8 * gru_row * (3 + 3) + readout_row * 2)
    weights = sum(math.prod(s) for s, _ in ref_routenet.param_spec(config("routenet")).values())
    assert weights == 87169
    e = peaks.ELEMENT[config("routenet")["compute_dtype"]]
    per_pass = 2 * ((3 + 2) * 32 * e + 3 * 8)
    assert c["bytes"] == 8 * 2 * per_pass + (3 + 2 * 2) * 4 + 28 * weights


def test_gru_scan_required():
    ops, n_bytes = cost_routenet.gru_scans([routes_sample()], config("routenet"))
    e = peaks.ELEMENT[config("routenet")["compute_dtype"]]
    weights = (32 * 96 * 2 + 2 * 96) * e
    assert ops == 8 * 3 * (2 * 96 * 64 * 3)
    fwd = (3 * 32 + 2 * 2 * 32) * e + 2 * 4 + weights
    first = (3 * 32 + 2 * 2 * 32) * e + 2 * 4 + 2 * weights
    later = (3 * 32 + 2 * 2 * 32 + 3 * 32 + 2 * 32) * e + 2 * 4 + 2 * weights
    assert n_bytes == 8 * fwd + first + 7 * later


def test_segment_sums():
    # the 7 transposes of the link-to-path gathers: 3 edge rows into 3 links
    e = peaks.ELEMENT[config("routenet")["compute_dtype"]]
    one = 3 * 32 * e + 3 * 4 + 3 * 32 * e
    assert cost_routenet.segment_sums([routes_sample()], config("routenet")) == [one] * 7


def window(trace=None, cfg=None):
    raws = [[routes_sample()]]
    cfg = cfg or config("routenet")
    cost = cost_routenet.step(raws[0], config("routenet"))
    return harness.Window(cfg, 1, raws, [cost], order=[0, 0], window_s=0.5,
                          host_step_s=[0.001, 0.003], trace=trace, traced_order=[0, 0])


def test_readers_on_a_made_up_trace():
    t = Trace(window=(10.0, 11.0), steps=2, device=[
        ("masked_gru_scan_mma_kernel", 10.1, 10.3),
        ("gru_bwd_sweep_mma_kernel", 10.2, 10.5),
        ("Memcpy DtoD (Device -> Device)", 10.7, 10.8),
        ("void at::native::indexSelectLargeIndex<float>", 10.85, 10.9),
        ("segment_sum_kernel<1>", 10.9, 10.95),
    ], host=[("gnnbench.step", 10.0, 10.6), ("cudaGraphLaunch", 10.55, 10.6)])
    w = window(t)
    assert device_idle_pct.read(w) == pytest.approx(100 * (1 - (0.4 + 0.1 + 0.1)))
    assert input_copy_ms_per_step.read(w) == pytest.approx(1e3 * 0.1 / 2)
    assert gather_ms_per_step.read(w) == pytest.approx(1e3 * 0.05 / 2)
    assert host_ms_per_step.read(w) == pytest.approx(2.0)
    ops, n_bytes = cost_routenet.gru_scans(w.raws[0], w.config)
    assert gru_scan_roofline.read(w) == pytest.approx(100 * 2 * peaks.bound_s(ops, n_bytes, "float32") / (0.2 + 0.3))
    sums = cost_routenet.segment_sums(w.raws[0], w.config)  # counted whole, whatever the launches
    want = 2 * sum(sums) / peaks.HBM_BYTES
    assert segsum_roofline.read(w) == pytest.approx(100 * want / 0.05)
    c = w.costs[0]
    assert mfu_roofline_pct.read(w) == pytest.approx(
        100 * 2 * peaks.bound_s(c["flops"], c["bytes"], "float32") / 0.5)
    gaps = dict(t.breakdown()["idle_gaps"])  # by the innermost host work at each gap's middle
    assert gaps == pytest.approx({"cudaGraphLaunch": 0.2, "gnnbench.step": 0.1,
                                  "(host idle)": 0.05 + 0.05})


def test_readers_without_a_trace_or_their_kernels():
    w = window(None)
    for m in (device_idle_pct, input_copy_ms_per_step, gather_ms_per_step, gru_scan_roofline,
              segsum_roofline):
        assert m.read(w) is None
    empty = window(Trace(window=(0.0, 1.0), steps=1, device=[("other", 0.1, 0.2)]))
    assert gru_scan_roofline.read(empty) is None and segsum_roofline.read(empty) is None
    assert gather_ms_per_step.read(empty) == 0.0 and input_copy_ms_per_step.read(empty) == 0.0


@pytest.mark.parametrize("work, metric", [("segment_sums", segsum_roofline),
                                          ("gru_scans", gru_scan_roofline)])
def test_a_configuration_without_the_work_reads_nothing(monkeypatch, work, metric):
    t = Trace(window=(10.0, 11.0), steps=1, device=[("masked_gru_scan_mma_kernel", 10.1, 10.3),
                                                    ("segment_sum_kernel<1>", 10.4, 10.5)])
    assert metric.read(window(t)) > 0
    monkeypatch.delattr(cost_routenet, work)
    assert metric.read(window(t)) is None
