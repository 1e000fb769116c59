"""The port's roofline and memory model against the JAX package's (the
counterparts of `tests/test_roofline.py` and `tests/test_memory.py`), on
the CPU.

`train_step_cost`, `roofline_report` and `estimate_train_hbm` are copies:
on the same IR and the same `build_batch` meta (each package's own, from
the same seeded samples) every item equals the JAX package's at rtol 1e-12,
for the flagship, its attention and mlp_message variants, Q-size and
graphprop. Only the hardware differs: the H100's stated peaks, its floors
measured on the card, 80 GB of device memory.
"""

import copy
import logging
import os
import sys

import numpy as np
import pytest
import yaml

import ignnition_tpu_torch as igt
from ignnition_tpu.data import SampleSpec as JSampleSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data import synthetic as j_synthetic
from ignnition_tpu.data.graph import BatchMeta as JBatchMeta
from ignnition_tpu.frontend import parser as j_parser
from ignnition_tpu.utils import memory as j_memory
from ignnition_tpu.utils import roofline as j_roofline
from ignnition_tpu_torch.data import synthetic as t_synthetic
from ignnition_tpu_torch.data.graph import BatchMeta
from ignnition_tpu_torch.utils import memory as t_memory
from ignnition_tpu_torch.utils.roofline import HardwareSpec, roofline_report, train_step_cost

from helpers import qsize_description, routenet_description

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

DIMS = {"link_capacity": 1, "traffic": 1}
QSIZE_DIMS = {"link_capacity": 1, "traffic": 1, "queue_sizes": 1}
TIGHT = dict(rtol=1e-12, atol=0.0)


def _graphprop():
    with open(os.path.join(REPO, "examples", "graphprop", "model_description.yaml")) as f:
        return yaml.safe_load(f)


# model -> (description, dims, make the samples (package's synthetic module, rng))
MODELS = {
    "flagship": (lambda: chip_smoke.flagship_description(2, 32), DIMS,
                 lambda syn, rng: [syn.make_routenet_sample(rng, 40, 60, 6) for _ in range(3)]),
    "attention": (lambda: chip_smoke.attention_description(2, 32), DIMS,
                  lambda syn, rng: [syn.make_routenet_sample(rng, 40, 60, 6) for _ in range(3)]),
    "mlp_message": (lambda: chip_smoke.mlp_message_description(2, 32), DIMS,
                    lambda syn, rng: [syn.make_routenet_sample(rng, 40, 60, 6)
                                      for _ in range(3)]),
    "qsize": (lambda: qsize_description(num_iterations=2, hs=16), QSIZE_DIMS,
              lambda syn, rng: [syn.make_routenet_sample(rng, 30, 40, 4, with_nodes=True)
                                for _ in range(3)]),
    "graphprop": (_graphprop, {"x": 1, "cap": 1},
                  lambda syn, rng: [syn.make_graphprop_sample(rng, n_nodes=n)
                                    for n in (30, 40, 50)]),
}


def _both(name):
    """(JAX ir, port ir, meta) of one merged training batch of the model,
    each package building its own from the same seeded samples."""
    make_desc, dims, make = MODELS[name]
    out = []
    for parse, spec_cls, convert, syn, build in (
        (j_parser.parse_model_description, JSampleSpec, j_convert, j_synthetic, j_build_batch),
        (igt.parse_model_description, igt.SampleSpec, igt.convert_sample, t_synthetic,
         igt.build_batch),
    ):
        ir = parse(copy.deepcopy(make_desc()), dict(dims))
        spec = spec_cls.from_ir(ir)
        samples = [convert(s, spec) for s in make(syn, np.random.default_rng(0))]
        out.append((ir, build(samples, ir, training=True)[1]))
    (j_ir, j_meta), (t_ir, t_meta) = out
    assert repr(j_meta) == repr(t_meta)
    return j_ir, t_ir, j_meta, t_meta


def _assert_items(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TIGHT)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_cost_items_equal_the_jax_package(name):
    j_ir, t_ir, j_meta, t_meta = _both(name)
    for dtype_bytes in (2, 4):
        want = j_roofline.train_step_cost(j_ir, j_meta, dtype_bytes)
        got = train_step_cost(t_ir, t_meta, dtype_bytes)
        _assert_items(got.bytes_by, want.bytes_by)
        _assert_items(got.flops_by, want.flops_by)
        for field in ("gather_rows", "dense_attn_entry_passes", "segsum_rows"):
            np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                       err_msg=field, **TIGHT)
        assert got.rnn_scans == want.rnn_scans
    # the report's arithmetic is the copy: the same spec gives the same report
    spec = j_roofline.HardwareSpec()
    same = HardwareSpec(**{k: getattr(spec, k) for k in (
        "name", "hbm_gbps", "mxu_tflops_bf16", "gather_ns_per_row", "dense_attn_ps_per_entry",
        "rnn_scan_ps_per_elem", "rnn_scan_us_per_step", "segsum_ns_per_row")})
    assert roofline_report(t_ir, t_meta, 10.0, hw=same) == j_roofline.roofline_report(
        j_ir, j_meta, 10.0, hw=spec)


def _assert_memory_items(got: dict, want: dict):
    """The JAX package's items, and the card's cuBLAS workspaces on top of
    its total (the JAX package has no such term)."""
    library = got.pop("library_workspace_bytes")
    assert library == t_memory.LIBRARY_WORKSPACE_BYTES == 2 * 32 * 2**20
    got["total_bytes"] -= library
    _assert_items(got, want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_memory_items_equal_the_jax_package(name):
    j_ir, t_ir, j_meta, t_meta = _both(name)
    for batch_bytes in (None, 12345.0):
        want = j_memory.estimate_train_hbm(j_ir, j_meta, batch_bytes=batch_bytes)
        got = t_memory.estimate_train_hbm(t_ir, t_meta, batch_bytes=batch_bytes)
        _assert_memory_items(got, want)


def test_h100_spec():
    """The stated peaks, and floors that are the card's (no TPU default):
    the row gather's is its byte bound (a 64-byte row read and written, its
    int64 index read, at 3.35 TB/s)."""
    hw = HardwareSpec()
    assert (hw.name, hw.hbm_gbps, hw.mxu_tflops_bf16, hw.tflops_f32) == (
        "H100", 3350.0, 989.0, 67.0)
    assert hw.gather_ns_per_row == pytest.approx(136 / 3350.0, rel=1e-12)
    tpu = j_roofline.HardwareSpec()
    for field in ("gather_ns_per_row", "dense_attn_ps_per_entry", "rnn_scan_ps_per_elem",
                  "rnn_scan_us_per_step", "segsum_ns_per_row"):
        assert 0 < getattr(hw, field) != getattr(tpu, field), field
    assert t_memory.DEFAULT_HBM_GB == 80.0
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in HardwareSpec.__doc__


# --------------------------------------------------------------------------
# the counterparts of tests/test_roofline.py, on the port
# --------------------------------------------------------------------------

RL_DIMS = {"link_capacity": 1, "traffic": 1, "adj_links_paths": 0, "adj_paths_links": 0}


def _rl_meta(desc):
    ir = igt.parse_model_description(copy.deepcopy(desc), dict(RL_DIMS))
    sample = {
        "entities": {"l0": "link", "l1": "link", "p0": "path", "p1": "path"},
        "link_capacity": [1.0, 2.0], "traffic": [0.5, 0.6],
        "delay": [0.1, 0.2],
        "adj_links_paths": {"p0": ["l0", "l1"], "p1": ["l1"]},
        "adj_paths_links": {"l0": ["p0"], "l1": ["p0", "p1"]},
    }
    _, meta = igt.build_batch([igt.convert_sample(sample, igt.SampleSpec.from_ir(ir))], ir)
    return ir, meta


def test_itemization_sums_and_bounds():
    ir, meta = _rl_meta(routenet_description(num_iterations=4, hs=16))
    c = train_step_cost(ir, meta)
    assert c.total_bytes == pytest.approx(sum(c.bytes_by.values()))
    assert c.total_flops == pytest.approx(sum(c.flops_by.values()))
    assert c.total_bytes > 0 and c.total_flops > 0 and c.gather_rows > 0
    assert c.rnn_scans and all(len(t) == 5 for t in c.rnn_scans)
    assert "seq_stream" not in c.bytes_by
    assert "node_tables" in c.bytes_by
    b = c.bound_seconds(HardwareSpec())
    assert b["sol_ms"] == pytest.approx(max(b["t_bytes_ms"], b["t_flops_ms"]))
    assert b["t_bytes_ms"] == pytest.approx(c.total_bytes / 3.35e12 * 1e3)


def test_iterations_scale_iteration_rate_items():
    c2 = train_step_cost(*_rl_meta(routenet_description(num_iterations=2, hs=16)))
    c4 = train_step_cost(*_rl_meta(routenet_description(num_iterations=4, hs=16)))
    (l2, e2, w2, i2, g2), = c2.rnn_scans
    (l4, e4, w4, i4, g4), = c4.rnn_scans
    assert (l4, e4, w4, g4) == (l2, e2, w2, g2) and i4 == 2 * i2
    assert c4.gather_rows == pytest.approx(2 * c2.gather_rows)
    assert c4.flops_by["readout"] == pytest.approx(c2.flops_by["readout"])


def test_per_edge_messages_cost_more_than_direct():
    base = routenet_description(num_iterations=4, hs=16)
    peredge = copy.deepcopy(base)
    peredge["neural_networks"].append({
        "nn_name": "msg", "nn_type": "feed_forward",
        "nn_architecture": [
            {"type_layer": "Dense", "units": 16, "activation": "relu"},
            {"type_layer": "Dense", "units": 16, "activation": "None"},
        ],
    })
    for stage in peredge["message_passing"]["stages"]:
        for mp in stage["stage_mp"]:
            for se in mp["source_entities"]:
                se["message"] = [{"type": "neural_network", "nn_name": "msg",
                                  "input": ["hs_source", "hs_dest"]}]
    cb = train_step_cost(*_rl_meta(base))
    cp = train_step_cost(*_rl_meta(peredge))
    assert cp.total_bytes > cb.total_bytes
    assert cp.total_flops > cb.total_flops
    assert cp.gather_rows > cb.gather_rows
    assert "message_mlp" in cp.flops_by and "edge_stream" in cp.bytes_by


def test_report_fields_and_percentages():
    ir, meta = _rl_meta(routenet_description(num_iterations=4, hs=16))
    rep = roofline_report(ir, meta, measured_ms=10.0)
    for k in ("sol_ms", "sol_pct", "apsol_ms", "apsol_pct", "binding",
              "bytes_items_mb", "flops_items_g", "gather_rows_m"):
        assert k in rep
    assert rep["hw"] == "H100"
    assert rep["apsol_ms"] >= rep["sol_ms"]
    assert rep["sol_pct"] == pytest.approx(100 * rep["sol_ms"] / 10.0, rel=1e-3)


def test_flops_are_charged_at_the_peak_of_the_steps_dtype():
    """A 2-byte step's FLOPs at the bf16 peak, a 4-byte step's at the f32
    peak; the bytes bound at the HBM rate either way."""
    ir, meta = _rl_meta(routenet_description(num_iterations=4, hs=16))
    hw = HardwareSpec()
    for dtype_bytes, peak in ((2, 989e12), (4, 67e12)):
        c = train_step_cost(ir, meta, dtype_bytes)
        rep = roofline_report(ir, meta, 10.0, dtype_bytes=dtype_bytes)
        b = c.bound_seconds(hw, dtype_bytes)
        assert b["t_flops_ms"] == pytest.approx(c.total_flops / peak * 1e3, rel=1e-12)
        assert b["t_bytes_ms"] == pytest.approx(c.total_bytes / 3.35e12 * 1e3, rel=1e-12)
        assert rep["t_flops_ms"] == round(b["t_flops_ms"], 3)
    f32 = train_step_cost(ir, meta, 4)
    assert f32.bound_seconds(hw, 4)["t_flops_ms"] == pytest.approx(
        f32.bound_seconds(hw)["t_flops_ms"] * 989.0 / 67.0, rel=1e-12)


def test_rnn_scan_floor_term():
    ir, meta = _rl_meta(routenet_description(num_iterations=4, hs=16))
    rep = roofline_report(ir, meta, measured_ms=10.0)
    assert rep["rnn_scan_ms"] > 0
    hw = HardwareSpec()
    c = train_step_cost(ir, meta)
    expect = sum(
        iters * max(L * hw.rnn_scan_us_per_step * 1e-3,
                    e * w * g * hw.rnn_scan_ps_per_elem * 1e-9)
        for (L, e, w, iters, g) in c.rnn_scans
    )
    assert rep["rnn_scan_ms"] == pytest.approx(expect, rel=1e-2)
    assert rep["apsol_ms"] == pytest.approx(
        max(rep["sol_ms"], rep["gather_floor_ms_informational"] + rep["segsum_ms"])
        + rep["dense_attn_ms"] + rep["rnn_scan_ms"], rel=1e-2, abs=2e-3)


# --------------------------------------------------------------------------
# the counterparts of tests/test_memory.py, on the port
# --------------------------------------------------------------------------


def _flagship_ir():
    return igt.parse_model_description(
        copy.deepcopy(routenet_description(num_iterations=8, hs=32)), dict(DIMS))


def _meta(x, cls=BatchMeta):
    n_links, n_paths, e = 2048 * x, 16384 * x, 131072 * x
    return cls(
        num_graphs=1,
        node_pad=(("link", n_links), ("path", n_paths)),
        edge_pad=(("adj_links_paths", e), ("adj_paths_links", e)),
        max_len=(("adj_links_paths", 8), ("adj_paths_links", 96)),
        label_pad=n_paths,
    )


def test_estimate_scales_and_itemizes():
    ir = _flagship_ir()
    small = t_memory.estimate_train_hbm(ir, _meta(1))
    big = t_memory.estimate_train_hbm(ir, _meta(16))
    assert set(small) == {"params_bytes", "batch_bytes", "residual_bytes", "dense_inc_bytes",
                          "workspace_bytes", "library_workspace_bytes", "total_bytes"}
    assert small["total_bytes"] == pytest.approx(
        sum(v for k, v in small.items() if k != "total_bytes"))
    assert big["residual_bytes"] > 10 * small["residual_bytes"]
    j_ir = j_parser.parse_model_description(
        copy.deepcopy(routenet_description(num_iterations=8, hs=32)), dict(DIMS))
    _assert_memory_items(small, j_memory.estimate_train_hbm(j_ir, _meta(1, JBatchMeta)))


def test_recommended_shards():
    assert t_memory.recommended_shards(1e9) == 1
    assert t_memory.recommended_shards(60e9) == 1  # within 83% of 80 GB
    assert t_memory.recommended_shards(70e9) == 2  # past it
    assert t_memory.recommended_shards(140e9) == 4
    assert t_memory.recommended_shards(0.9 * 80e9) == 2
    assert t_memory.recommended_shards(20e9, hbm_gb=16.0) == 2


def test_capacity_warning_fires_only_when_too_big(caplog):
    ir = _flagship_ir()
    log = logging.getLogger("test_capacity")
    with caplog.at_level(logging.WARNING, logger="test_capacity"):
        assert t_memory.maybe_warn_capacity(ir, _meta(1), log=log) == 1
    assert not caplog.records
    with caplog.at_level(logging.WARNING, logger="test_capacity"):
        assert t_memory.maybe_warn_capacity(ir, _meta(512), log=log) > 1
    (rec,) = caplog.records
    assert "model_strategy='dest_shard'" in rec.getMessage()
    assert "Trainer.train(mesh=..., model_strategy='dest_shard')" in rec.getMessage()
    assert "not ported" not in rec.getMessage()


def test_trainer_warns_before_a_too_big_meta_once():
    """`Trainer.train_step_fn` estimates a meta's footprint before its first
    step, as the JAX trainer does: a warning for a meta one card cannot
    hold, once; none for one it can."""
    trainer = igt.Trainer(igt.build(_flagship_ir()), device="cpu")
    logger = logging.getLogger("ignnition_tpu_torch")
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = seen.append
    logger.addHandler(handler)
    try:
        trainer.train_step_fn(_meta(1))
        assert not seen
        trainer.train_step_fn(_meta(512))
        trainer.train_step_fn(_meta(512))
    finally:
        logger.removeHandler(handler)
    assert len(seen) == 1 and "exceeds the usable 83%" in seen[0].getMessage()
