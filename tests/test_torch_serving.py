"""The port's serving artifacts on the CPU: `export_serving` -> `load_serving`
against `GnnModel.apply`, the in-process `ServingModel` and the JAX
package's own artifact, at hs=8 with 2 iterations (as tests/test_serving.py).

Each case takes one kernel operator into the exported program: the flagship
(stage 1 ordered: `masked_gru_scan`, kernel B), attention per edge (the CSR
sums, kernel A) and over the dense incidence (`flash_gat_forward`, kernel
D), Q-size's interleave (B through the combined slice map) and linkpred (an
edge-domain label, trimmed through `label_perm`). The reloaded program runs
the same operations in the same order as the forward it was exported from,
so f32 agrees at 1e-6 (bitwise in practice); against the JAX package's
reloaded artifact at 1e-4."""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

import ignnition_tpu_torch as igt
from ignnition_tpu.model import build as j_build
from ignnition_tpu.serving import export_serving as j_export
from ignnition_tpu.serving import load_serving as j_load
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.config import RunConfig
from ignnition_tpu_torch.data.graph import PaddingConfig
from ignnition_tpu_torch.data.synthetic import write_dataset
from ignnition_tpu_torch.serving import (
    LoadedServingModel,
    export_serving,
    kernel_ops,
    load_serving,
)

from helpers import routenet_description
from test_torch_model import (
    ATTENTION_BRANCHES, BRANCHES, QSIZE_BRANCHES, flagship_dict, prepared_batches, qsize_dict,
    to_attention,
)
from test_torch_readout import case_batches

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)
JAX_TOL = dict(atol=1e-4, rtol=1e-4)
NON_INPUT = ("label", "label_mask", "label_perm")


def _model_case(desc, entry):
    def make(monkeypatch):
        j_ir, t_ir, j_arrays, t_arrays, meta = prepared_batches(desc(), entry, monkeypatch)
        return desc(), j_ir, t_ir, j_arrays, t_arrays, meta
    return make


def _readout_case(name):
    def make(monkeypatch):
        j_ir, t_ir, j_arrays, t_arrays, meta = case_batches(name, monkeypatch, training=False)
        from test_torch_readout import CASES

        return CASES[name][0](), j_ir, t_ir, j_arrays, t_arrays, meta
    return make


# case -> (batch maker, the kernel operators of its program)
CASES = {
    "flagship": (_model_case(flagship_dict, BRANCHES["csr_sliced"]),
                 {"masked_gru_scan": 2, "csr_segment_sum": 2}),
    "attention_edges": (_model_case(lambda: flagship_dict(mutate=to_attention),
                                    ATTENTION_BRANCHES["edges"]),
                        {"masked_gru_scan": 2, "csr_segment_sum": 4}),
    "attention_dense": (_model_case(lambda: flagship_dict(mutate=to_attention),
                                    ATTENTION_BRANCHES["dense"]),
                        {"masked_gru_scan": 2, "flash_gat_forward": 2}),
    "qsize_interleave": (_model_case(qsize_dict, QSIZE_BRANCHES["fast"]),
                         {"masked_gru_scan": 2}),
    "linkpred": (_readout_case("linkpred_csr_padded"), {"csr_segment_sum": 2}),
}


def _case(name, monkeypatch):
    """(description, JAX ir, port ir, JAX params, JAX arrays, port arrays,
    meta) of a case, its knobs patched in both packages."""
    desc, j_ir, t_ir, j_arrays, t_arrays, meta = CASES[name][0](monkeypatch)
    j_params = j_build(j_ir).init(jax.random.PRNGKey(0))
    return desc, j_ir, t_ir, j_params, j_arrays, t_arrays, meta


def _apply(t_ir, params, arrays, meta):
    model = igt.build(t_ir)
    inputs = to_device({k: v for k, v in arrays.items() if k not in NON_INPUT}, "cpu")
    with torch.no_grad():
        return model.apply(params, inputs, meta).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_artifact_matches_apply_and_in_process_serving(name, monkeypatch, tmp_path):
    desc, _, t_ir, j_params, _, arrays, meta = _case(name, monkeypatch)
    params = igt.params_from_jax(j_params)
    out = export_serving(igt.build(t_ir), params, meta, arrays, str(tmp_path / "a"),
                         description=desc, device="cpu")
    sm = load_serving(out, device="cpu")
    got = sm.predict(arrays, denormalize=False)
    np.testing.assert_allclose(got, _apply(t_ir, params, arrays, meta), **TOL)
    server = igt.ServingModel(igt.build(t_ir), params, meta, t_ir, compute_dtype=None,
                              device="cpu")
    np.testing.assert_allclose(got, server.predict(arrays, denormalize=False), **TOL)
    np.testing.assert_array_equal(sm.trim(got, arrays), server.trim(got, arrays))
    assert sm.label_domain == server.label_domain and sm.label_name == server.label_name
    # the kernels stay in the graph as the port's operators
    ops = kernel_ops(sm.program)
    assert {op: ops.count(op) for op in set(ops)} == CASES[name][1]
    targets = {str(n.target) for n in sm.program.graph.nodes if n.op == "call_function"}
    assert {f"ignnition_tpu_torch.{op}.default" for op in CASES[name][1]} <= targets


def test_edge_domain_artifact_trims_through_label_perm(monkeypatch, tmp_path):
    """linkpred's artifact serves raw samples: one prediction per real edge,
    in each sample's insertion order (`label_perm`), as `ServingModel`."""
    from ignnition_tpu_torch.data import synthetic as t_synthetic

    desc, _, t_ir, j_params, _, arrays, meta = _case("linkpred", monkeypatch)
    params = igt.params_from_jax(j_params)
    sm = load_serving(export_serving(igt.build(t_ir), params, meta, arrays,
                                     str(tmp_path / "a"), description=desc, device="cpu"),
                      device="cpu")
    rng = np.random.default_rng(0)
    spec = igt.SampleSpec.from_ir(t_ir)
    raws = [t_synthetic.make_linkpred_sample(rng, n_nodes=n) for n in (10, 14, 12)]
    samples = [igt.convert_sample(r, spec) for r in raws]
    got = sm.predict_samples(samples)
    assert got.shape == (sum(len(v) for r in raws for v in r["adj_nodes_nodes"].values()),)
    server = igt.ServingModel(igt.build(t_ir), params, meta, t_ir, compute_dtype=None,
                              device="cpu")
    np.testing.assert_allclose(got, server.predict_samples(samples), **TOL)
    batch = sm.build_batch(samples)
    preds = sm.predict(batch)
    np.testing.assert_array_equal(got, preds[batch["label_perm"]][: got.shape[0]])


# --------------------------------------------------------------------------
# the JAX package's artifact
# --------------------------------------------------------------------------


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_artifact_matches_the_jax_artifact(name, monkeypatch, tmp_path):
    """The same weights through `params_from_jax`, the same batch: the two
    reloaded artifacts predict alike, and every file but the program reads
    the same."""
    desc, j_ir, t_ir, j_params, j_arrays, t_arrays, meta = _case(name, monkeypatch)
    j_out = j_export(j_build(j_ir), j_params, meta, j_arrays, str(tmp_path / "jax"),
                     description=copy.deepcopy(desc))
    t_out = export_serving(igt.build(t_ir), igt.params_from_jax(j_params), meta, t_arrays,
                           str(tmp_path / "torch"), description=copy.deepcopy(desc),
                           device="cpu")
    want = j_load(j_out).predict(j_arrays, denormalize=False)
    got = load_serving(t_out, device="cpu").predict(t_arrays, denormalize=False)
    np.testing.assert_allclose(got, want, **JAX_TOL)

    with np.load(os.path.join(j_out, "params.npz")) as j, \
            np.load(os.path.join(t_out, "params.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
            np.testing.assert_array_equal(j[k], t[k])
    for f in ("params_tree.json", "meta.json", "model_description.json"):
        assert _json(os.path.join(t_out, f)) == _json(os.path.join(j_out, f)), f
    j_man = _json(os.path.join(j_out, "MANIFEST.json"))
    t_man = _json(os.path.join(t_out, "MANIFEST.json"))
    for k in ("format", "inputs", "label_name", "label_domain", "denormalization"):
        assert t_man[k] == j_man[k], k
    assert t_man["platforms"] == ["cpu"] and t_man["torch_version"] == torch.__version__
    # the program without the batch it was traced on
    assert torch.export.load(os.path.join(t_out, "forward.pt2")).example_inputs is None
    with pytest.raises(ValueError, match="not an artifact of ignnition_tpu_torch"):
        load_serving(j_out, device="cpu")


# --------------------------------------------------------------------------
# inputs, pinned batches, the Runner, devices (tests/test_serving.py's cases)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_ds")
    write_dataset(str(d), num_archives=2, samples_per_archive=6, seed=11)
    return str(d)


@pytest.fixture(scope="module")
def routenet(dataset, tmp_path_factory):
    """The routenet description with an `exp` denormalization, its model,
    parameters, samples, a batch of 4 and that batch's artifact."""
    desc = routenet_description(num_iterations=2, hs=8)
    for op in desc["readout"]:
        if op["type"] == "predict":
            op["label_denormalization"] = "exp"
    ir = igt.parse_model_description(desc, {"link_capacity": 1, "traffic": 1})
    model = igt.build(ir)
    params = model.init(torch.Generator().manual_seed(0))
    spec = igt.SampleSpec.from_ir(ir, training=False)
    samples = list(igt.iter_samples(dataset, spec))
    arrays, meta = igt.build_batch(samples[:4], ir, padding=PaddingConfig(min_size=16))
    out = export_serving(model, params, meta, arrays,
                         str(tmp_path_factory.mktemp("routenet") / "artifact"),
                         description=desc, device="cpu")
    return ir, params, spec, samples, arrays, meta, out


def test_serving_input_checks_and_denormalization(routenet):
    ir, params, spec, samples, arrays, meta, out = routenet
    sm = load_serving(out, device="cpu")
    want = _apply(ir, params, arrays, meta)
    np.testing.assert_allclose(sm.predict(arrays), np.exp(want), rtol=1e-5)
    assert sm.trim(want, arrays).shape[0] == int(np.sum(arrays["node_mask_path"] > 0))
    man = sm.manifest
    assert man["label_name"] == "delay"
    assert "label" not in man["inputs"] and "label_mask" not in man["inputs"]
    assert sm.expected_inputs()["traffic"] == (tuple(arrays["traffic"].shape), "float32")

    bad = dict(arrays)
    bad.pop("traffic")
    with pytest.raises(ValueError, match="missing input 'traffic'"):
        sm.predict(bad)
    bad = dict(arrays)
    bad["traffic"] = np.zeros((3, 1), np.float32)
    with pytest.raises(ValueError, match="exported for"):
        sm.predict(bad)


def test_serving_smaller_samples_pinned_batch(routenet, tmp_path):
    """Smaller new samples batch to the exported shapes through
    build_batch(target=meta) and serve as apply does on the pinned arrays,
    sample for sample as an unpinned batch."""
    ir, params, spec, samples, arrays, meta, out = routenet
    sm = load_serving(out, device="cpu")
    write_dataset(str(tmp_path / "small"), num_archives=1, samples_per_archive=4, seed=5,
                  n_links=8, n_paths=6)
    small = list(igt.iter_samples(str(tmp_path / "small"), spec))
    pinned, pinned_meta = igt.build_batch(small[:4], ir, training=False, target=meta)
    assert pinned_meta == meta
    got = sm.predict(pinned, denormalize=False)
    np.testing.assert_allclose(got, _apply(ir, params, pinned, meta), **TOL)
    free, free_meta = igt.build_batch(small[:4], ir, training=False)
    free_preds = _apply(ir, params, free, free_meta)
    np.testing.assert_allclose(got[pinned["node_mask_path"] > 0],
                               free_preds[free["node_mask_path"] > 0], rtol=1e-5, atol=1e-6)
    served = sm.predict_samples(small[:4], denormalize=False)
    np.testing.assert_allclose(served, got[pinned["node_mask_path"] > 0], **TOL)
    with pytest.raises(ValueError, match="graphs per batch"):
        igt.build_batch(samples[:2], ir, training=False, target=meta)


def test_runner_export_serving_matches_runner_predict(dataset, tmp_path):
    json_path = tmp_path / "model_description.json"
    json_path.write_text(json.dumps(routenet_description(num_iterations=2, hs=8)))
    cfg = RunConfig(
        train_dataset=dataset, eval_dataset=dataset, predict_dataset=dataset,
        json_path=str(json_path), model_dir=str(tmp_path / "ckpts"),
        debug_dir=str(tmp_path / "debug"), batch_size=2, train_steps=2, eval_samples=1,
        save_checkpoints_secs=10_000, throttle_secs=10_000,
    )
    model = igt.create_model(cfg)
    runner = igt.Runner(model, padding=PaddingConfig(min_size=16), device="cpu")
    state = runner.train_and_evaluate(str(tmp_path / "run"))
    sm = igt.load_serving(runner.export_serving(str(tmp_path / "artifact"), state=state),
                          device="cpu")
    assert isinstance(sm, igt.LoadedServingModel)
    arrays, _ = next(iter(runner.trainer.batches(dataset, 2, shuffle=False, repeat=False,
                                                 training=False)))
    preds = sm.trim(sm.predict(arrays), arrays)
    ref = runner.predict(state)[0]
    np.testing.assert_allclose(preds[: len(ref)], ref, rtol=1e-5, atol=1e-6)
    # the parameters of the config's warm start, as the JAX Runner takes them
    cfg.warm_start_path = str(tmp_path / "run")
    sm2 = igt.load_serving(igt.Runner(model, padding=PaddingConfig(min_size=16), device="cpu")
                           .export_serving(str(tmp_path / "artifact2")), device="cpu")
    np.testing.assert_allclose(sm2.predict(arrays), sm.predict(arrays), **TOL)


def test_artifact_keeps_to_its_device(routenet, tmp_path):
    """An artifact runs on the device type it was exported on: a `cuda` one
    refuses the CPU, naming the platform, and without a CUDA device the
    default device raises."""
    import shutil

    out = routenet[-1]
    cuda_out = str(tmp_path / "cuda")
    shutil.copytree(out, cuda_out)
    man = _json(os.path.join(cuda_out, "MANIFEST.json"))
    man["platforms"] = ["cuda"]
    with open(os.path.join(cuda_out, "MANIFEST.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match=r"exported for \['cuda'\] and cannot run on cpu"):
        load_serving(cuda_out, device="cpu")
    # the class itself keeps to the same rules when built directly
    sm = load_serving(out, device="cpu")
    with pytest.raises(ValueError, match=r"exported for \['cuda'\] and cannot run on cpu"):
        LoadedServingModel(sm.program, sm.params, sm.meta, man, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load_serving(out)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            LoadedServingModel(sm.program, sm.params, sm.meta, sm.manifest)
