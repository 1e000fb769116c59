"""The port's host layer against the JAX package's: imports without JAX and
without the JAX package, its own host code giving the same IR and the same
`build_batch` arrays, device conversion, the entry points' default device,
and the chip smoke script's refusal to run without a GPU."""

import copy
import os
import pathlib
import re
import shutil
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import ignnition_tpu_torch as igt
from ignnition_tpu.data import SampleSpec as JSampleSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data.graph import PaddingConfig as JPadding
from ignnition_tpu.data.synthetic import make_routenet_sample as j_make_sample
from ignnition_tpu.frontend import parse_model_description as j_parse
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data.graph import PaddingConfig
from ignnition_tpu_torch.data.synthetic import make_routenet_sample

from __graft_entry__ import _flagship
from helpers import dense, qsize_description, routenet_description

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
DIMS = {"link_capacity": 1, "traffic": 1}


def flagship_dict(num_iterations=2, hs=8):
    captured = []
    _flagship(num_iterations, hs, mutate=lambda d: captured.append(copy.deepcopy(d)))
    return captured[0]


DESCRIPTIONS = {
    "flagship": lambda: flagship_dict(),
    "routenet": lambda: routenet_description(),
}


def _run(code, cwd=REPO, env=None):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
        timeout=240, env=env,
    )


def test_port_imports_with_jax_blocked():
    proc = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import ignnition_tpu_torch\n"
        "import ignnition_tpu_torch.model, ignnition_tpu_torch.serving\n"
        "import ignnition_tpu_torch.ops, ignnition_tpu_torch.ops.segment\n"
        "import ignnition_tpu_torch.ops.cuda.segment_kernels\n"
        "import ignnition_tpu_torch.ops.cuda.rnn_kernels\n"
        "import ignnition_tpu_torch.ops.cuda, ignnition_tpu_torch.ops.cuda.attention_kernels\n"
        "import ignnition_tpu_torch.nn, ignnition_tpu_torch.nn.rnn\n"
        "import ignnition_tpu_torch.model.builder, ignnition_tpu_torch.training.capture\n"
        "import ignnition_tpu_torch.batch\n"
        "import ignnition_tpu_torch.training, ignnition_tpu_torch.training.trainer\n"
        "import ignnition_tpu_torch.training.losses, ignnition_tpu_torch.training.metrics\n"
        "import ignnition_tpu_torch.training.optimizers\n"
        "import ignnition_tpu_torch.data.kdn, ignnition_tpu_torch.data.native_loader\n"
        "import ignnition_tpu_torch.api, ignnition_tpu_torch.config\n"
        "import ignnition_tpu_torch.training.packing, ignnition_tpu_torch.parallel\n"
        "import ignnition_tpu_torch.parallel.mesh, ignnition_tpu_torch.parallel.distributed\n"
        "import ignnition_tpu_torch.parallel.steps, ignnition_tpu_torch.ops._collectives\n"
        "import ignnition_tpu_torch.parallel.edgeshard, ignnition_tpu_torch.parallel.locality\n"
        "import ignnition_tpu_torch.utils.roofline, ignnition_tpu_torch.utils.memory\n"
        "import ignnition_tpu_torch.examples.routenet, ignnition_tpu_torch.examples.qsize\n"
        "import ignnition_tpu_torch.examples.graphprop, ignnition_tpu_torch.examples.linkpred\n"
        "import ignnition_tpu_torch.examples.gat\n"
        "ignnition_tpu_torch.create_model, ignnition_tpu_torch.Runner\n"
        "bad = [m for m in sys.modules if m == 'ignnition_tpu' or m.startswith('ignnition_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = sorted((REPO / "ignnition_tpu_torch").rglob("*.py"))
    assert files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
    assert not pattern.search((REPO / "chip_smoke.py").read_text())


def test_port_modules_live_in_the_port():
    """No module of the port is loaded from, or searches, the JAX package's
    directory: the host code is the port's own files."""
    import importlib
    import pkgutil

    jax_pkg = (REPO / "ignnition_tpu").resolve()
    names = [m.name for m in pkgutil.walk_packages(igt.__path__, "ignnition_tpu_torch.")]
    assert "ignnition_tpu_torch.frontend.parser" in names
    assert "ignnition_tpu_torch.data.graph" in names
    assert "ignnition_tpu_torch._shared" not in names
    for name in ["ignnition_tpu_torch"] + names:
        mod = importlib.import_module(name)
        places = [mod.__file__] + list(getattr(mod, "__path__", []))
        for place in places:
            assert jax_pkg not in pathlib.Path(place).resolve().parents, (name, place)
            assert pathlib.Path(place).resolve() != jax_pkg, (name, place)
    # nor reads source from there
    for f in (REPO / "ignnition_tpu_torch").rglob("*.py"):
        assert "JAX_PACKAGE_DIR" not in f.read_text(), f


def test_entry_points_default_to_the_gpu_and_raise_without_one():
    """Here there is no CUDA device: `ServingModel` and `Trainer` without
    `device` raise and name the argument for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    ir = igt.parse_model_description(flagship_dict(), DIMS)
    model = igt.build(ir)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    sample = igt.convert_sample(make_routenet_sample(rng, 32, 24, 6), igt.SampleSpec.from_ir(ir))
    _, meta = igt.build_batch([sample], ir)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        igt.ServingModel(model, params, meta, ir)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        igt.Trainer(model)
    assert igt.ServingModel(model, params, meta, ir, device="cpu").device.type == "cpu"
    assert igt.Trainer(model, device="cpu").device.type == "cpu"


def test_runner_and_verbs_default_to_the_gpu_and_raise_without_one(tmp_path):
    """`Runner`, `train_and_evaluate` and `predict` without `device` raise
    here and name the argument for the CPU; with device="cpu" they run."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    import json

    from ignnition_tpu_torch.config import RunConfig
    from ignnition_tpu_torch.data.synthetic import write_dataset

    write_dataset(str(tmp_path / "data"), 1, 2, seed=0)
    (tmp_path / "model.json").write_text(json.dumps(routenet_description(2, 8)))
    cfg = RunConfig(train_dataset=str(tmp_path / "data"), eval_dataset=str(tmp_path / "data"),
                    predict_dataset=str(tmp_path / "data"),
                    json_path=str(tmp_path / "model.json"), model_dir=str(tmp_path / "ck"),
                    batch_size=2, train_steps=1, eval_samples=1)
    model = igt.create_model(cfg)
    for call in (lambda: igt.Runner(model), lambda: igt.train_and_evaluate(model),
                 lambda: igt.predict(model)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert not (tmp_path / "ck").exists()
    state = igt.train_and_evaluate(model, run_dir=str(tmp_path / "run"), device="cpu")
    assert state.step == 1
    assert len(igt.predict(model, state, device="cpu")) == 2


@pytest.mark.parametrize("name", sorted(DESCRIPTIONS))
def test_ir_matches_jax(name):
    desc = DESCRIPTIONS[name]()
    got = igt.parse_model_description(copy.deepcopy(desc), DIMS)
    want = j_parse(copy.deepcopy(desc), DIMS)
    assert type(got).__module__ == "ignnition_tpu_torch.frontend.ir"
    assert repr(got) == repr(want)


def test_chip_smoke_description_matches_flagship():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    got = igt.parse_model_description(chip_smoke.flagship_description(), DIMS)
    assert repr(got) == repr(_flagship())


def test_chip_smoke_convergence_description_is_the_ab_model():
    """Phase 9's convergence run trains the model of
    docs/ab_convergence_flagship.json: `routenet_description(8, 32)`."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    got = igt.parse_model_description(chip_smoke.convergence_description(), DIMS)
    assert repr(got) == repr(j_parse(routenet_description(8, 32), DIMS))


def test_chip_smoke_qsize_description_is_the_example():
    """`chip_smoke.qsize_description` is `examples/qsize/model_description.yaml`
    and parses to the IR the JAX package makes of it."""
    import yaml

    sys.path.insert(0, str(REPO))
    import chip_smoke

    example = yaml.safe_load((REPO / "examples/qsize/model_description.yaml").read_text())
    assert chip_smoke.qsize_description() == example
    igt.register_normalization("normalization_queue_size", chip_smoke.normalization_queue_size)
    got = igt.parse_model_description(chip_smoke.qsize_description(), chip_smoke.QSIZE_FEATURE_DIMS)
    want = j_parse(example, chip_smoke.QSIZE_FEATURE_DIMS)
    assert repr(got) == repr(want)


def test_chip_smoke_qsize_path_runs_on_the_cpu_at_a_small_size():
    """The Q-size phase's own samples and entry points, at 2 iterations, hs=8
    and a few dozen nodes, with `device="cpu"`: the batch takes the fast
    interleave and the dense stage-2 products, `ServingModel.predict_samples`
    answers every real path, and `Trainer` steps."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    igt.register_normalization("normalization_queue_size", chip_smoke.normalization_queue_size)
    ir = igt.parse_model_description(chip_smoke.qsize_description(2, 8),
                                     chip_smoke.QSIZE_FEATURE_DIMS)
    size = dict(n_links=24, n_nodes=20, n_paths=40, hops=4)
    sample = chip_smoke.make_qsize_sample(np.random.default_rng(0), **size)
    model = igt.build(ir)
    params = model.init(torch.Generator().manual_seed(0))
    padding = igt.PaddingConfig(mode="multiple", multiple=16, min_size=16)
    arrays, meta = igt.build_batch([sample], ir, padding, training=True)
    assert "ilv_slice_path_s0m0" in arrays
    assert {"dense_inc_adj_paths_links", "dense_inc_adj_paths_nodes"} <= set(arrays)
    assert arrays["ilv_slice_path_s0m0"].shape[0] == 2 * size["hops"]
    server = igt.ServingModel(model, params, meta, ir, compute_dtype=None, device="cpu")
    preds = server.predict_samples([sample])
    assert preds.shape == (size["n_paths"],) and np.all(np.isfinite(preds))
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=None, device="cpu")
    state = trainer.init_state(params=params)
    state, metrics = trainer.train_step_fn(meta)(state, to_device(arrays, "cpu"))
    assert state.step == 1 and np.isfinite(float(metrics["total"]))


@pytest.mark.parametrize(
    "name,n_graphs", [("flagship", 1), ("flagship", 2), ("routenet", 3)]
)
def test_build_batch_arrays_match_jax(name, n_graphs):
    """The __graft_entry__._batch shape (32 links, 24 paths, length 6)."""
    desc = DESCRIPTIONS[name]()
    t_ir = igt.parse_model_description(copy.deepcopy(desc), DIMS)
    j_ir = j_parse(copy.deepcopy(desc), DIMS)

    def batch(parse_ir, spec_cls, convert, make, build, padding_cls):
        rng = np.random.default_rng(0)
        spec = spec_cls.from_ir(parse_ir)
        samples = [convert(make(rng, 32, 24, 6), spec) for _ in range(n_graphs)]
        return build(
            samples, parse_ir, padding_cls(mode="multiple", multiple=64, min_size=64)
        )

    got, got_meta = batch(
        t_ir, igt.SampleSpec, igt.convert_sample, make_routenet_sample,
        igt.build_batch, PaddingConfig,
    )
    want, want_meta = batch(
        j_ir, JSampleSpec, j_convert, j_make_sample, j_build_batch, JPadding
    )
    assert repr(got_meta) == repr(want_meta)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_to_device_conversions():
    arrays = {
        "src_adj": np.array([0, 2, 1], np.int32),
        "row_ptr_adj": np.array([0, 1, 3], np.int32),
        "dense_inc_adj": np.array([[1, 0], [2, 1]], np.int8),
        "inc_blocks_adj": np.array([[[1.0, 200.0]]], ml_dtypes.bfloat16),
        "edge_mask_adj": np.array([1.0, 1.0, 0.0], np.float32),
    }
    out = to_device(arrays, "cpu")
    assert out["src_adj"].dtype == torch.int64
    assert out["row_ptr_adj"].dtype == torch.int32
    assert out["dense_inc_adj"].dtype == torch.int8
    assert out["inc_blocks_adj"].dtype == torch.bfloat16
    assert out["edge_mask_adj"].dtype == torch.float32
    np.testing.assert_array_equal(out["inc_blocks_adj"].float().numpy(), [[[1.0, 200.0]]])
    np.testing.assert_array_equal(out["src_adj"].numpy(), [0, 2, 1])


def _qsize_ir(desc):
    dims = {f["name"]: 1 for e in desc["entities"] for f in e.get("features", [])}
    return igt.parse_model_description(desc, dims)


def test_unported_feature_raises_naming_it():
    """Q-size with its links updated by a feed-forward network after their
    sum: a Dropout in the update builds and initializes like any built-in
    kind; a kind that is neither built in nor registered makes `init` raise,
    naming the layer and the network, as the JAX package does."""
    desc = qsize_description()
    desc["neural_networks"].append(
        {"nn_name": "ff_update", "nn_type": "feed_forward",
         "nn_architecture": [dense(16, "relu"), {"type_layer": "Dropout", "rate": 0.1}]}
    )
    links = desc["message_passing"]["stages"][1]["stage_mp"][0]
    assert links["aggregation"]["type"] == "sum"
    links["update"] = {"type": "neural_network", "nn_name": "ff_update"}
    igt.build(_qsize_ir(desc)).init(torch.Generator().manual_seed(0))
    desc["neural_networks"][-1]["nn_architecture"].append({"type_layer": "Conv1D"})
    model = igt.build(_qsize_ir(desc))  # the kind may still be registered
    with pytest.raises(ValueError, match="unsupported layer type 'Conv1D' in network "
                                         "'ff_update'; built-ins: Dense, Dropout"):
        model.init(torch.Generator().manual_seed(0))


def test_message_network_with_a_non_dense_layer_raises_naming_it():
    """A message network takes every built-in kind (a Dropout builds and
    initializes); an unknown kind there makes `init` raise, naming the
    layer and the network."""
    desc = qsize_description()
    desc["neural_networks"].append(
        {"nn_name": "src_msg", "nn_type": "feed_forward",
         "nn_architecture": [dense(16, "relu"), {"type_layer": "Dropout", "rate": 0.1}]}
    )
    link = desc["message_passing"]["stages"][0]["stage_mp"][0]["source_entities"][0]
    link["message"] = [{"type": "neural_network", "nn_name": "src_msg", "input": ["hs_source"]}]
    igt.build(_qsize_ir(desc)).init(torch.Generator().manual_seed(0))
    desc["neural_networks"][-1]["nn_architecture"][1] = {"type_layer": "GRUCell"}
    with pytest.raises(ValueError, match="unsupported layer type 'GRUCell' in network 'src_msg'"):
        igt.build(_qsize_ir(desc)).init(torch.Generator().manual_seed(0))


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """On this CPU-only machine the script exits non-zero and prints no
    result line, in the checkout and alone in an empty directory."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (REPO, tmp_path):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
            text=True, timeout=240, env=env,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_serving_and_debug_import_without_jax():
    """The serving and debug modules import no JAX and nothing of the JAX
    package, and their verbs resolve."""
    proc = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import ignnition_tpu_torch as igt\n"
        "import ignnition_tpu_torch.serving, ignnition_tpu_torch.debug\n"
        "import ignnition_tpu_torch.debuggraph\n"
        "igt.export_serving, igt.load_serving, igt.LoadedServingModel\n"
        "assert callable(igt.debug) and igt.debug.__module__ == 'ignnition_tpu_torch.api'\n"
        "bad = [m for m in sys.modules if m == 'ignnition_tpu' or m.startswith('ignnition_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_compiled_sources_are_package_data():
    """Every source that the port compiles at first use (the native batch
    helpers, the CUDA kernels) matches a package-data glob of
    pyproject.toml, so that an installed port can build both."""
    import fnmatch
    import tomllib

    from ignnition_tpu_torch.data import native_build
    from ignnition_tpu_torch.ops.cuda import _build

    with open(REPO / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["ignnition_tpu_torch"]
    pkg = REPO / "ignnition_tpu_torch"
    cu, cuh = _build._sources()
    sources = [native_build.SOURCE_DIR / n for n in native_build.SOURCES] + cu + cuh
    assert len(sources) >= 4
    for src in sources:
        rel = src.resolve().relative_to(pkg.resolve()).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)


def test_build_directory_falls_back_when_the_package_cannot_be_written(
        tmp_path, monkeypatch):
    """In a checkout the libraries go to `ignnition_tpu_torch/_build/`;
    where the package directory cannot be written (an installed package),
    to the per-user cache directory."""
    from ignnition_tpu_torch.data import native_build
    from ignnition_tpu_torch.ops.cuda import _build
    from ignnition_tpu_torch.utils import build_dir as bd

    pkg = REPO / "ignnition_tpu_torch"
    assert native_build.BUILD_DIR == _build.BUILD_DIR == pkg / "_build"
    installed = tmp_path / "site-packages" / "ignnition_tpu_torch"
    installed.mkdir(parents=True)
    assert bd.build_dir(installed) == installed / "_build"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(bd, "_writable", lambda path: not str(path).startswith(
        str(tmp_path / "site-packages")))
    assert bd.build_dir(installed) == tmp_path / "cache" / "ignnition_tpu_torch"
    (installed / "_build").mkdir()
    assert bd.build_dir(installed) == tmp_path / "cache" / "ignnition_tpu_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert bd.build_dir(installed) == tmp_path / "home" / ".cache" / "ignnition_tpu_torch"
