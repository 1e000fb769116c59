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
from helpers import qsize_description, routenet_description

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
        "import ignnition_tpu_torch.batch\n"
        "import ignnition_tpu_torch.training, ignnition_tpu_torch.training.trainer\n"
        "import ignnition_tpu_torch.training.losses, ignnition_tpu_torch.training.metrics\n"
        "import ignnition_tpu_torch.training.optimizers\n"
        "import ignnition_tpu_torch.data.kdn, ignnition_tpu_torch.data.native_loader\n"
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


def test_unported_feature_raises_naming_it():
    desc = qsize_description()
    dims = {f["name"]: 1 for e in desc["entities"] for f in e.get("features", [])}
    ir = igt.parse_model_description(desc, dims)
    with pytest.raises(NotImplementedError, match="multi-source message passing"):
        igt.build(ir)


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
