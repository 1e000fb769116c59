"""The port's native batch helpers (`ignnition_tpu_torch/native/*.cpp`,
built with g++ at first use into `ignnition_tpu_torch/_build/`).

Held bitwise to the port's numpy routines (adjacency companions and the
windowed slice sort, on the cases the JAX package's own native tests use),
the native loader to the Python one, and the native `build_batch` to the
JAX package's `build_batch`. The library loaded is the port's own, never
the JAX package's `_native_loader.so`; a failed build raises; concurrent
builders leave one library."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import ignnition_tpu.data.graph as j_graph
import ignnition_tpu_torch as igt
import ignnition_tpu_torch.data.graph as t_graph
from ignnition_tpu.data import SampleSpec as JSampleSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data.synthetic import make_routenet_sample as j_make_sample
from ignnition_tpu.frontend import parse_model_description as j_parse
from ignnition_tpu_torch.data import dataset as t_ds
from ignnition_tpu_torch.data import native_build
from ignnition_tpu_torch.data import native_loader as NL
from ignnition_tpu_torch.data.synthetic import make_routenet_sample, write_dataset

from helpers import qsize_description, routenet_description
from test_torch_model import DIMS, QSIZE_DIMS, flagship_dict

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = REPO / "ignnition_tpu_torch" / "_build"
JAX_LIBRARY = REPO / "ignnition_tpu" / "data" / "_native_loader.so"


def _random_adjacency(rng, n_src, n_dst, e_real, e_pad, n_src_pad, n_dst_pad):
    """A destination-sorted edge list with padding edges at the end, as the
    data layer lays one out."""
    src = rng.integers(0, n_src, e_real).astype(np.int32)
    dst = np.sort(rng.integers(0, n_dst, e_real)).astype(np.int32)
    src_full = np.concatenate([src, np.full(e_pad - e_real, n_src_pad - 1, np.int32)])
    dst_full = np.concatenate([dst, np.full(e_pad - e_real, n_dst_pad - 1, np.int32)])
    emask = np.zeros(e_pad, np.float32)
    emask[:e_real] = 1.0
    return src_full, dst_full, emask


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_the_library_builds_and_loads_here():
    """g++ is on this machine: `auto` cannot fall back to numpy unseen."""
    assert NL.available()


def test_the_library_is_the_ports_own():
    path = pathlib.Path(NL.library_path()).resolve()
    assert path.parent == BUILD_DIR.resolve()
    assert path == native_build.library_path().resolve()
    assert path != JAX_LIBRARY.resolve()
    # a process that batches through the port maps the port's library only
    code = (
        "import numpy as np, ignnition_tpu_torch as igt\n"
        "from ignnition_tpu_torch.data.synthetic import make_routenet_sample\n"
        "from helpers import routenet_description\n"
        "ir = igt.parse_model_description(routenet_description(), "
        "{'link_capacity': 1, 'traffic': 1})\n"
        "s = igt.convert_sample(make_routenet_sample(np.random.default_rng(0)), "
        "igt.SampleSpec.from_ir(ir))\n"
        "igt.build_batch([s], ir)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print([l.split()[-1] for l in maps.splitlines() if 'ignnition' in l])\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=f"{REPO}:{REPO / 'tests'}"),
    )
    assert proc.returncode == 0, proc.stderr
    mapped = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert mapped == {str(path)}, mapped


# the cases of the JAX package's tests/test_native_aux.py:
# (seed, n_src, n_dst, e_real, e_pad, n_src_pad, n_dst_pad, max_len, bwd_len, chunk)
AUX_CASES = {
    f"random_{seed}_{i}": (seed, *shape, None, None)
    for seed in (0, 1, 2)
    for i, shape in enumerate([
        (37, 23, 180, 192, 40, 24, 8),
        (5, 400, 900, 1024, 8, 512, 4),  # hub sources: no bwd_slice
        (100, 7, 60, 64, 128, 8, 12),
    ])
}
AUX_CASES["fixed_bwd_len"] = (9, 10, 10, 40, 48, 12, 12, 4, 8, None)
AUX_CASES["all_padding"] = (0, 12, 12, 0, 16, 12, 12, 4, None, None)
AUX_CASES["several_windows"] = (4, 37, 230, 1800, 2048, 40, 256, 8, None, 300)


@pytest.mark.parametrize("case", sorted(AUX_CASES))
def test_adjacency_aux_native_matches_numpy_bitwise(case, monkeypatch):
    seed, n_src, n_dst, e_real, e_pad, n_src_pad, n_dst_pad, max_len, bwd_len, chunk = (
        AUX_CASES[case]
    )
    if chunk is not None:
        monkeypatch.setattr(t_graph, "_SLICE_SORT_CHUNK", chunk)
    rng = np.random.default_rng(seed)
    src, dst, emask = _random_adjacency(rng, n_src, n_dst, e_real, e_pad, n_src_pad, n_dst_pad)
    native = NL.adjacency_aux_native(
        src, dst, emask, n_src_pad, n_dst_pad, max_len,
        -1 if bwd_len is None else bwd_len, t_graph._SLICE_SORT_CHUNK,
    )
    assert native is not None
    monkeypatch.setattr(t_graph, "_USE_NATIVE_AUX", False)
    ref = t_graph.adjacency_aux_arrays(
        src, dst, emask, n_src_pad, n_dst_pad, max_len, bwd_len=bwd_len
    )
    _assert_same_arrays(native, ref)
    if case == "several_windows":
        assert native["slice_sort_row_ptr"].shape[0] - 1 > n_src_pad


@pytest.mark.parametrize("chunk", [300, 10**9])
def test_slice_sort_native_matches_numpy_bitwise(chunk, monkeypatch):
    rng = np.random.default_rng(21)
    n_src_pad = 40
    slice_src = rng.integers(0, n_src_pad, size=(16, 256)).astype(np.int32)
    native = NL.slice_sort_native(slice_src, n_src_pad, chunk)
    assert native is not None
    monkeypatch.setattr(t_graph, "_SLICE_SORT_CHUNK", chunk)
    monkeypatch.setattr(t_graph, "_USE_NATIVE_AUX", False)
    _assert_same_arrays(native, t_graph.slice_sort_companions(slice_src, n_src_pad))


def test_slice_sort_native_rejects_out_of_range():
    assert NL.slice_sort_native(np.array([[0, 50]], np.int32), 40, 1000) is None


def _compare_samples(a, b):
    assert a.num_nodes == b.num_nodes
    assert sorted(a.features) == sorted(b.features)
    for k in a.features:
        np.testing.assert_array_equal(a.features[k], b.features[k])
    assert sorted(a.adjacencies) == sorted(b.adjacencies)
    for k in a.adjacencies:
        x, y = a.adjacencies[k], b.adjacencies[k]
        for field in ("src_idx", "dst_idx", "seq"):
            np.testing.assert_array_equal(getattr(x, field), getattr(y, field), err_msg=k)
    np.testing.assert_array_equal(a.label, b.label)
    assert sorted(a.interleave) == sorted(b.interleave)
    for k in a.interleave:
        np.testing.assert_array_equal(a.interleave[k], b.interleave[k])


@pytest.mark.parametrize("model", ["routenet", "qsize"])
def test_iter_samples_native_matches_python(model, tmp_path, monkeypatch):
    qsize = model == "qsize"
    write_dataset(str(tmp_path), 1, 5, seed=9, n_links=14, n_paths=9, with_nodes=qsize)
    desc, dims = (qsize_description(), QSIZE_DIMS) if qsize else (routenet_description(), DIMS)
    spec = igt.SampleSpec.from_ir(igt.parse_model_description(desc, dims))
    calls = []
    real = NL.convert_archive
    monkeypatch.setattr(NL, "convert_archive", lambda *a: calls.append(1) or real(*a))
    native = list(t_ds.iter_samples(str(tmp_path), spec, use_native="auto"))
    python = list(t_ds.iter_samples(str(tmp_path), spec, use_native="never"))
    assert calls and len(native) == len(python) == 5
    for a, b in zip(native, python):
        _compare_samples(a, b)
    if qsize:
        assert native[0].interleave


@pytest.mark.parametrize(
    "model,n_graphs,chunk",
    [("flagship", 1, None), ("flagship", 2, 300), ("qsize", 1, None), ("qsize", 2, 300)],
)
def test_native_build_batch_matches_jax(model, n_graphs, chunk, monkeypatch):
    """Every array of the port's `build_batch`, on its native helpers, equals
    the JAX package's. A chunk of 300 slots gives the slice sorts (the
    interleave's included) several windows."""
    qsize = model == "qsize"
    for g in (t_graph, j_graph):
        if chunk is not None:
            monkeypatch.setattr(g, "_SLICE_SORT_CHUNK", chunk)
    native_calls = []
    for name in ("adjacency_aux_native", "slice_sort_native"):
        real = getattr(NL, name)
        monkeypatch.setattr(
            NL, name, lambda *a, _real=real, _name=name: native_calls.append(_name) or _real(*a)
        )
    desc, dims = (qsize_description(num_iterations=2, hs=8), QSIZE_DIMS) if qsize else (
        flagship_dict(), DIMS)
    out = []
    for parse, spec_cls, convert, make, build, pad in (
        (j_parse, JSampleSpec, j_convert, j_make_sample, j_build_batch, j_graph.PaddingConfig),
        (igt.parse_model_description, igt.SampleSpec, igt.convert_sample,
         make_routenet_sample, igt.build_batch, igt.PaddingConfig),
    ):
        ir = parse(desc, dims)
        rng = np.random.default_rng(3)
        spec = spec_cls.from_ir(ir)
        samples = [convert(make(rng, 60, 150, 8, with_nodes=qsize), spec)
                   for _ in range(n_graphs)]
        out.append(build(samples, ir, pad(mode="multiple", multiple=64, min_size=64)))
    (want, want_meta), (got, got_meta) = out
    assert repr(got_meta) == repr(want_meta)
    _assert_same_arrays(got, want)
    assert "adjacency_aux_native" in native_calls
    if qsize:
        assert "slice_sort_native" in native_calls  # the interleave's combined map
        assert any(k.startswith("ilv_sort_row_ptr_") for k in got)
    if chunk is not None:
        if qsize:
            rows = got_meta.nodes("link") + got_meta.nodes("node")  # the combined table
            row_ptr = got["ilv_sort_row_ptr_path_s0m0"]
        else:
            rows, row_ptr = got_meta.nodes("link"), got["slice_sort_row_ptr_adj_links_paths"]
        assert (row_ptr.shape[0] - 1) // rows > 1


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    for name in native_build.SOURCES:
        (src / name).write_text("this is not C++;\n")
    monkeypatch.setattr(native_build, "SOURCE_DIR", src)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="building the native batch helpers failed") as err:
        native_build.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so*"))
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_build.build()


def test_concurrent_builders_make_one_library(tmp_path):
    """Three processes reach the first build at once: one compiles under the
    lock, the others wait and load its library; no partial file is left."""
    code = (
        "import pathlib, sys\n"
        "import ignnition_tpu_torch.data.native_build as nb\n"
        "nb.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "print(nb.build(), nb.build_seconds is not None)\n"
    )
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(3)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].split()[0] for o in outs}
    compiled = [o[0].split()[1] == "True" for o in outs]
    assert len(paths) == 1 and sum(compiled) == 1, outs
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [pathlib.Path(paths.pop()).name, "native.lock"])
