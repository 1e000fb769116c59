"""The port's user entry points against the JAX package's, on the CPU:
`RunConfig.from_ini`, `Trainer.batches` (bitwise, with workers, with its
caches), `stack_batches` and `_auto_accumulate`, `accum_train_step_fn`,
`train()`, `evaluate()`, `Runner.predict` on entity, edge and graph labels,
checkpoints (keep-max, resume, warm start, every optimizer's state), packed
transfer, the api verbs end to end (also a yaml description with a dropout
readout under centered RMSprop), and what is not ported yet raising with
its ROADMAP item.

Both packages read the same synthetic datasets (written by the port's
`data.synthetic`) and start from the same weights (`params_from_jax`). One
fixed `PaddingConfig` keeps every batch at one shape, so that the JAX side
compiles each step once.
"""

import copy
import json
import logging
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import ignnition_tpu.training.trainer as j_trainer_mod
import ignnition_tpu_torch as igt
import ignnition_tpu_torch.training.trainer as t_trainer_mod
from ignnition_tpu.config import RunConfig as JRunConfig
from ignnition_tpu.data.graph import PaddingConfig as JPadding
from ignnition_tpu.frontend import parse_model_description as j_parse
from ignnition_tpu.model import build as j_build
from ignnition_tpu.parallel import edge_array_keys as j_edge_array_keys
from ignnition_tpu.parallel import stack_batches as j_stack_batches
from ignnition_tpu.training.trainer import Trainer as JTrainer
from ignnition_tpu.utils import get_normalization as j_get_normalization
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.config import RunConfig
from ignnition_tpu_torch.data import synthetic
from ignnition_tpu_torch.model.builder import flatten_params
from ignnition_tpu_torch.parallel import edge_array_keys, stack_batches
from ignnition_tpu_torch.training.packing import pack_arrays, pack_layout, unpack_arrays
from ignnition_tpu_torch.training.trainer import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
    warm_start,
)

from helpers import routenet_description

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)
PAD = dict(mode="multiple", multiple=128, min_size=128, seq_multiple=4)
DIMS = {"link_capacity": 1, "traffic": 1}
TRAIN_SAMPLES = 8  # 2 archives of 4: 4 batches of 2 an epoch


def _jax_flat(tree):
    return {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(tree)
    }


def _firm(jt, js, arrays, meta):
    """The elements whose first gradient is above 1e-3 of their leaf's
    largest. The others (the columns fed by zero-padded state dimensions)
    get a gradient of f32 noise in both packages, which Adam turns into a
    step of either sign (as in tests/test_torch_train.py)."""
    (_, _), g0 = jax.value_and_grad(jt._loss, has_aux=True)(
        js.params, arrays, meta, jax.random.PRNGKey(1))
    return {k: np.abs(g) >= 1e-3 * np.abs(g).max() for k, g in _jax_flat(g0).items()}


def _assert_params_close(t_params, j_params, firm, steps):
    """The firm elements at 1e-4; every element within what Adam can have
    moved it (2 x the learning rate of 1e-3 a step)."""
    got = {k: v.detach().numpy() for k, v in flatten_params(t_params).items()}
    want = _jax_flat(j_params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k][firm[k]], want[k][firm[k]], err_msg=k, **TOL)
        assert np.abs(got[k] - want[k]).max() <= 2e-3 * steps, k


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """RouteNet datasets with paths of at most 4 links (one padded length)."""
    root = tmp_path_factory.mktemp("api_data")
    synthetic.write_dataset(str(root / "train"), 2, 4, seed=0, max_path_len=4)
    synthetic.write_dataset(str(root / "eval"), 1, 6, seed=1, max_path_len=4)
    return root


def _desc(loss=None):
    desc = routenet_description(num_iterations=2, hs=8)
    if loss is not None:
        desc["learning_options"]["loss"] = loss
    return desc


def _pair(desc, dims=DIMS, pad=PAD):
    """A JAX and a port Trainer of `desc` with the same weights."""
    jt = JTrainer(j_build(j_parse(copy.deepcopy(desc), dims)), JPadding(**pad))
    tt = igt.Trainer(igt.build(igt.parse_model_description(copy.deepcopy(desc), dims)),
                     igt.PaddingConfig(**pad), device="cpu")
    js = jt.init_state(jax.random.PRNGKey(0))
    ts = tt.init_state(params=igt.params_from_jax(js.params))
    return jt, js, tt, ts


class _StepLog(logging.Handler):
    """The (step, loss, reg, total) of every "step ..." record of a logger."""

    def __init__(self, name):
        super().__init__()
        self.rows = []
        self.logger = logging.getLogger(name)

    def emit(self, record):
        if record.msg.startswith("step "):
            self.rows.append(tuple(float(a) for a in record.args))

    def __enter__(self):
        self.logger.addHandler(self)
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

INI_CASES = {
    "full": """
        [DEFAULT]
        root = /data/run
        [PATHS]
        train_dataset = ${root}/train
        eval_dataset = ${root}/eval
        predict_dataset = ${root}/predict
        json_path = ${root}/model.yaml
        model_dir = ${root}/ck
        warm_start_path = ${root}/ck/experiment_1
        compilation_cache_dir = ${root}/cache
        [TRAINING_OPTIONS]
        batch_size = 7
        train_steps = 123
        shuffle_train_samples = False
        shuffle_eval_samples = yes
        eval_samples = 9
        eval_batch_size = 3
        save_checkpoints_secs = 11
        keep_checkpoint_max = 2
        throttle_secs = 13
        log_every = 4
        accumulate_steps = 3
        input_workers = 2
        cache_batches = device
        device_prefetch = 2
        per_graph_padding = true
        execute_gpu = True
    """,
    "auto_and_host_cache": """
        [PATHS]
        train_dataset = ./train
        [TRAINING_OPTIONS]
        accumulate_steps = AUTO
        cache_batches = true
    """,
    "only_paths": """
        [PATHS]
        json_path = model.json
    """,
}


@pytest.mark.parametrize("case", sorted(INI_CASES))
def test_run_config_from_ini_matches_jax(tmp_path, case):
    path = tmp_path / "train_options.ini"
    path.write_text(textwrap.dedent(INI_CASES[case]))
    got, want = RunConfig.from_ini(str(path)), JRunConfig.from_ini(str(path))
    assert vars(got) == vars(want)
    assert [f for f in RunConfig.__dataclass_fields__] == [
        f for f in JRunConfig.__dataclass_fields__]


@pytest.mark.parametrize("text,match", [
    ("[PATHS]\ntrain_datset = x\n", r"unknown key\(s\) \['train_datset'\] in \[PATHS\]"),
    ("[TRAINING]\nbatch_size = 2\n", r"unknown config section \[TRAINING\]"),
    ("[TRAINING_OPTIONS]\nbatch_size = two\n", "invalid literal"),
], ids=["key", "section", "value"])
def test_run_config_errors_match_jax(tmp_path, text, match):
    path = tmp_path / "train_options.ini"
    path.write_text(text)
    for cls in (RunConfig, JRunConfig):
        with pytest.raises(ValueError, match=match):
            cls.from_ini(str(path))
    with pytest.raises(FileNotFoundError, match="not found"):
        RunConfig.from_ini(str(tmp_path / "missing.ini"))


# --------------------------------------------------------------------------
# the input pipeline
# --------------------------------------------------------------------------


def test_batches_match_jax_bitwise(data):
    jt, _, tt, _ = _pair(_desc())
    got = list(tt.batches(str(data / "train"), 3, shuffle=False, repeat=False))
    want = list(jt.batches(str(data / "train"), 3, shuffle=False, repeat=False))
    assert len(got) == len(want) == 3  # 8 samples: 3 + 3 + 2
    for (ga, gm), (wa, wm) in zip(got, want):
        assert repr(gm) == repr(wm)
        assert sorted(ga) == sorted(wa)
        for k in wa:
            assert ga[k].dtype == wa[k].dtype, k
            np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)


def test_batches_with_workers_are_complete_and_valid(data):
    """workers=2: every sample once an epoch, each batch one of the batches
    a single worker could build from some of the samples."""
    _, _, tt, _ = _pair(_desc())
    one = list(tt.batches(str(data / "train"), 1, shuffle=False, repeat=False))
    paths = sorted(tuple(a["traffic"][a["node_mask_path"] > 0].ravel()) for a, _ in one)
    keys = sorted(next(tt.batches(str(data / "train"), 2, shuffle=False))[0])
    got = list(tt.batches(str(data / "train"), 2, shuffle=True, seed=3, repeat=False, workers=2))
    assert sum(m.num_graphs for _, m in got) == TRAIN_SAMPLES
    seen = []
    for arrays, meta in got:
        assert sorted(arrays) == keys
        graph = arrays["graph_id_path"][arrays["node_mask_path"] > 0]
        traffic = arrays["traffic"][arrays["node_mask_path"] > 0].ravel()
        seen += [tuple(traffic[graph == g]) for g in range(meta.num_graphs)]
    assert sorted(seen) == paths


def test_batches_cache_cycles_and_reshuffles(data):
    _, _, tt, _ = _pair(_desc())
    it = tt.batches(str(data / "train"), 2, shuffle=True, seed=5, cache=True)
    epochs = [[next(it) for _ in range(4)] for _ in range(3)]
    ids = [[id(a) for a, _ in e] for e in epochs]
    assert sorted(ids[0]) == sorted(ids[1]) == sorted(ids[2])  # the same built batches
    assert len(set(map(tuple, ids))) > 1  # in a new order
    dev = tt.batches(str(data / "train"), 2, shuffle=False, cache="device")
    arrays, _ = next(dev)
    assert all(isinstance(v, torch.Tensor) for v in arrays.values())
    assert arrays["src_adj_links_paths"].dtype == torch.int64
    with pytest.raises(ValueError, match="requires repeat=True"):
        next(tt.batches(str(data / "train"), 2, cache=True, repeat=False))


def test_packed_batch_equals_unpacked_bitwise():
    import ml_dtypes

    arrays = {
        "src_adj": np.array([0, 2, 1], np.int32),
        "row_ptr_adj": np.array([0, 1, 3], np.int32),
        "dense_inc_adj": np.array([[1, 0], [2, 1]], np.int8),
        "inc_blocks_adj": np.array([[[1.0, 200.0]]], ml_dtypes.bfloat16),
        "feature_x": np.arange(10, dtype=np.float32).reshape(5, 2),
        "edge_mask_adj": np.array([1.0, 1.0, 0.0], np.float32),
    }
    lay = pack_layout(arrays)
    bufs = pack_arrays(arrays, lay)
    assert sorted(bufs) == ["packedbfloat16", "packedfloat32", "packedint32", "packedint64",
                            "packedint8"]
    got, want = unpack_arrays(to_device(bufs, "cpu"), lay), to_device(arrays, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k].view(-1).view(torch.uint8) if got[k].dtype == torch.bfloat16
                           else got[k], want[k].view(-1).view(torch.uint8)
                           if want[k].dtype == torch.bfloat16 else want[k]), k
    starts = [start * getattr(torch, g).itemsize for _, g, start, _ in lay]
    assert all(s % 128 == 0 for s in starts)


# --------------------------------------------------------------------------
# stacking and accumulation
# --------------------------------------------------------------------------


def test_stack_batches_matches_jax():
    """Two batches of different shapes grown to a common meta and stacked,
    and one batch stacked with itself: the JAX package's arrays, bitwise."""
    from ignnition_tpu.data import SampleSpec as JSampleSpec
    from ignnition_tpu.data import build_batch as j_build_batch
    from ignnition_tpu.data import convert_sample as j_convert

    desc = _desc()
    t_ir, j_ir = igt.parse_model_description(copy.deepcopy(desc), DIMS), j_parse(desc, DIMS)
    rng = np.random.default_rng(0)
    raw = [synthetic.make_routenet_sample(rng, n_links=n, n_paths=m, max_path_len=4)
           for n, m in ((10, 8), (30, 20))]
    pad = dict(mode="pow2", min_size=8)
    t_items = [igt.build_batch([igt.convert_sample(r, igt.SampleSpec.from_ir(t_ir))], t_ir,
                               igt.PaddingConfig(**pad)) for r in raw]
    j_items = [j_build_batch([j_convert(r, JSampleSpec.from_ir(j_ir))], j_ir, JPadding(**pad))
               for r in raw]
    assert repr(t_items[0][1]) != repr(t_items[1][1])
    for pick in ([0, 1], [1, 1]):
        got, got_meta = stack_batches([t_items[i] for i in pick], t_ir)
        want, want_meta = j_stack_batches([j_items[i] for i in pick], j_ir)
        assert repr(got_meta) == repr(want_meta)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert edge_array_keys(t_ir) == j_edge_array_keys(j_ir)
    with pytest.raises(ValueError, match="pass model_ir"):
        stack_batches(t_items)


@pytest.mark.parametrize("per_graph", [False, True])
@pytest.mark.parametrize("target", [10 ** 6, 200, 60])
def test_auto_accumulate_matches_jax(data, monkeypatch, per_graph, target):
    monkeypatch.setattr(JTrainer, "_TARGET_MICROBATCH_EDGES", target)
    monkeypatch.setattr(igt.Trainer, "_TARGET_MICROBATCH_EDGES", target)
    pad = dict(PAD, per_graph=per_graph)
    jt, _, tt, _ = _pair(_desc(), pad=pad)
    for batch_size in (1, 3, 8):
        got = tt._auto_accumulate(str(data / "train"), batch_size)
        assert got == jt._auto_accumulate(str(data / "train"), batch_size)
        if per_graph or target == 10 ** 6 or batch_size == 1:
            assert got == (1, batch_size)


@pytest.mark.parametrize("loss", ["MeanSquaredError", "KLDivergence"])
def test_accum_train_step_matches_jax(data, loss):
    """Two microbatches stacked: the mean loss averages, the sum loss sums
    (less the extra L2 gradients); then the merged single step."""
    jt, js, tt, ts = _pair(_desc(loss))
    items = list(jt.batches(str(data / "train"), 2, shuffle=False, repeat=False))[:2]
    t_items = list(tt.batches(str(data / "train"), 2, shuffle=False, repeat=False))[:2]
    arrays, meta = j_stack_batches(items, jt.ir)
    t_arrays, t_meta = stack_batches(t_items, tt.ir)
    firm = _firm(jt, js, *items[0])
    params, opt_state, logs = jt.accum_train_step_fn(meta, 2)(
        js.params, js.opt_state, arrays, jax.random.PRNGKey(1))
    ts, t_logs = tt.accum_train_step_fn(t_meta, 2)(ts, to_device(t_arrays, "cpu"))
    assert ts.step == 1
    for k in ("loss", "reg", "total"):
        np.testing.assert_allclose(float(t_logs[k]), float(logs[k]), err_msg=k, **TOL)
    _assert_params_close(ts.params, params, firm, 1)
    # the single merged step on the first batch
    (a, m), (ta, tm) = items[0], t_items[0]
    params, opt_state, logs = jt.train_step_fn(m)(params, opt_state, a, jax.random.PRNGKey(2))
    ts, t_logs = tt.train_step_fn(tm)(ts, to_device(ta, "cpu"))
    np.testing.assert_allclose(float(t_logs["total"]), float(logs["total"]), **TOL)
    _assert_params_close(ts.params, params, firm, 2)


# --------------------------------------------------------------------------
# train, evaluate, predict
# --------------------------------------------------------------------------


def _train_both(data, tt, ts, jt, js, steps=8, **kw):
    with _StepLog("ignnition_tpu") as jlog:
        js = jt.train(js, str(data / "train"), steps, batch_size=2, shuffle=False,
                      log_every=1, **kw)
    with _StepLog("ignnition_tpu_torch") as tlog:
        ts = tt.train(ts, str(data / "train"), steps, batch_size=2, shuffle=False,
                      log_every=1, **kw)
    return js, jlog.rows, ts, tlog.rows


@pytest.mark.parametrize("accumulate_steps", [1, 2])
def test_train_matches_jax(data, accumulate_steps):
    """8 steps (2 epochs of 4 batches at accumulate_steps 1): every logged
    loss and every final leaf at 1e-4."""
    jt, js, tt, ts = _pair(_desc())
    firm = _firm(jt, js, *next(jt.batches(str(data / "train"), 2, shuffle=False)))
    js, jrows, ts, trows = _train_both(data, tt, ts, jt, js,
                                       accumulate_steps=accumulate_steps)
    assert ts.step == js.step == 8 and len(trows) == len(jrows) == 8
    np.testing.assert_allclose(np.array(trows), np.array(jrows), **TOL)
    _assert_params_close(ts.params, js.params, firm, 8)
    assert trows[-1][1] < trows[0][1] or accumulate_steps == 2


@pytest.mark.parametrize("knobs", [
    dict(pack_transfer=True),
    dict(cache_batches="device"),
    dict(cache_batches=True, input_workers=1),
    dict(device_prefetch=2, pack_transfer=True),
    dict(accumulate_steps=2, cache_batches="device", pack_transfer=True),
], ids=["packed", "device_cache", "host_cache", "prefetch_packed", "accum_device_cache"])
def test_train_knobs_give_the_plain_result(data, knobs):
    """The transfer and caching knobs change where a batch lives, not what
    the step computes: bitwise the plain loop's losses and parameters."""
    _, _, tt, _ = _pair(_desc())
    runs = []
    for kw in ({"accumulate_steps": knobs.get("accumulate_steps", 1)}, knobs):
        state = tt.init_state(torch.Generator().manual_seed(0))
        with _StepLog("ignnition_tpu_torch") as log:
            state = tt.train(state, str(data / "train"), 6, batch_size=2, shuffle=False,
                             log_every=1, **kw)
        runs.append((log.rows, flatten_params(state.params)))
    (plain_rows, plain), (rows, got) = runs
    assert rows == plain_rows
    for k, v in plain.items():
        assert torch.equal(got[k], v), k


def test_evaluate_matches_jax(data):
    jt, js, tt, ts = _pair(_desc())
    j_exp, t_exp = j_get_normalization("exp"), igt.get_normalization("exp")
    cases = [
        dict(num_batches=3, batch_size=2),
        dict(num_batches=2, batch_size=1, cache=True),
        dict(num_batches=2, batch_size=2, shuffle=True, seed=7),
        dict(num_batches=2, batch_size=1, cache=True, shuffle=True, seed=11),
    ]
    for kw in cases:
        for denorm in (None, "exp"):
            got = tt.evaluate(ts, str(data / "eval"), label_name="delay",
                              denormalization=t_exp if denorm else None, **kw)
            want = jt.evaluate(js, str(data / "eval"), label_name="delay",
                               denormalization=j_exp if denorm else None, **kw)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                           err_msg=f"{kw} {denorm} {k}")


def _write_example_data(root, name):
    writers = {"linkpred": synthetic.write_linkpred_dataset,
               "graphprop": synthetic.write_graphprop_dataset}
    writers[name](str(root / "train"), 1, 3, seed=0)
    writers[name](str(root / "predict"), 1, 3, seed=1)


@pytest.mark.parametrize("name", ["routenet", "linkpred", "graphprop"])
def test_runner_predict_matches_jax(data, tmp_path, name):
    """An entity label (RouteNet's paths), an edge label (linkpred, through
    `label_perm` back to each sample's edge order) and a graph label
    (graphprop): one array a sample, equal to the JAX package's."""
    import ignnition_tpu.api as j_api

    if name == "routenet":
        json_path = tmp_path / "model.json"
        json_path.write_text(json.dumps(_desc()))
        train, predict = data / "train", data / "eval"
    else:
        json_path = os.path.join(REPO, "examples", name, "model_description.yaml")
        _write_example_data(tmp_path, name)
        train, predict = tmp_path / "train", tmp_path / "predict"
    kw = dict(train_dataset=str(train), predict_dataset=str(predict), json_path=str(json_path))
    j_runner = j_api.Runner(j_api.create_model(JRunConfig(**kw)))
    t_runner = igt.Runner(igt.create_model(RunConfig(**kw)), device="cpu")
    js = j_runner.trainer.init_state(jax.random.PRNGKey(0))
    ts = t_runner.trainer.init_state(params=igt.params_from_jax(js.params))
    got, want = t_runner.predict(ts), j_runner.predict(js)
    assert len(got) == len(want) == (6 if name == "routenet" else 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def test_checkpoints_keep_max_and_latest(tmp_path):
    _, _, tt, ts = _pair(_desc())
    manager = CheckpointManager(str(tmp_path / "ck"), keep_max=2)
    assert manager.latest_step() is None
    for step in (1, 2, 3, 5):
        ts.step = step
        save_checkpoint(manager, ts)
    assert manager.all_steps() == [3, 5] and manager.latest_step() == 5
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "5"]  # no temporary left
    assert not manager.save(5, {})  # a saved step is not written again


def test_resume_equals_an_uninterrupted_run(data, tmp_path):
    """4 steps, then a resumed run to 8 on the same directory (whole epochs,
    so both runs see the same batches): the parameters and the optimizer
    state of one run of 8, bitwise."""
    _, _, tt, _ = _pair(_desc())
    whole = tt.train(tt.init_state(torch.Generator().manual_seed(0)), str(data / "train"), 8,
                     batch_size=2, shuffle=False, log_every=0)
    run = str(tmp_path / "run")
    first = tt.train(tt.init_state(torch.Generator().manual_seed(0)), str(data / "train"), 4,
                     batch_size=2, shuffle=False, log_every=0, checkpoint_dir=run)
    assert CheckpointManager(run).latest_step() == 4 and first.step == 4
    fresh = tt.init_state(torch.Generator().manual_seed(0))
    resumed = tt.train(fresh, str(data / "train"), 8, batch_size=2, shuffle=False,
                       log_every=0, checkpoint_dir=run)
    assert resumed.step == 8 and CheckpointManager(run).all_steps() == [4, 8]
    for tree in ("params", "opt_state"):
        got, want = flatten_params(getattr(resumed, tree)), flatten_params(getattr(whole, tree))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(v)), (tree, k)
    leaf = next(iter(flatten_params(resumed.params).values()))
    assert leaf.requires_grad and leaf.dtype == torch.float32


def test_restore_and_warm_start(tmp_path):
    """restore_checkpoint brings back the parameters, optimizer state and
    step into the state's own tensors; warm_start only the parameters."""
    _, _, tt, saved = _pair(_desc())
    with torch.no_grad():
        for v in flatten_params(saved.params).values():
            v.add_(1.0)
    saved.opt_state["count"] = 3
    saved.step = 3
    manager = CheckpointManager(str(tmp_path / "ck"))
    save_checkpoint(manager, saved)

    state = tt.init_state(torch.Generator().manual_seed(1))
    before = {k: v for k, v in flatten_params(state.params).items()}
    restored = restore_checkpoint(manager, state)
    assert restored.step == 3 and restored.opt_state["count"] == 3
    for k, v in flatten_params(restored.params).items():
        assert v is before[k] and v.requires_grad
        assert torch.equal(v, flatten_params(saved.params)[k])

    state = tt.init_state(torch.Generator().manual_seed(1))
    warm = warm_start(state, str(tmp_path / "ck"))
    assert warm.step == 0 and warm.opt_state["count"] == 0
    for k, v in flatten_params(warm.params).items():
        assert torch.equal(v, flatten_params(saved.params)[k])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        warm_start(state, str(tmp_path / "nothing"))
    assert not (tmp_path / "nothing").exists()
    other = igt.Trainer(igt.build(igt.parse_model_description(
        routenet_description(num_iterations=2, hs=4), DIMS)), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        warm_start(other.init_state(), str(tmp_path / "ck"))


# each optimizer's state: (kind, options); a schedule on Nadam
OPTIMIZER_STATES = {
    "Adam_amsgrad": ("Adam", {"amsgrad": True}),
    "AdamW": ("AdamW", {"weight_decay": 0.1}),
    "RMSprop_centered_momentum": ("RMSprop", {"centered": True, "momentum": 0.9}),
    "Adagrad": ("Adagrad", {"initial_accumulator_value": 0.2}),
    "Adadelta": ("Adadelta", {"learning_rate": 1.0}),
    "Adamax": ("Adamax", {}),
    "Nadam_schedule": ("Nadam", {}),
    "SGD_momentum": ("SGD", {"momentum": 0.9}),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_STATES))
def test_optimizer_state_round_trips_through_a_checkpoint(tmp_path, case):
    """Each kind's state (moments, `vhat`, accumulators, RMSprop's mean
    gradient and trace, Nadam's `u_prod`) saved after 2 steps and restored
    into a fresh state: the third step of both is bitwise the same."""
    from ignnition_tpu_torch.frontend.ir import OptimizerSpec, ScheduleSpec
    from ignnition_tpu_torch.training.optimizers import build_optimizer

    kind, options = OPTIMIZER_STATES[case]
    schedule = (ScheduleSpec(kind="ExponentialDecay", params={
        "initial_learning_rate": 0.01, "decay_steps": 2, "decay_rate": 0.5})
        if case.endswith("schedule") else None)
    tx = build_optimizer(OptimizerSpec(kind=kind, params=options, schedule=schedule))
    rng = np.random.default_rng(5)
    tree = lambda: igt.params_from_jax({"w": rng.standard_normal((3, 2)).astype(np.float32),
                                        "b": (rng.standard_normal(2).astype(np.float32),)})
    state = igt.TrainState(tree(), None, 2)
    state.opt_state = tx.init(state.params)
    for _ in range(2):
        tx.step(state.params, tree(), state.opt_state)
    manager = CheckpointManager(str(tmp_path / "ck"))
    save_checkpoint(manager, state)
    fresh = igt.TrainState(tree(), None, 0)
    fresh.opt_state = tx.init(fresh.params)
    fresh = restore_checkpoint(manager, fresh)
    assert fresh.step == 2 and sorted(flatten_params(fresh.opt_state)) == sorted(
        flatten_params(state.opt_state))
    g = tree()
    tx.step(state.params, g, state.opt_state)
    tx.step(fresh.params, g, fresh.opt_state)
    for tree_name in ("params", "opt_state"):
        got = flatten_params(getattr(fresh, tree_name))
        for k, v in flatten_params(getattr(state, tree_name)).items():
            assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(v)), (tree_name, k)


# --------------------------------------------------------------------------
# the api verbs, and the loop's options
# --------------------------------------------------------------------------


def test_train_and_evaluate_with_a_dropout_readout_and_rmsprop(data, tmp_path):
    """A model_description.yaml variant written here: a readout with Dropout,
    LayerNormalization and GaussianNoise, trained by centered RMSprop with
    momentum through `create_model` -> `train_and_evaluate` -> `predict`.
    Training draws masks (two runs of one seed end equal, the parameters
    move, the state holds RMSprop's trees); `predict` is deterministic."""
    import yaml

    desc = _desc()
    net = next(n for n in desc["neural_networks"] if n["nn_type"] == "feed_forward")
    net["nn_architecture"][1:1] = [{"type_layer": "Dropout", "rate": 0.3},
                                   {"type_layer": "LayerNormalization"},
                                   {"type_layer": "GaussianNoise", "stddev": 0.05}]
    desc["learning_options"]["optimizer"] = {
        "type": "RMSprop", "learning_rate": 0.005, "centered": True, "momentum": 0.9}
    (tmp_path / "model_description.yaml").write_text(yaml.safe_dump(desc))
    cfg = RunConfig(train_dataset=str(data / "train"), eval_dataset=str(data / "eval"),
                    predict_dataset=str(data / "eval"),
                    json_path=str(tmp_path / "model_description.yaml"),
                    model_dir=str(tmp_path / "ck"), batch_size=2, train_steps=4,
                    eval_samples=2, eval_batch_size=2, shuffle_train_samples=False)
    model = igt.create_model(cfg)
    runs = [igt.train_and_evaluate(model, run_dir=str(tmp_path / f"run{i}"), device="cpu")
            for i in range(2)]
    state = runs[0]
    assert state.step == 4 and sorted(state.opt_state) == ["count", "mu", "nu", "trace"]
    init = flatten_params(igt.Runner(model, device="cpu")._init_state().params)
    for k, v in flatten_params(state.params).items():
        assert torch.equal(v, flatten_params(runs[1].params)[k]), k
        assert np.isfinite(v.detach().numpy()).all()
    assert any(not torch.equal(v, init[k]) for k, v in flatten_params(state.params).items())
    model.config.warm_start_path = str(tmp_path / "run0")
    preds = igt.predict(model, device="cpu")
    again = igt.predict(model, device="cpu")
    direct = igt.Runner(model, device="cpu").predict(state)
    assert len(preds) == 6
    for p, q, r in zip(preds, again, direct):
        np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(p, r)


def test_api_verbs_end_to_end_on_the_cpu(data, tmp_path, caplog):
    """ini -> create_model -> train_and_evaluate -> Runner.evaluate ->
    predict from the run's checkpoint (warm_start_path)."""
    (tmp_path / "model.json").write_text(json.dumps(_desc()))
    ini = tmp_path / "train_options.ini"
    ini.write_text(textwrap.dedent(f"""
        [PATHS]
        train_dataset = {data / 'train'}
        eval_dataset = {data / 'eval'}
        predict_dataset = {data / 'eval'}
        json_path = {tmp_path / 'model.json'}
        model_dir = {tmp_path / 'ck'}
        compilation_cache_dir = {tmp_path / 'unused'}
        [TRAINING_OPTIONS]
        batch_size = 2
        train_steps = 5
        eval_samples = 2
        eval_batch_size = 2
        shuffle_train_samples = false
        throttle_secs = 0
        log_every = 1
        execute_gpu = true
    """))
    model = igt.create_model(str(ini))
    assert model.config.compilation_cache_dir == str(tmp_path / "unused")
    state = igt.train_and_evaluate(model, device="cpu")
    assert state.step == 5
    (run,) = os.listdir(tmp_path / "ck")
    assert run.startswith("experiment_")
    assert CheckpointManager(str(tmp_path / "ck" / run)).latest_step() == 5
    metrics = igt.Runner(model, device="cpu").evaluate(state)
    assert set(metrics) == {"label/mean", "prediction/mean", "mae", "mre", "r-squared", "loss"}
    assert all(np.isfinite(v) for v in metrics.values())
    with pytest.raises(ValueError, match="warm_start_path"):
        igt.predict(model, device="cpu")
    model.config.warm_start_path = str(tmp_path / "ck" / run)
    preds = igt.predict(model, device="cpu")
    direct = igt.Runner(model, device="cpu").predict(state)
    assert len(preds) == 6
    for p, q in zip(preds, direct):
        np.testing.assert_array_equal(p, q)
    assert not (tmp_path / "unused").exists()


def test_example_routenet_runs_three_steps_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "ignnition_tpu_torch.examples.routenet", "--synthetic",
         "--device", "cpu", "--steps", "3", "--data", str(tmp_path / "data")],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "final eval:" in proc.stdout
    assert os.listdir(tmp_path / "data" / "checkpoints")


def test_profile_and_tensorboard(data, tmp_path, monkeypatch):
    """profile_dir writes a chrome trace, also when the loop ends inside the
    profiled steps; tensorboard_dir an event file of scalars and histograms,
    and a missing tensorboard raises naming it."""
    _, _, tt, ts = _pair(_desc())
    tt.train(ts, str(data / "train"), 3, batch_size=2, shuffle=False, log_every=0,
             profile_dir=str(tmp_path / "prof"), profile_steps=(1, 10))
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace == "trace_steps_1_10.json"
    tt.train(tt.init_state(), str(data / "train"), 2, batch_size=2, log_every=1,
             tensorboard_dir=str(tmp_path / "tb"), histogram_every=1)
    (events,) = os.listdir(tmp_path / "tb")
    assert events.startswith("events.out.tfevents")
    assert os.path.getsize(tmp_path / "tb" / events) > 1000  # scalars and histograms
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tensorboard"):
        tt.train(tt.init_state(), str(data / "train"), 1, batch_size=2,
                 tensorboard_dir=str(tmp_path / "tb2"))


@pytest.mark.parametrize("kw", [{}, {"cache_batches": True}, {"accumulate_steps": 2}],
                         ids=["stream", "cached", "accumulated"])
def test_shuffled_training_repeats_under_its_seed(data, kw):
    """`Trainer.train(shuffle=True, seed=...)` shuffles the batch stream by
    its seed: two runs from one initial state end at the same parameters,
    on the streamed, the cached and the accumulating path."""
    _, _, tt, _ = _pair(_desc())
    runs = [tt.train(tt.init_state(torch.Generator().manual_seed(0)), str(data / "train"), 4,
                     batch_size=2, shuffle=True, log_every=0, seed=7, **kw) for _ in range(2)]
    for k, v in flatten_params(runs[0].params).items():
        torch.testing.assert_close(flatten_params(runs[1].params)[k], v, rtol=0, atol=0)


def test_unported_options_raise_naming_their_roadmap_item(data):
    """What the entry points still refuse: a mesh that is not the port's
    `parallel.Mesh` (TypeError), an unknown model strategy (ValueError),
    `node_axis` together with `edge_axis`. Destination sharding itself is
    ported: `model_strategy="dest_shard"` and `locality_reorder=True`
    without a mesh (so without a model axis) train on the plain path, as
    the JAX trainer does, to the same parameters as a run without them."""
    (tmp := data / "model_unported.json").write_text(json.dumps(_desc()))
    model = igt.create_model(RunConfig(train_dataset=str(data / "train"), json_path=str(tmp)))
    _, _, tt, ts = _pair(_desc())
    train = str(data / "train")
    for make in (lambda: tt.train(ts, train, 1, mesh=object()),
                 lambda: igt.Runner(model, mesh=object(), device="cpu")):
        with pytest.raises(TypeError, match=r"ignnition_tpu_torch\.parallel\.Mesh"):
            make()
    for make in (lambda: tt.train(ts, train, 1, model_strategy="sharded"),
                 lambda: igt.Runner(model, model_strategy="sharded", device="cpu")):
        with pytest.raises(ValueError, match="unknown model_strategy 'sharded'"):
            make()
    with pytest.raises(ValueError, match="edge_axis and node_axis are mutually exclusive"):
        tt.model.apply(ts.params, {}, None, edge_axis=object(), node_axis=object())
    plain = tt.train(tt.init_state(), train, 2, batch_size=2, shuffle=False, log_every=0)
    for kw in (dict(model_strategy="dest_shard"), dict(locality_reorder=True),
               dict(model_strategy="dest_shard", locality_reorder=True)):
        state = tt.train(tt.init_state(), train, 2, batch_size=2, shuffle=False,
                         log_every=0, **kw)
        assert state.step == 2
        for k, v in flatten_params(plain.params).items():
            torch.testing.assert_close(flatten_params(state.params)[k], v, rtol=0, atol=0)
    assert igt.Runner(model, model_strategy="dest_shard", device="cpu").model_strategy == \
        "dest_shard"
    # serving export and debug are ported: they ask for what they lack
    with pytest.raises(ValueError, match="the path of the model to export is unspecified"):
        igt.Runner(model, device="cpu").export_serving("out")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            igt.debug(model)
    assert j_trainer_mod.Trainer._TARGET_MICROBATCH_EDGES == \
        t_trainer_mod.Trainer._TARGET_MICROBATCH_EDGES == 262144
