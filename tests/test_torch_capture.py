"""The port's compiled steps (`training/capture.py`) and what they stand on,
on the CPU and (cases marked `cuda`) on the card.

- The optimizer with its count, schedule, step sizes and Nadam's product on
  the parameters' device, against the JAX package's optax transformation
  over 10 steps, for every kind and clip option under a constant rate and
  ExponentialDecay with and without staircase; the schedules of a count
  tensor against those of a Python int.
- A checkpoint written before the count and `u_prod` were tensors (an int
  and a float) resumes to the parameters of an uninterrupted run.
- `train_step_fn`, `accum_train_step_fn` and `eval_step_fn` give one step per
  key, as the JAX package's jitted steps; on the CPU each runs eagerly.
- The capacity warning counts a captured step's static copy of the batch.
- On the card: replayed steps against eager ones on two different batches
  of one meta, also over the windowed slice sort (whose permutation is
  cached on its tensor); two metas sharing the static buffers; a replay
  after the state was swapped; a failed capture.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ignnition_tpu_torch as igt
from ignnition_tpu.frontend.ir import OptimizerSpec as JOptimizerSpec
from ignnition_tpu.frontend.ir import ScheduleSpec as JScheduleSpec
from ignnition_tpu.training import optimizers as j_opt
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data import graph as t_graph
from ignnition_tpu_torch.data.graph import merge_metas
from ignnition_tpu_torch.data.synthetic import make_routenet_sample
from ignnition_tpu_torch.frontend.ir import OptimizerSpec, ScheduleSpec
from ignnition_tpu_torch.model.builder import flatten_params
from ignnition_tpu_torch.training import capture
from ignnition_tpu_torch.training import optimizers as t_opt
from ignnition_tpu_torch.training.packing import pack_arrays, pack_layout
from ignnition_tpu_torch.training.trainer import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)

from helpers import routenet_description
from test_torch_train import SCHEDULES

torch.set_num_threads(1)

DIMS = {"link_capacity": 1, "traffic": 1}
PAD = dict(mode="multiple", multiple=64, min_size=64)

# every kind, and each option that changes its arithmetic
KINDS = {
    "Adam": ("Adam", {}),
    "Adam_amsgrad": ("Adam", {"amsgrad": True}),
    "AdamW": ("AdamW", {"weight_decay": 0.05}),
    "SGD": ("SGD", {}),
    "SGD_momentum": ("SGD", {"momentum": 0.9}),
    "SGD_nesterov": ("SGD", {"momentum": 0.8, "nesterov": True}),
    "RMSprop": ("RMSprop", {}),
    "RMSprop_centered_momentum": ("RMSprop", {"centered": True, "momentum": 0.9}),
    "Adagrad": ("Adagrad", {}),
    "Adadelta": ("Adadelta", {"learning_rate": 1.0}),
    "Adamax": ("Adamax", {}),
    "Nadam": ("Nadam", {}),
}
CLIPS = {"none": {}, "clipvalue": {"clipvalue": 0.5}, "clipnorm": {"clipnorm": 1.0},
         "global_clipnorm": {"global_clipnorm": 1.0}}
RATES = {
    "constant": None,
    "exponential": ("ExponentialDecay", {"initial_learning_rate": 0.02, "decay_steps": 3,
                                         "decay_rate": 0.5}),
    "exponential_staircase": ("ExponentialDecay", {"initial_learning_rate": 0.02,
                                                   "decay_steps": 3, "decay_rate": 0.5,
                                                   "staircase": True}),
}


def _jax_flat(tree):
    return {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(tree)
    }


def _specs(kind, options, rate):
    """The JAX and the port optimizer specs of one case."""
    options = dict(options)
    if rate is None:
        options.setdefault("learning_rate", 0.01)
    else:
        options.pop("learning_rate", None)
    j = JOptimizerSpec(kind=kind, params=options,
                       schedule=None if rate is None else JScheduleSpec(kind=rate[0],
                                                                        params=rate[1]))
    t = OptimizerSpec(kind=kind, params=options,
                      schedule=None if rate is None else ScheduleSpec(kind=rate[0],
                                                                      params=rate[1]))
    return j, t


@pytest.mark.parametrize("rate", sorted(RATES))
@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("case", sorted(KINDS))
def test_device_scalar_optimizer_matches_optax(case, clip, rate):
    """10 steps on a small tree (one leaf of zero gradients) against the JAX
    package's optax transformation: every leaf within 1e-5 of its largest
    entry; the count and Nadam's product stay 0-d tensors, updated in place."""
    kind, options = KINDS[case]
    j_spec, t_spec = _specs(kind, {**options, **CLIPS[clip]}, RATES[rate])
    j_tx, t_tx = j_opt.build_optimizer(j_spec), t_opt.build_optimizer(t_spec)
    rng = np.random.default_rng(7)
    p0 = {"a": {"kernel": rng.standard_normal((4, 3)).astype(np.float32)},
          "b": (rng.standard_normal(5).astype(np.float32),),
          "frozen": np.ones(3, np.float32)}
    j_params = jax.tree.map(jnp.asarray, p0)
    j_state = j_tx.init(j_params)
    t_params = igt.params_from_jax(p0)
    t_state = t_tx.init(t_params)
    count = t_state["count"]
    u_prod = t_state.get("u_prod")
    for _ in range(10):
        g = {"a": {"kernel": rng.standard_normal((4, 3)).astype(np.float32)},
             "b": (3.0 * rng.standard_normal(5).astype(np.float32),),
             "frozen": np.zeros(3, np.float32)}
        updates, j_state = j_tx.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_tx.step(t_params, igt.params_from_jax(g), t_state)
        want = _jax_flat(j_params)
        for k, v in flatten_params(t_params).items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0,
                                       atol=1e-5 * np.abs(want[k]).max(), err_msg=k)
    assert t_state["count"] is count and count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == 10
    if kind == "Nadam":
        assert t_state["u_prod"] is u_prod and u_prod.dtype == torch.float32
        (want,) = [v for k, v in _jax_flat(j_state).items() if k.endswith("u_prod")]
        np.testing.assert_allclose(float(u_prod), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_of_a_count_tensor(name):
    """A schedule takes the optimizer's count tensor (int32) and gives a 0-d
    f64 tensor on its device, equal to its value at the same Python int."""
    kind = name.split("_")[0]
    fn = t_opt.build_schedule(ScheduleSpec(kind=kind, params=SCHEDULES[name]))
    for step in list(range(0, 22)) + [100]:
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert isinstance(got, torch.Tensor) and got.dim() == 0 and got.dtype == torch.float64
        assert float(got) == float(fn(step)), step


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_optimizer_state_lives_on_the_params_device(device):
    """`count` (int32) and Nadam's `u_prod` (f32) are 0-d tensors on the
    parameters' device; a state whose count is an int and product a float
    (made before they were tensors) is turned into such tensors by a step."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tx = t_opt.build_optimizer(OptimizerSpec(kind="Nadam", params={}, schedule=ScheduleSpec(
        kind="ExponentialDecay", params=RATES["exponential"][1])))
    params = {"w": torch.ones(3, 2, device=device)}
    state = tx.init(params)
    for name, dtype in (("count", torch.int32), ("u_prod", torch.float32)):
        v = state[name]
        assert v.dim() == 0 and v.dtype == dtype and v.device == params["w"].device, name
    old = {"count": 2, "u_prod": 0.5, "mu": {"w": torch.zeros(3, 2, device=device)},
           "nu": {"w": torch.zeros(3, 2, device=device)}}
    tx.step(params, {"w": torch.ones(3, 2, device=device)}, old)
    assert old["count"].device == params["w"].device and int(old["count"]) == 3
    assert old["u_prod"].dtype == torch.float32 and float(old["u_prod"]) < 0.5


def _trainer(optimizer, device="cpu", compute_dtype=None):
    desc = routenet_description(num_iterations=2, hs=8)
    desc["learning_options"]["optimizer"] = optimizer
    ir = igt.parse_model_description(desc, DIMS)
    return igt.Trainer(igt.build(ir), igt.PaddingConfig(**PAD), compute_dtype=compute_dtype,
                       device=device)


def _batches(trainer, n, seed=0, size=(32, 24, 6)):
    """`n` training batches of one meta, each of one graph of its own of
    `size` (`make_routenet_sample`'s sizes)."""
    rng = np.random.default_rng(seed)
    spec = igt.SampleSpec.from_ir(trainer.ir)
    samples = [igt.convert_sample(make_routenet_sample(rng, *size), spec)
               for _ in range(n)]
    pad = igt.PaddingConfig(**PAD)
    meta = merge_metas([igt.build_batch([s], trainer.ir, pad, training=True)[1]
                        for s in samples], trainer.ir)
    arrays = [igt.build_batch([s], trainer.ir, pad, training=True, target=meta)[0]
              for s in samples]
    return arrays, meta


NADAM_DECAY = {"type": "Nadam", "schedule": {
    "type": "ExponentialDecay", "initial_learning_rate": 0.01, "decay_steps": 2,
    "decay_rate": 0.5}}


@pytest.mark.parametrize("kind", ["Nadam", "Adam"])
def test_checkpoint_from_before_device_counts_resumes(tmp_path, kind):
    """A checkpoint whose `count` is a Python int and `u_prod` a float (as
    written before they were tensors), restored into a fresh state: two more
    steps give bitwise the parameters and state of 4 uninterrupted steps."""
    optimizer = dict(NADAM_DECAY, type=kind)
    trainer = _trainer(optimizer)
    arrays, meta = _batches(trainer, 2)
    batches = [to_device(a, "cpu") for a in arrays]
    step = trainer.train_step_fn(meta)
    whole = trainer.init_state(torch.Generator().manual_seed(3))
    for i in range(4):
        whole, _ = step(whole, batches[i % 2])
    part = trainer.init_state(torch.Generator().manual_seed(3))
    for i in range(2):
        part, _ = step(part, batches[i % 2])
    manager = CheckpointManager(str(tmp_path / "ck"))
    save_checkpoint(manager, part)
    path = tmp_path / "ck" / "2" / "state.pt"
    payload = torch.load(path, weights_only=True)
    payload["opt_state"]["count"] = int(payload["opt_state"]["count"])
    if kind == "Nadam":
        payload["opt_state"]["u_prod"] = float(payload["opt_state"]["u_prod"])
    torch.save(payload, path)
    fresh = trainer.init_state(torch.Generator().manual_seed(4))
    count = fresh.opt_state["count"]
    fresh = restore_checkpoint(manager, fresh)
    assert fresh.step == 2 and fresh.opt_state["count"] is count and int(count) == 2
    for i in range(2, 4):
        fresh, _ = step(fresh, batches[i % 2])
    for tree in ("params", "opt_state"):
        got = flatten_params(getattr(fresh, tree))
        for k, v in flatten_params(getattr(whole, tree)).items():
            assert torch.equal(got[k], v), (tree, k)


def test_steps_are_one_per_key_and_eager_on_the_cpu():
    """One step per key, as the JAX package's `_train_steps`, `_accum_steps`
    and `_eval_steps`: the same object for the same key, another for
    another key; on the CPU every call runs eagerly."""
    trainer = _trainer({"type": "Adam", "learning_rate": 0.001})
    arrays, meta = _batches(trainer, 2)
    layout = pack_layout(arrays[0])
    step = trainer.train_step_fn(meta)
    assert trainer.train_step_fn(meta) is step
    assert trainer.train_step_fn(meta, layout=layout) is trainer.train_step_fn(meta, layout)
    assert trainer.train_step_fn(meta, layout=layout) is not step
    accum = trainer.accum_train_step_fn(meta, 2)
    assert trainer.accum_train_step_fn(meta, 2) is accum
    assert trainer.accum_train_step_fn(meta, 3) is not accum
    evaluate = trainer.eval_step_fn(meta)
    assert trainer.eval_step_fn(meta) is evaluate
    state = trainer.init_state()
    state, metrics = step(state, to_device(arrays[0], "cpu"))
    packed = to_device(pack_arrays(arrays[1], layout), "cpu")
    state, _ = trainer.train_step_fn(meta, layout)(state, packed)
    stacked = {k: torch.stack([torch.as_tensor(a[k]) for a in arrays]) for k in arrays[0]}
    state, _ = accum(state, stacked)
    preds, loss = evaluate(state.params, to_device(arrays[0], "cpu"))
    assert state.step == 3 and int(state.opt_state["count"]) == 3
    assert np.isfinite(float(metrics["total"])) and np.isfinite(float(loss))
    assert sorted(k[0] for k in trainer.graphs.captured) == ["accum", "accum", "eval",
                                                              "train", "train"]
    assert {c.last for c in trainer.graphs.captured.values()} == {"eager", None}


def test_capacity_estimate_counts_the_captured_inputs(monkeypatch):
    """A captured step's static input buffers are one more copy of the batch
    in the footprint that the capacity warning weighs."""
    from ignnition_tpu_torch.utils import memory as t_memory

    trainer = _trainer({"type": "Adam", "learning_rate": 0.001})
    _, meta = _batches(trainer, 1)
    weighed = []
    monkeypatch.setattr(t_memory, "recommended_shards",
                        lambda total, hbm_gb=None: weighed.append(total) or 1)
    t_memory.maybe_warn_capacity(trainer.ir, meta)
    t_memory.maybe_warn_capacity(trainer.ir, meta, captured=True)
    est = t_memory.estimate_train_hbm(trainer.ir, meta)
    assert est["batch_bytes"] > 0
    assert weighed == [est["total_bytes"], est["total_bytes"] + est["batch_bytes"]]


def test_eager_context():
    assert not capture.is_eager()
    with capture.eager():
        assert capture.is_eager()
        with capture.eager():
            assert capture.is_eager()
        assert capture.is_eager()
    assert not capture.is_eager()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _equal_trees(a, b, what):
    fa, fb = flatten_params(a), flatten_params(b)
    for k, v in fa.items():
        assert torch.equal(v, fb[k]), (what, k)


def _replays_as_eager(trainer, batches, meta):
    """Four steps over `batches` (two of one meta), eager and through the
    captured step (a warm-up, a capture, two replays), from one state: equal
    losses, parameters and optimizer state. Returns the captured step."""
    eager_state = trainer.init_state(torch.Generator().manual_seed(0))
    state = trainer.init_state(torch.Generator().manual_seed(0))
    step = trainer.train_step_fn(meta)
    captured = trainer.graphs.captured[("train", meta, None)]
    seen = []
    for i in range(4):
        with capture.eager():
            eager_state, want = step(eager_state, batches[i % 2])
        state, got = step(state, batches[i % 2])
        seen.append(captured.last)
        assert float(got["total"]) == float(want["total"]), i
    assert seen == ["warm-up", "capture", "replay", "replay"]
    _equal_trees(state.params, eager_state.params, "params")
    _equal_trees(state.opt_state, eager_state.opt_state, "opt_state")
    return captured, state


@pytest.mark.cuda
def test_replay_matches_eager_on_two_batches(cuda_device):
    """Steps over two batches of one meta replay as they run eagerly
    (`_replays_as_eager`); then the evaluation step does too."""
    trainer = _trainer(NADAM_DECAY, device=cuda_device)
    arrays, meta = _batches(trainer, 2)
    batches = [to_device(a, cuda_device) for a in arrays]
    _, state = _replays_as_eager(trainer, batches, meta)
    evaluate = trainer.eval_step_fn(meta)
    for i in range(3):
        preds, loss = evaluate(state.params, batches[i % 2])
        with capture.eager():
            want_p, want_l = evaluate(state.params, batches[i % 2])
        assert torch.equal(preds, want_p) and float(loss) == float(want_l)


@pytest.mark.cuda
def test_windowed_step_replays_as_eager_on_two_batches(cuda_device, monkeypatch):
    """The step over the windowed slice sort (the x4 path's backward; here
    windows of 50 slots), whose whole permutation `_whole_sort_perm` keeps
    on its tensor: two batches of one meta replay as they run eagerly, so no
    replay reads the permutation of the batch it was captured with."""
    monkeypatch.setattr(t_graph, "_DENSE_INC_MAX_ENTRIES", 0)
    monkeypatch.setattr(t_graph, "_SLICE_SORT_CHUNK", 50)
    trainer = _trainer({"type": "Adam", "learning_rate": 0.01}, device=cuda_device)
    arrays, meta = _batches(trainer, 2)
    perms = [k for k in arrays[0] if k.startswith("slice_sort_perm_")]
    assert perms and not all(np.array_equal(arrays[0][k], arrays[1][k]) for k in perms)
    batches = [to_device(a, cuda_device) for a in arrays]
    captured, _ = _replays_as_eager(trainer, batches, meta)
    assert captured.recorded["csr_segment_sum_windows"] > 0


@pytest.mark.cuda
def test_keys_share_the_static_buffers(cuda_device):
    """Two metas of one trainer read one set of static input buffers, each as
    large as the larger meta's input: the larger meta's capture replaces the
    buffers and drops the smaller meta's graph, which captures again (no
    warm-up) at its next call. Every call equals the eager one."""
    trainer = _trainer({"type": "Adam", "learning_rate": 0.001}, device=cuda_device)
    small, small_meta = _batches(trainer, 1)
    big, big_meta = _batches(trainer, 1, seed=1, size=(64, 48, 6))
    assert small_meta != big_meta
    calls = [(small_meta, small[0])] * 3 + [(big_meta, big[0])] * 3 + [(small_meta, small[0])] * 2
    state = trainer.init_state(torch.Generator().manual_seed(0))
    eager_state = trainer.init_state(torch.Generator().manual_seed(0))
    seen = []
    for meta, arrays in calls:
        batch = to_device(arrays, cuda_device)
        step = trainer.train_step_fn(meta)
        with capture.eager():
            eager_state, want = step(eager_state, batch)
        state, got = step(state, batch)
        seen.append(trainer.graphs.captured[("train", meta, None)].last)
        assert float(got["total"]) == float(want["total"]), len(seen)
    assert seen == ["warm-up", "capture", "replay", "warm-up", "capture", "replay",
                    "capture", "replay"]
    _equal_trees(state.params, eager_state.params, "params")
    largest = {}
    for arrays in (small[0], big[0]):
        for k, v in to_device(arrays, cuda_device).items():
            largest[(k, v.dtype)] = max(largest.get((k, v.dtype), 0), v.numel() * v.element_size())
    assert trainer.graphs.static_bytes() == sum(largest.values())


@pytest.mark.cuda
def test_replay_after_the_state_was_swapped(cuda_device):
    """A captured step called with another state's tensors starts again
    (warm-up, capture) and leaves the first state as it was."""
    trainer = _trainer({"type": "Adam", "learning_rate": 0.001}, device=cuda_device)
    arrays, meta = _batches(trainer, 2)
    batches = [to_device(a, cuda_device) for a in arrays]
    step = trainer.train_step_fn(meta)
    captured = trainer.graphs.captured[("train", meta, None)]
    first = trainer.init_state(torch.Generator().manual_seed(0))
    for i in range(3):
        first, _ = step(first, batches[i % 2])
    assert captured.last == "replay"
    kept = {k: v.detach().clone() for k, v in flatten_params(first.params).items()}
    second = trainer.init_state(torch.Generator().manual_seed(1))
    eager_second = trainer.init_state(torch.Generator().manual_seed(1))
    seen = []
    for i in range(3):
        second, got = step(second, batches[i % 2])
        seen.append(captured.last)
        with capture.eager():
            eager_second, want = step(eager_second, batches[i % 2])
        assert float(got["total"]) == float(want["total"]), i
    assert seen == ["warm-up", "capture", "replay"]
    _equal_trees(second.params, eager_second.params, "params")
    for k, v in flatten_params(first.params).items():
        assert torch.equal(v, kept[k]), k


def test_paused_gc_restores_the_collector():
    """`paused_gc` turns the cyclic collector off for its block and back to
    what it was after, also when the block raises."""
    assert gc.isenabled()
    with capture.paused_gc():
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(KeyError):
        with capture.paused_gc():
            raise KeyError("x")
    assert gc.isenabled()
    gc.disable()
    try:
        with capture.paused_gc():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


@pytest.mark.cuda
def test_a_collection_during_a_capture_destroys_no_graph(cuda_device):
    """A dead cycle holding a CUDA graph that another capture made, left for
    the collector while a step captures, with the collector set to run at
    every allocation: the step still captures and replays (the collector is
    paused for the capture; destroying a graph there is a CUDA call that
    invalidates the capture), and the step's function sees the collector off
    only while it is captured."""
    x = torch.ones(4, device=cuda_device)
    dead = [torch.cuda.CUDAGraph()]
    with torch.cuda.graph(dead[0]):
        x * 3
    graphs = capture.Graphs(cuda_device)
    collecting = []

    def fn(bound, inputs):
        collecting.append(gc.isenabled())
        if len(collecting) == 2:
            cycle = [dead.pop()]
            cycle.append(cycle)
            del cycle
            [[] for _ in range(1000)]
        return inputs["x"] * 2

    step = graphs.step(fn, ("probe", 8), "a probe")
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        outs = [step((), {"x": x}) for _ in range(3)]
    finally:
        gc.set_threshold(*threshold)
    assert collecting == [True, False] and step.last == "replay"
    assert all(torch.equal(o, x * 2) for o in outs)


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda_device):
    """A step that reads a value back to the host cannot be captured: the
    second call raises `CaptureError` naming the key."""
    graphs = capture.Graphs(cuda_device)
    step = graphs.step(lambda bound, inputs: inputs["x"] * float(inputs["x"].sum()),
                       ("probe", 7), "a probe")
    x = {"x": torch.ones(4, device=cuda_device)}
    step((), x)
    with pytest.raises(capture.CaptureError, match="probe"):
        step((), x)
