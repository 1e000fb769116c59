"""The sharded steps compiled per key (`parallel.steps.ShardedStep` over
`training.capture.Graphs`), on the CPU and (cases marked `cuda`) on the card.

One world of 2 gloo processes (`test_torch_distributed.spawn_world`, a 1x2
mesh) runs the CPU cases:

- the four factories (`make_parallel_train_step`, `make_parallel_apply`,
  `make_edgeshard_train_step`, `make_edgeshard_apply`) built with the
  trainer's `Graphs` and with one of their own, on two batch shapes: the
  same outputs either way, one key per factory and shape, the shared ones in
  the trainer's graphs;
- the backend decision: the CPU's reason, a gloo mesh's on a card's
  `Graphs`, none for NCCL; a gloo step's calls run eagerly;
- `Trainer.train(mesh=...)`, replicated and destination-sharded, handing
  its `Graphs` to the step.

In this process: `capture.eager()` runs a step of a card's `Graphs` op by op,
and a static buffer's growth drops the same sharded graphs whatever else one
rank captures. On the card (`cuda`): a world of one over NCCL, each factory
replayed against its eager calls, bitwise. The JAX package's sharded steps
hold the shared-`Graphs` steps in `tests/test_torch_parallel.py` and
`tests/test_torch_edgeshard.py`. No JAX is imported here.
"""

import copy
import os

import numpy as np
import pytest
import torch

import ignnition_tpu_torch as igt
from ignnition_tpu_torch.data.synthetic import make_routenet_sample, write_dataset
from ignnition_tpu_torch.model.builder import map_params
from ignnition_tpu_torch.parallel import edgeshard, partition_batch, stack_batches
from ignnition_tpu_torch.training import capture

from helpers import routenet_description
from test_torch_distributed import spawn_world

torch.set_num_threads(1)

DIMS = {"link_capacity": 1, "traffic": 1}
PAD = dict(mode="multiple", multiple=64, min_size=64)
# (graphs, (links, paths, path length)) of the two batch shapes
SHAPES = ((2, (14, 10, 4)), (3, (30, 24, 5)))
FACTORIES = ("parallel_train", "parallel_apply", "edgeshard_train", "edgeshard_apply")


def _case(n_model: int) -> dict:
    """A 2-iteration, hs=8 flagship from the port's init and, for each of
    `SHAPES`, its batch stacked for a 1 x n_model mesh (`dp`) and partitioned
    over n_model (`es`; one shard: the one-cell layout)."""
    desc = routenet_description(num_iterations=2, hs=8)
    ir = igt.parse_model_description(copy.deepcopy(desc), dict(DIMS))
    params = map_params(lambda t: t.numpy(), igt.build(ir).init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(3)
    spec = igt.SampleSpec.from_ir(ir)
    dp, es = [], []
    for graphs, size in SHAPES:
        samples = [igt.convert_sample(make_routenet_sample(rng, *size), spec)
                   for _ in range(graphs)]
        arrays, meta = igt.build_batch(samples, ir, igt.PaddingConfig(**PAD), training=True)
        stacked, meta = stack_batches([(arrays, meta)], ir)
        dp.append(dict(stacked=stacked, meta=meta))
        part = (partition_batch(arrays, meta, ir, n_model) if n_model > 1
                else edgeshard._partition(arrays, meta, ir, 1))
        es.append(dict(stacked={k: v[None] for k, v in part[0].items()}, meta=part[1]))
    return dict(desc=desc, dims=DIMS, params=params, dp=dp, es=es, mesh=(1, n_model))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each rank's results of the world of 2 (gloo, a 1x2 mesh)."""
    tmp = str(tmp_path_factory.mktemp("capture_mesh"))
    data = os.path.join(tmp, "ds")
    write_dataset(data, 2, 8, seed=4, n_links=12, n_paths=8, max_path_len=4)
    case = _case(2)
    jobs = [dict(case, name="factories", kind="capture_factories"),
            dict(case, name="decision", kind="capture_decision"),
            dict(case, name="trainer", kind="capture_trainer", data=data, padding=PAD)]
    return spawn_world(2, jobs, os.path.join(tmp, "world"))


@pytest.mark.parametrize("name", FACTORIES)
def test_each_factory_with_and_without_the_trainers_graphs(world, name):
    """Built with the trainer's `Graphs` or with one of its own, a factory
    gives the same loss or predictions and parameters on every rank, runs
    each call eagerly on the CPU and says why; its graphs are the trainer's
    only when handed them."""
    for i in range(len(SHAPES)):
        shared, own = (world[0]["factories"][(name, s, i)] for s in (True, False))
        assert not shared["own"] and own["own"]
        for got in (shared, own):
            assert got["captured"] is False and got["ran"] == "eager"
            assert "runs on cpu" in got["why_eager"]
        np.testing.assert_array_equal(shared["output"], own["output"])
        if shared["params"] is not None:
            for k, v in own["params"].items():
                np.testing.assert_array_equal(shared["params"][k], v)
        other = world[1]["factories"][(name, True, i)]
        np.testing.assert_array_equal(other["output"], shared["output"])


def test_keys_of_two_batch_shapes(world):
    """The trainer's graphs hold one key per factory and batch shape (the
    kind and the shape key, as the JAX package's jits key), every one of a
    step that shares them; a step with graphs of its own holds its one key
    there."""
    got = world[0]["factories"]
    keys = got["trainer_keys"]
    assert len(keys) == len(FACTORIES) * len(SHAPES)
    assert all(shared for _, _, shared in keys)
    for name in FACTORIES:
        shapes = [k for kind, k, _ in keys if kind == name]
        assert len(set(shapes)) == len(SHAPES), name
        for i in range(len(SHAPES)):
            ((kind, shape),) = got[(name, False, i)]["keys"]
            assert kind == name and shape == shapes[i]
    assert world[1]["factories"]["trainer_keys"] == keys


def test_the_backend_decides_capture(world):
    """On the CPU every sharded step is eager; on a card a gloo mesh stays
    eager and says why (its collectives go through the host), an NCCL mesh
    captures; a gloo step's calls run eagerly even with a card's graphs."""
    for rank in world:
        got = rank["decision"]
        assert "runs on cpu" in got["cpu"]
        assert "gloo" in got["gloo_on_card"] and "CUDA graph cannot hold" in got["gloo_on_card"]
        assert got["nccl_on_card"] is None
        assert got["gloo_step"] == (False, "eager", [0.0, 1.0, 4.0, 9.0])


@pytest.mark.parametrize("strategy", ["replicated", "dest_shard"])
def test_the_trainers_mesh_loop_hands_its_graphs_to_the_step(world, strategy):
    """`Trainer.train(mesh=...)` steps through its own `Graphs`: the mesh
    step's key lies in `trainer.graphs`, its step shares them, and on the
    CPU it ran eagerly."""
    kind = "parallel_train" if strategy == "replicated" else "edgeshard_train"
    for rank in world:
        got = rank["trainer"][strategy]
        mine = [g for g in got if g[0] == kind]
        assert mine and len(mine) == len(got)
        for _, shared, last, why in mine:
            assert shared and last == "eager" and "runs on cpu" in why


def test_eager_context_keeps_a_card_step_off_the_card():
    """Inside `capture.eager()` a step of a card's `Graphs` runs its function
    on the caller's tensors and touches no graph, stream or buffer."""
    graphs = capture.Graphs(torch.device("cuda", 0))
    step = graphs.step(lambda bound, inputs: {"y": inputs["x"] + bound}, ("k",), "a step")
    with capture.eager():
        out = step(torch.tensor(1.0), {"x": torch.arange(3.0)})
    assert step.last == "eager" and out["y"].tolist() == [1.0, 2.0, 3.0]
    assert graphs._stream is None and graphs.static_bytes() == 0


def _pretend_captured(graphs, key, size, owner=None):
    """A step of `key` that holds a graph reading a static input of `size`
    (what `CapturedStep._capture` leaves behind); made by `owner`, a
    sharded step, it reads the sharded steps' set of buffers."""
    step = graphs.step(lambda b, i: i, key, "a step", owner=owner)
    step._static = {"x": graphs.static_input("x", torch.zeros(size), step)}
    step._graph = object()
    return step


def test_buffer_growth_drops_the_same_mesh_graphs_on_every_rank():
    """Two ranks capture the same sequence of mesh keys (the second grows
    the shared buffer and drops the first's graph); the first rank alone
    also captures an evaluation key with a larger input. The mesh graphs
    left are the same on both ranks, since the evaluation grows the
    owner's other set of buffers."""
    held = []
    for rank in range(2):
        graphs, sharded = capture.Graphs("cpu"), object()
        small = _pretend_captured(graphs, ("mesh", 1), 10, sharded)
        large = _pretend_captured(graphs, ("mesh", 2), 20, sharded)
        assert small._graph is None and large._graph is not None
        small = _pretend_captured(graphs, ("mesh", 1), 10, sharded)
        if rank == 0:
            _pretend_captured(graphs, ("eval",), 50)
        held.append(sorted(k for k, s in graphs.captured.items()
                           if s.sharded and s._graph is not None))
        assert graphs.static_bytes() == (20 + (50 if rank == 0 else 0)) * 4
    assert held[0] == held[1] == [("mesh", 1), ("mesh", 2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_nccl_world_of_one_replays_as_eager(cuda_device, tmp_path):
    """A world of one over NCCL (a 1x1 mesh): each factory called 4 times
    from one state eagerly and through its graphs (a warm-up, a capture, 2
    replays), every loss or prediction and every parameter bitwise equal."""
    case = dict(_case(1), name="replay", kind="replay_vs_eager", calls=4)
    (got,) = spawn_world(1, [case], str(tmp_path / "nccl"), init="nccl")
    for name in FACTORIES:
        eager, replayed = got["replay"][(name, "eager")], got["replay"][(name, "replayed")]
        assert replayed["captured"] and eager["ran"] == ["eager"] * 4
        assert replayed["ran"] == ["warm-up", "capture", "replay", "replay"]
        for a, b in zip(eager["outputs"], replayed["outputs"]):
            np.testing.assert_array_equal(a, b)
        for k, v in eager["params"].items():
            np.testing.assert_array_equal(replayed["params"][k], v, err_msg=k)

