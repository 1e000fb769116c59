"""The port's multi-process layer on the CPU: worlds of spawned processes
joined over gloo (`torch.distributed`), and the worker that runs them.

`spawn_world` runs this file as a script in `world` processes. Each joins
the world, runs the job's cases in order (a case names a mesh shape; ranks
outside that mesh wait) and writes what its cases return; the parent reads
every rank's results. A rank that fails fails the world: the parent kills
the rest and raises with every rank's output, and a world that outlives its
time limit is killed as well, so that a hang fails one test. The workers
import torch and the port only: no JAX and nothing of the JAX package
(checked at their end). `tests/test_torch_parallel.py` holds the parallel
steps to the JAX package with this worker, `tests/test_torch_edgeshard.py`
the destination-sharded ones (the `es_*` cases); the tests here need no JAX:
`distributed.initialize`, `make_pod_mesh` and `host_shard_iter` in a
two-process run, as `tests/test_distributed.py` runs the JAX functions.
"""

import contextlib
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_SECONDS = 240  # a world's time limit: its ranks are killed past it


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_world(world: int, cases: list, job_dir: str, init: str = "worker",
                timeout: float = WORLD_SECONDS) -> list:
    """Run `cases` in a world of `world` ranks; returns each rank's
    {case name: result}. init: "worker" joins the world with
    `dist.init_process_group`, "initialize" with the port's
    `distributed.initialize`, "nccl" with it on the card (NCCL: one rank a
    card)."""
    os.makedirs(job_dir, exist_ok=True)
    with open(os.path.join(job_dir, "job.pkl"), "wb") as f:
        pickle.dump({"cases": cases, "init": init}, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               LOCAL_WORLD_SIZE=str(world))
    logs = [os.path.join(job_dir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", job_dir, str(port),
                 str(r), str(world)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO,
            ))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the world outlived its {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is None and any(p.returncode != 0 for p in procs):
        failed = "a rank failed: " + str([p.returncode for p in procs])
    if failed is not None:
        outputs = "\n".join(f"--- rank {r}:\n{open(logs[r]).read()[-3000:]}"
                            for r in range(world))
        raise AssertionError(f"world of {world}: {failed}\n{outputs}")
    out = []
    for r in range(world):
        with open(os.path.join(job_dir, f"out_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# --------------------------------------------------------------------------
# the worker: cases by kind
# --------------------------------------------------------------------------


def _model(case):
    import ignnition_tpu_torch as igt

    ir = igt.parse_model_description(case["desc"], dict(case["dims"]))
    return igt.build(ir)


def _trainer(case, device="cpu"):
    from ignnition_tpu_torch.training.trainer import Trainer

    trainer = Trainer(_model(case), device=device)
    return trainer, trainer.init_state(params=case["params"])


def _flat(params):
    from ignnition_tpu_torch.model.builder import flatten_params

    return {k: v.detach().cpu().numpy().copy() for k, v in flatten_params(params).items()}


def _raised(fn):
    """The message of what `fn()` raised, or None."""
    try:
        fn()
    except (ValueError, NotImplementedError, TypeError) as err:
        return f"{type(err).__name__}: {err}"
    return None


def case_apply(case, mesh):
    """The sharded forward's stacked predictions."""
    from ignnition_tpu_torch.parallel import make_parallel_apply

    trainer, state = _trainer(case)
    fn = make_parallel_apply(trainer.model, case["meta"], mesh, device="cpu")
    return fn(state.params, case["stacked"]).numpy()


def case_step(case, mesh):
    """`steps` sharded training steps: each step's loss, the parameters
    after the last."""
    from ignnition_tpu_torch.parallel import make_parallel_train_step

    trainer, state = _trainer(case)
    step = make_parallel_train_step(trainer.model, trainer.optimizer, trainer.loss_fn,
                                    case["meta"], mesh, device="cpu",
                                    graphs=trainer.graphs if case.get("shared_graphs") else None)
    stacked = case["stacked_by_rank"][mesh.coords] if "stacked_by_rank" in case else (
        case["stacked"])
    losses = []
    for _ in range(case.get("steps", 1)):
        _, _, loss = step(state.params, state.opt_state, stacked,
                          generator=trainer.generator)
        losses.append(float(loss))
    return {"losses": losses, "params": _flat(state.params),
            "graphs_are_the_trainers": step.graphs is trainer.graphs,
            "ran": step.last.last, "why_eager": step.why_eager}


def case_step_raises(case, mesh):
    """What a sharded step raises on these inputs (None if nothing)."""
    return _raised(lambda: case_step(case, mesh))


def case_single_step(case, mesh):
    """The single-device `Trainer.train_step_fn` on this rank's stacked row
    (no collectives): the reference of a 1x1 mesh."""
    from ignnition_tpu_torch.batch import to_device

    trainer, state = _trainer(case)
    arrays = {k: v[0] for k, v in case["stacked"].items()}
    _, metrics = trainer.train_step_fn(case["meta"])(state, to_device(arrays, "cpu"))
    return {"losses": [float(metrics["loss"])], "params": _flat(state.params)}


def case_serial_step(case, mesh):
    """The serial reference of a sharded step (the JAX test's): each step
    the mean of the single-device gradients of the stacked batch's rows,
    one optimizer update; the mean of their losses."""
    import torch

    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params, with_leaves

    trainer, state = _trainer(case)
    grads = trainer.grads_fn(case["meta"])
    rows = next(iter(case["stacked"].values())).shape[0]
    losses = []
    for _ in range(case.get("steps", 1)):
        total, loss = None, 0.0
        for i in range(rows):
            g, m = grads(state.params, to_device({k: v[i] for k, v in case["stacked"].items()},
                                                 "cpu"))
            g = list(flatten_params(g).values())
            total = g if total is None else [a + b for a, b in zip(total, g)]
            loss += float(m["loss"])
        mean = [t / rows for t in total]
        with torch.no_grad():
            trainer.optimizer.step(state.params, with_leaves(state.params, mean),
                                   state.opt_state)
        losses.append(loss / rows)
    return {"losses": losses, "params": _flat(state.params)}


def case_train(case, mesh):
    """`Trainer.train` over the mesh from the description's own init, the
    evaluation loss before and after, and what the run wrote."""
    import torch

    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.training.trainer import Trainer

    trainer = Trainer(_model(case), padding=igt.PaddingConfig(**case["padding"]),
                      device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    data = case["data"]
    before = trainer.evaluate(state, data, num_batches=2, batch_size=2)["loss"]
    ckpt = case.get("checkpoint_dir")
    state = trainer.train(state, data, max_steps=case["steps"], batch_size=2,
                          shuffle=case.get("shuffle", False), log_every=0, mesh=mesh,
                          checkpoint_dir=ckpt)
    after = trainer.evaluate(state, data, num_batches=2, batch_size=2)["loss"]
    return {"before": before, "after": after, "step": state.step,
            "params": _flat(state.params)}


def case_runner(case, mesh):
    """`Runner(model, mesh=...).train_and_evaluate()` from a RunConfig, and
    the run directories under model_dir."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.config import RunConfig

    model = igt.create_model(RunConfig(**case["config"]))
    runner = igt.Runner(model, mesh=mesh, device="cpu",
                        padding=igt.PaddingConfig(**case["padding"]))
    before = runner.evaluate(runner._init_state())["loss"]
    state = runner.train_and_evaluate()
    after = runner.evaluate(state)["loss"]
    return {"before": before, "after": after, "step": state.step,
            "params": _flat(state.params)}


def case_distributed(case, mesh):
    """`make_pod_mesh`, `host_shard_iter` and a step over the pod mesh, in a
    world joined by `distributed.initialize`."""
    import torch.distributed as dist

    from ignnition_tpu_torch.parallel import distributed, make_mesh

    out = {
        "world": dist.get_world_size(), "backend": dist.get_backend(),
        "dealt": list(distributed.host_shard_iter(iter(range(10)))),
        "too_wide": _raised(lambda: distributed.make_pod_mesh(model_axis_per_host=3)),
        "too_big": _raised(lambda: make_mesh(data=2, model=2)),
    }
    pod = distributed.make_pod_mesh(model_axis_per_host=2)
    out["model_axis_mesh"] = (dict(pod.shape), pod.coords)
    out["step"] = case_step(case, pod)
    across = distributed.make_pod_mesh(model_axis_per_host=1)
    out["data_axis_mesh"] = (dict(across.shape), across.coords)
    return out


def case_es_apply(case, mesh):
    """The destination-sharded forward's stacked predictions."""
    from ignnition_tpu_torch.parallel import make_edgeshard_apply

    trainer, state = _trainer(case)
    fn = make_edgeshard_apply(trainer.model, case["meta"], mesh, device="cpu")
    return fn(state.params, case["stacked"]).numpy()


def case_es_step(case, mesh):
    """`steps` destination-sharded training steps: each step's loss, the
    parameters after the last."""
    from ignnition_tpu_torch.parallel import make_edgeshard_train_step

    trainer, state = _trainer(case)
    step = make_edgeshard_train_step(trainer.model, trainer.optimizer, trainer.loss_fn,
                                     case["meta"], mesh, device="cpu",
                                     graphs=trainer.graphs if case.get("shared_graphs") else None)
    stacked = case["stacked_by_rank"][mesh.coords] if "stacked_by_rank" in case else (
        case["stacked"])
    losses = []
    for _ in range(case.get("steps", 1)):
        _, _, loss = step(state.params, state.opt_state, stacked,
                          generator=trainer.generator)
        losses.append(float(loss))
    return {"losses": losses, "params": _flat(state.params),
            "graphs_are_the_trainers": step.graphs is trainer.graphs,
            "ran": step.last.last, "why_eager": step.why_eager}


def case_es_step_raises(case, mesh):
    """What a destination-sharded step raises on these inputs (None if
    nothing)."""
    return _raised(lambda: case_es_step(case, mesh))


def case_es_train(case, mesh):
    """`Trainer.train(mesh, model_strategy="dest_shard")` from the given
    weights: the evaluation loss before and after, the parameters."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.training.trainer import Trainer

    trainer = Trainer(_model(case), padding=igt.PaddingConfig(**case["padding"]),
                      device="cpu")
    state = trainer.init_state(params=case["params"])
    data = case["data"]
    before = trainer.evaluate(state, data, num_batches=2, batch_size=case["batch_size"])["loss"]
    state = trainer.train(state, data, max_steps=case["steps"], batch_size=case["batch_size"],
                          shuffle=False, log_every=0, mesh=mesh, model_strategy="dest_shard",
                          locality_reorder=case.get("locality_reorder", "auto"),
                          cache_batches=case.get("cache", False))
    after = trainer.evaluate(state, data, num_batches=2, batch_size=case["batch_size"])["loss"]
    return {"before": before, "after": after, "step": state.step,
            "params": _flat(state.params)}


def case_es_gather(case, mesh):
    """The overlapped halo gather (`model.builder._halo_gather`) and the
    synchronous `halo_extend(table)[src]` of this rank's local batch, on a
    seeded table: both outputs on the real edges, and both gradients of the
    table for a seeded cotangent."""
    import torch

    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import _halo_gather
    from ignnition_tpu_torch.ops import segment as seg

    d, m = mesh.coords
    batch = to_device({k: v[d, m] for k, v in case["stacked"].items()
                       if not k.startswith("edge_origin_")}, "cpu")
    out = {}
    for a, rows in case["tables"].items():
        gen = torch.Generator().manual_seed(100 * m + len(a))
        table = torch.randn(rows, case["width"], generator=gen, dtype=torch.float64)
        real = batch[f"edge_mask_{a}"] > 0
        ct = torch.randn(int(real.shape[0]), case["width"], generator=gen, dtype=torch.float64)
        got = []
        for fn in (lambda t: _halo_gather(batch, a, t, mesh.model_group),
                   lambda t: seg.halo_extend(t, batch[f"halo_send_{a}"],
                                             mesh.model_group)[batch[f"src_{a}"]]):
            t = table.clone().requires_grad_(True)
            y = fn(t)
            (g,) = torch.autograd.grad((y * real[:, None] * ct).sum(), t)
            got.append((y[real].detach().numpy(), g.numpy()))
        out[a] = got
    return out


def case_es_grads(case, mesh):
    """This rank's gradients of the destination-sharded loss (the steps'
    mask-weighted mean over the model axis, before the gradients'
    all-reduce) under each setting of `model.builder`'s switches in
    `case["settings"]` ({name: {switch: value}}): {name: {leaf: array}}."""
    import torch

    from ignnition_tpu_torch.model.builder import flatten_params, with_leaves
    from ignnition_tpu_torch.ops._collectives import psum
    from ignnition_tpu_torch.parallel.edgeshard import _local_cell

    trainer, state = _trainer(case)
    batch = _local_cell(case["stacked"], mesh, "cpu")
    group = mesh.model_group
    names = list(flatten_params(state.params))
    out = {}
    for name, setting in case["settings"].items():
        with _builder_switches(setting):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in flatten_params(state.params).values()]
            preds = trainer.model.apply(with_leaves(state.params, leaves), batch, case["meta"],
                                        training=True, generator=trainer.generator,
                                        node_axis=group)
            loss = trainer.loss_fn(batch["label"], preds, batch["label_mask"])
            cnt = torch.sum(batch["label_mask"])
            loss = psum(loss * cnt, group) / torch.clamp_min(psum(cnt, group), 1.0)
            grads = torch.autograd.grad(loss, leaves)
        out[name] = {k: g.numpy().copy() for k, g in zip(names, grads)}
    return out


def case_es_pool_tie(case, mesh):
    """`graph_pool(..., "max", group)` over this rank's rows of a column with
    a maximum tied across ranks: the pooled value and the gradient for this
    rank's rows of its sum over 1/n_model (the steps' scale: the psum's
    backward adds every rank's cotangent)."""
    import torch

    from ignnition_tpu_torch.ops import segment as seg

    m = mesh.coords[1]
    rows = len(case["x"]) // mesh.shape["model"]
    sl = slice(m * rows, (m + 1) * rows)
    x = torch.tensor(case["x"][sl], dtype=torch.float32).requires_grad_(True)
    gid = torch.zeros(rows, dtype=torch.int64)
    mask = torch.ones(rows, dtype=torch.float32)
    y = seg.graph_pool(x, gid, 1, mask, "max", group=mesh.model_group)
    (g,) = torch.autograd.grad(y.sum() / mesh.shape["model"], x)
    return {"value": y.detach().numpy(), "grad": g.numpy()}


def _factories(trainer, dp, es, mesh, graphs, device="cpu"):
    """The four sharded factories over `mesh`, each with `graphs` (None: one
    of its own), for the data-parallel item `dp` and the partitioned item
    `es` ({"stacked", "meta"}): {name: (step, its stacked batch)}."""
    from ignnition_tpu_torch import parallel as par

    t, kw = trainer, dict(device=device, graphs=graphs)
    return {
        "parallel_train": (par.make_parallel_train_step(
            t.model, t.optimizer, t.loss_fn, dp["meta"], mesh, **kw), dp["stacked"]),
        "parallel_apply": (par.make_parallel_apply(t.model, dp["meta"], mesh, **kw),
                           dp["stacked"]),
        "edgeshard_train": (par.make_edgeshard_train_step(
            t.model, t.optimizer, t.loss_fn, es["meta"], mesh, **kw), es["stacked"]),
        "edgeshard_apply": (par.make_edgeshard_apply(t.model, es["meta"], mesh, **kw),
                            es["stacked"]),
    }


def case_capture_factories(case, mesh):
    """Each sharded factory built with the trainer's `Graphs` and with one of
    its own, for each of two batch shapes (the second called inside
    `capture.eager()`), once from the same state: what each step reports
    (captured, why_eager, how its call ran, whether its graphs are its
    own), its outputs, and the keys (kind, shape key) of the trainer's
    graphs and of each step's own."""
    import torch

    from ignnition_tpu_torch.training import capture

    out = {}
    for shared in (True, False):
        trainer, _ = _trainer(case)
        for i, (dp, es) in enumerate(zip(case["dp"], case["es"])):
            steps = _factories(trainer, dp, es, mesh, trainer.graphs if shared else None)
            for name, (step, stacked) in steps.items():
                state = trainer.init_state(params=case["params"])
                with capture.eager() if i else contextlib.nullcontext():
                    if name.endswith("train"):
                        gen = torch.Generator().manual_seed(1)
                        _, _, got = step(state.params, state.opt_state, stacked, generator=gen)
                        got = float(got)
                    else:
                        got = step(state.params, stacked).numpy()
                out[(name, shared, i)] = dict(
                    captured=step.captured, why_eager=step.why_eager, ran=step.last.last,
                    own=step.graphs is not trainer.graphs, output=got,
                    keys=[(k[0], k[2]) for k in step.graphs.captured],
                    params=_flat(state.params) if name.endswith("train") else None)
        if shared:
            out["trainer_keys"] = [(k[0], k[2], v.owner.graphs is trainer.graphs)
                                   for k, v in trainer.graphs.captured.items()]
    return out


def case_capture_decision(case, mesh):
    """The backend decision of `parallel.steps`: the CPU's reason, a gloo
    mesh's on the card (a `Graphs` of a CUDA device, which nothing here
    allocates on), none for a mesh whose groups report NCCL; a step over a
    gloo mesh with a card's `Graphs` runs its calls eagerly."""
    import torch
    import torch.distributed as dist

    from ignnition_tpu_torch.parallel import steps
    from ignnition_tpu_torch.training.capture import Graphs

    card = Graphs(torch.device("cuda", 0))
    out = {"cpu": steps._why_eager(mesh, Graphs("cpu")),
           "gloo_on_card": steps._why_eager(mesh, card)}
    real = dist.get_backend
    steps.dist.get_backend = lambda group=None: "nccl"
    try:
        out["nccl_on_card"] = steps._why_eager(mesh, card)
    finally:
        steps.dist.get_backend = real
    sharded = steps.ShardedStep(
        "a step", mesh, "cpu", card,
        lambda x: sharded.run(("k",), lambda gen, bound, inputs: {"y": inputs["x"] * bound},
                              x, {"x": x}))
    y = sharded(torch.arange(4.0))["y"]
    out["gloo_step"] = (sharded.captured, sharded.last.last, y.tolist())
    return out


def case_capture_trainer(case, mesh):
    """`Trainer.train(mesh=...)` for 2 steps, replicated and destination
    sharded: the keys of the trainer's graphs, each with whether its step
    shares the trainer's `Graphs` and how its latest call ran."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.training.trainer import Trainer

    out = {}
    for strategy in ("replicated", "dest_shard"):
        trainer = Trainer(_model(case), padding=igt.PaddingConfig(**case["padding"]),
                          device="cpu")
        state = trainer.init_state(params=case["params"])
        trainer.train(state, case["data"], max_steps=2, batch_size=2, shuffle=False,
                      log_every=0, mesh=mesh, model_strategy=strategy)
        out[strategy] = [(k[0], v.owner.graphs is trainer.graphs, v.last, v.owner.why_eager)
                         for k, v in trainer.graphs.captured.items()]
    return out


def case_replay_vs_eager(case, mesh):
    """On the card over NCCL: each sharded factory called `calls` times from
    one state eagerly (`capture.eager()`) and then through its graphs (a
    warm-up, a capture, replays): how each call ran, the losses or
    predictions and the parameters of both runs."""
    import torch

    from ignnition_tpu_torch.training import capture

    out = {}
    for name in ("parallel_train", "parallel_apply", "edgeshard_train", "edgeshard_apply"):
        for way in ("eager", "replayed"):
            trainer, state = _trainer(case, "cuda")
            step, stacked = _factories(trainer, case["dp"][0], case["es"][0], mesh,
                                       trainer.graphs, "cuda")[name]
            got, ran = [], []
            with capture.eager() if way == "eager" else contextlib.nullcontext():
                for _ in range(case["calls"]):
                    if name.endswith("train"):
                        _, _, loss = step(state.params, state.opt_state, stacked,
                                          generator=trainer.generator)
                        got.append(loss.cpu().numpy())
                    else:
                        got.append(step(state.params, stacked).cpu().numpy())
                    ran.append(step.last.last)
            torch.cuda.synchronize()
            out[(name, way)] = dict(ran=ran, outputs=got, captured=step.captured,
                                    params=_flat(state.params))
    return out


CASES = {
    "apply": case_apply, "step": case_step, "step_raises": case_step_raises,
    "single_step": case_single_step, "serial_step": case_serial_step,
    "train": case_train, "runner": case_runner,
    "distributed": case_distributed,
    "es_apply": case_es_apply, "es_step": case_es_step,
    "es_step_raises": case_es_step_raises, "es_train": case_es_train,
    "es_gather": case_es_gather, "es_pool_tie": case_es_pool_tie, "es_grads": case_es_grads,
    "capture_factories": case_capture_factories, "capture_decision": case_capture_decision,
    "capture_trainer": case_capture_trainer, "replay_vs_eager": case_replay_vs_eager,
}


@contextlib.contextmanager
def _builder_switches(setting: dict):
    """`model.builder`'s switches (`_HALO_OVERLAP`, ...) set as a case asks,
    for that case alone."""
    from ignnition_tpu_torch.model import builder

    saved = {k: getattr(builder, k) for k in setting}
    try:
        for k, v in setting.items():
            setattr(builder, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(builder, k, v)


def _worker(job_dir: str, port: str, rank: int, world: int) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(job_dir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    if job["init"] == "initialize":
        from ignnition_tpu_torch.parallel import distributed

        distributed.initialize(f"localhost:{port}", world, rank, device="cpu")
    elif job["init"] == "nccl":
        from ignnition_tpu_torch.parallel import distributed

        distributed.initialize(f"localhost:{port}", world, rank)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
    from ignnition_tpu_torch.parallel import make_mesh

    out, meshes = {}, {}
    for case in job["cases"]:
        shape = tuple(case.get("mesh", (1, 1)))
        if case["kind"] == "distributed":
            out[case["name"]] = case_distributed(case, None)
            continue
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        mesh = meshes[shape]
        if mesh.coords is not None:
            with _builder_switches(case.get("builder", {})):
                out[case["name"]] = CASES[case["kind"]](case, mesh)
        dist.barrier()
    loaded = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "ignnition_tpu."))
              or m == "ignnition_tpu"]
    if loaded:
        raise AssertionError(f"a worker imported {loaded[:5]}")
    with open(os.path.join(job_dir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


def _flagship_case(steps=2):
    """A 2-iteration, hs=8 flagship from the port's own init and a batch of
    two graphs padded to multiples of 64 (the port's arrays only)."""
    import copy

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import ignnition_tpu_torch as igt
    from helpers import routenet_description
    from ignnition_tpu_torch.data.synthetic import make_routenet_sample
    from ignnition_tpu_torch.model.builder import map_params
    from ignnition_tpu_torch.parallel import stack_batches

    desc = routenet_description(num_iterations=2, hs=8)
    dims = {"link_capacity": 1, "traffic": 1}
    ir = igt.parse_model_description(copy.deepcopy(desc), dict(dims))
    import torch

    params = map_params(lambda t: t.numpy(), igt.build(ir).init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(3)
    spec = igt.SampleSpec.from_ir(ir)
    samples = [igt.convert_sample(make_routenet_sample(rng, 14, 10, 4), spec) for _ in range(2)]
    batch = igt.build_batch(samples, ir, igt.PaddingConfig(mode="multiple", multiple=64,
                                                           min_size=64), training=True)
    stacked, meta = stack_batches([batch], ir)
    return dict(desc=desc, dims=dims, params=params, stacked=stacked, meta=meta, steps=steps)


def test_two_process_initialize_pod_mesh_and_host_shard_iter(tmp_path):
    """`distributed.initialize` joins two processes (gloo, device="cpu");
    `make_pod_mesh` keeps the model axis within the node (LOCAL_WORLD_SIZE
    2) or spreads the data axis; `host_shard_iter` deals by rank; a step
    over the 1x2 pod mesh gives both ranks one loss and one set of
    parameters, those of the single-device step on the same batch and
    weights; the meshes that do not fit raise."""
    case = dict(_flagship_case(), name="pod", kind="distributed")
    single = dict(_flagship_case(steps=1), name="single", kind="single_step")
    ranks = spawn_world(2, [case, single], str(tmp_path / "pod"), init="initialize")
    ref = ranks[0]["single"]
    for r, out in enumerate(ranks):
        got = out["pod"]
        assert got["world"] == 2 and got["backend"] == "gloo"
        assert got["dealt"] == list(range(r, 10, 2))
        assert "must divide the ranks of a node (2)" in got["too_wide"]
        assert "needs 4 ranks, have 2" in got["too_big"]
        assert got["model_axis_mesh"] == ({"data": 1, "model": 2}, (0, r))
        assert got["data_axis_mesh"] == ({"data": 2, "model": 1}, (r, 0))
    a, b = (out["pod"]["step"] for out in ranks)
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    np.testing.assert_allclose(a["losses"][0], ref["losses"][0], rtol=1e-5)


def test_make_mesh_needs_an_initialized_group():
    import pytest

    sys.path.insert(0, REPO)
    from ignnition_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        make_mesh(1, 2)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
