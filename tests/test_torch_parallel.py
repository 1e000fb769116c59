"""The port's data- and edge-parallel steps against the JAX package's, on
the CPU (the counterparts of `tests/test_parallel.py`).

One world of 4 gloo processes (`test_torch_distributed.spawn_world`) runs
every case of the module in one spawn: each case names its mesh shape
(4x1, 2x2, 1x2, 1x4, 2x1; the ranks outside a smaller mesh wait). The JAX
side runs in this process on conftest's 8 virtual CPU devices, at the same
mesh shape, on the same `build_batch` output (each package builds its own
from the same seeded samples) and the same weights (the JAX init, carried
to the port by `params_from_jax`). Limits are the JAX tests': the
data-parallel forward 1e-5, the edge-partitioned 1e-4; a step's loss
rtol 1e-5, its updated parameters rtol 5e-4 / atol 5e-6 (Adam turns a
few-ulp gradient difference into ~lr-scale moves of near-zero entries).
The 1x2 step is the case that catches a gradient scaled by the model axis.

A sharded step is held, as in the JAX test, to the serial mean of the
batches' losses and gradients computed by the same package (the port's
single-device gradients, in the world's first rank), and to the JAX step at
the same mesh: its loss at rtol 1e-5, its parameters by the rule of
`tests/test_torch_train.py` for two implementations (each element whose
first gradient is above 1e-3 of its leaf's largest at the limits above,
every element within 2 lr a step: Adam's 1e-7 epsilon turns the two
packages' different summation orders of near-zero gradients into steps of
either sign).
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import yaml

import ignnition_tpu_torch as igt
from ignnition_tpu.data import SampleSpec as JSampleSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data import synthetic as j_synthetic
from ignnition_tpu.data.graph import PaddingConfig as JPadding
from ignnition_tpu.frontend import parser as j_parser
from ignnition_tpu.model import build as j_build
from ignnition_tpu.parallel import make_mesh as j_make_mesh
from ignnition_tpu.parallel import make_parallel_apply as j_parallel_apply
from ignnition_tpu.parallel import make_parallel_train_step as j_parallel_step
from ignnition_tpu.parallel import stack_batches as j_stack
from ignnition_tpu.training import build_optimizer as j_build_optimizer
from ignnition_tpu.training import get_loss as j_get_loss
from ignnition_tpu_torch.data import synthetic as t_synthetic
from ignnition_tpu_torch.model.builder import flatten_params, map_params
from ignnition_tpu_torch.parallel import batch_partition_specs, stack_batches

from helpers import qsize_description, routenet_description
from test_torch_distributed import spawn_world

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

DIMS = {"link_capacity": 1, "traffic": 1}
QSIZE_DIMS = {"link_capacity": 1, "traffic": 1, "queue_sizes": 1}
LINKPRED_DIMS = {"x": 1}
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
DP_TOL = dict(rtol=1e-5, atol=1e-6)
EDGE_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=5e-6)


def _pad64(cls):
    return cls(mode="multiple", multiple=64, min_size=64)


def _routenet(seed_graphs, desc, dims=DIMS, with_nodes=False, graph=(14, 10, 4)):
    """The JAX and the port's batches of the same seeded samples:
    [(JAX (arrays, meta), port (arrays, meta))] a batch, each list of
    `seed_graphs` = (seed, graphs a batch, batches)."""
    seed, per_batch, n = seed_graphs
    out = []
    for parse, spec_cls, convert, make, build, pad in (
        (j_parser.parse_model_description, JSampleSpec, j_convert,
         j_synthetic.make_routenet_sample, j_build_batch, JPadding),
        (igt.parse_model_description, igt.SampleSpec, igt.convert_sample,
         t_synthetic.make_routenet_sample, igt.build_batch, igt.PaddingConfig),
    ):
        ir = parse(copy.deepcopy(desc), dict(dims))
        rng = np.random.default_rng(seed)
        spec = spec_cls.from_ir(ir)
        out.append([
            build([convert(make(rng, *graph, with_nodes=with_nodes), spec)
                   for _ in range(per_batch)], ir, _pad64(pad), training=True)
            for _ in range(n)
        ])
    return list(zip(*out))


def _linkpred_batches():
    with open(os.path.join(EXAMPLES, "linkpred", "model_description.yaml")) as f:
        desc = yaml.safe_load(f)
    out = []
    for parse, spec_cls, convert, synthetic, build, pad in (
        (j_parser.parse_model_description, JSampleSpec, j_convert, j_synthetic,
         j_build_batch, JPadding),
        (igt.parse_model_description, igt.SampleSpec, igt.convert_sample, t_synthetic,
         igt.build_batch, igt.PaddingConfig),
    ):
        ir = parse(copy.deepcopy(desc), dict(LINKPRED_DIMS))
        rng = np.random.default_rng(0)
        spec = spec_cls.from_ir(ir)
        samples = [convert(synthetic.make_linkpred_sample(rng, n_nodes=n), spec)
                   for n in (10, 14, 12)]
        out.append([build(samples, ir, _pad64(pad), training=True)])
    return desc, list(zip(*out))


def _attention(desc):
    desc["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"] = {"type": "attention"}
    return desc


def _sgd(desc):
    """Plain SGD, whose update is linear in the gradient: a gradient off by
    a factor (the model axis's, say) moves every parameter, where Adam's
    update is blind to its scale but for near-zero gradients."""
    desc["learning_options"]["optimizer"] = {"type": "SGD", "learning_rate": 0.05}
    return desc


def _hinge(desc):
    desc["learning_options"]["loss"] = "Hinge"
    return desc


def _relabel(pairs):
    """Binary labels in the first batch only: the all-binary test is false
    for the whole effective batch, true for the first data row alone."""
    for i, pair in enumerate(pairs):
        for arrays, _ in pair:
            lab = arrays["label"]
            arrays["label"] = ((lab > np.median(lab)).astype(lab.dtype) if i == 0
                               else lab.astype(lab.dtype))
    return pairs


class Case:
    """One case's inputs for both packages: description, dims, JAX batches
    and params, and the port's stacked batch."""

    def __init__(self, name, kind, mesh, desc, dims, pairs, steps=1):
        self.name, self.kind, self.mesh, self.steps = name, kind, mesh, steps
        self.desc, self.dims = desc, dims
        self.j_ir = j_parser.parse_model_description(copy.deepcopy(desc), dict(dims))
        self.t_ir = igt.parse_model_description(copy.deepcopy(desc), dict(dims))
        self.j_batches = [p[0] for p in pairs]
        self.t_batches = [p[1] for p in pairs]
        self.j_model = j_build(self.j_ir)
        self.j_params = self.j_model.init(jax.random.PRNGKey(0))
        self.t_stacked, self.meta = stack_batches(self.t_batches, self.t_ir)

    def job(self, kind=None, suffix="", mesh=None) -> dict:
        return dict(
            name=self.name + suffix, kind=kind or self.kind, mesh=mesh or self.mesh,
            steps=self.steps,
            desc=copy.deepcopy(self.desc), dims=dict(self.dims), meta=self.meta,
            stacked=self.t_stacked,
            params=map_params(lambda t: t.numpy(), igt.params_from_jax(self.j_params)),
        )

    # the JAX side at the same mesh shape
    def j_stacked(self):
        return j_stack(self.j_batches, self.j_ir)

    def j_apply(self):
        stacked, meta = self.j_stacked()
        assert repr(meta) == repr(self.meta)
        fn = j_parallel_apply(self.j_model, meta, j_make_mesh(*self.mesh))
        return np.asarray(fn(self.j_params, stacked))

    def j_single_apply(self):
        """The JAX single-device forward of each batch, stacked: where the
        JAX sharded forward cannot run (below)."""
        return np.stack([np.asarray(self.j_model.apply(self.j_params, a, m))
                         for a, m in self.j_batches])

    def j_step(self):
        stacked, meta = self.j_stacked()
        opt = j_build_optimizer(self.j_ir.learning.optimizer)
        loss_fn = j_get_loss(self.j_ir.learning.loss)
        step = j_parallel_step(self.j_model, opt, loss_fn, meta, j_make_mesh(*self.mesh))
        params, opt_state = self.j_params, opt.init(self.j_params)
        losses = []
        for _ in range(self.steps):
            params, opt_state, loss = step(params, opt_state, stacked)
            losses.append(float(loss))
        return losses, _flat(params)

    def firm(self, loss_fn=None):
        """Each leaf's elements whose gradient of the mean loss at the
        initial weights is above 1e-3 of the leaf's largest (JAX)."""
        model = self.j_model
        loss_fn = loss_fn or j_get_loss(self.j_ir.learning.loss)

        def serial_loss(p):
            total = 0.0
            for arrays, m in self.j_batches:
                preds = model.apply(p, arrays, m, training=True)
                total += loss_fn(arrays["label"], preds, arrays["label_mask"])
            return total / len(self.j_batches) + model.regularization_loss(p)

        grads = _flat(jax.grad(serial_loss)(self.j_params))
        return {k: np.abs(g) >= 1e-3 * np.abs(g).max() for k, g in grads.items()}

    def lr(self) -> float:
        spec = self.t_ir.learning.optimizer
        if spec.schedule is not None:
            return float(dict(spec.schedule.params)["initial_learning_rate"])
        return float(dict(spec.params)["learning_rate"])


def _flat(j_params):
    return {k: v.numpy() for k, v in flatten_params(igt.params_from_jax(j_params)).items()}


def _cases():
    flag = routenet_description(num_iterations=2, hs=8)
    four = _routenet((5, 2, 4), flag)
    lp_desc, lp = _linkpred_batches()
    cases = [
        Case("dp_apply_4x1", "apply", (4, 1), flag, DIMS, four),
        Case("edge_apply_2x2", "apply", (2, 2), flag, DIMS, four[:2]),
        Case("step_2x2", "step", (2, 2), flag, DIMS, four[:2]),
        Case("step_1x2", "step", (1, 2), flag, DIMS, four[:1]),
        Case("step_1x2_sgd", "step", (1, 2), _sgd(copy.deepcopy(flag)), DIMS, four[:1]),
        Case("attention_edge_apply_1x4", "apply", (1, 4), _attention(copy.deepcopy(flag)),
             DIMS, _routenet((6, 1, 1), _attention(copy.deepcopy(flag)))),
        Case("qsize_dp_apply_4x1", "apply", (4, 1), qsize_description(num_iterations=2, hs=8),
             QSIZE_DIMS, _routenet((11, 2, 4), qsize_description(num_iterations=2, hs=8),
                                   QSIZE_DIMS, with_nodes=True, graph=(10, 8, 3))),
        Case("mixed_blocks_dp_apply_2x1", "apply", (2, 1), flag, DIMS, _routenet_mixed(flag)),
        Case("linkpred_apply_1x2", "apply", (1, 2), lp_desc, LINKPRED_DIMS, lp),
        Case("linkpred_step_1x2", "step", (1, 2), lp_desc, LINKPRED_DIMS, lp, steps=2),
        Case("hinge_step_2x1", "step", (2, 1), _hinge(copy.deepcopy(flag)), DIMS,
             _relabel(_routenet((5, 2, 2), flag))),
    ]
    return cases


def _routenet_mixed(desc):
    """Two batches of two graphs: one of equal sizes (block-diagonal
    incidence), one not (the JAX test's `test_dp_stacking_mixed_block_batches`)."""
    out = []
    for parse, spec_cls, convert, make, build, pad in (
        (j_parser.parse_model_description, JSampleSpec, j_convert,
         j_synthetic.make_routenet_sample, j_build_batch, JPadding),
        (igt.parse_model_description, igt.SampleSpec, igt.convert_sample,
         t_synthetic.make_routenet_sample, igt.build_batch, igt.PaddingConfig),
    ):
        ir = parse(copy.deepcopy(desc), dict(DIMS))
        rng = np.random.default_rng(7)
        spec = spec_cls.from_ir(ir)
        uni = [convert(make(rng, 14, 10, 4), spec) for _ in range(2)]
        mix = [convert(make(rng, 14, 10, 4), spec), convert(make(rng, 12, 10, 4), spec)]
        out.append([build(uni, ir, _pad64(pad), training=True),
                    build(mix, ir, _pad64(pad), training=True)])
    return list(zip(*out))


def _loop_cases(tmp):
    """Trainer.train over a 2x2 mesh and Runner(mesh=...) over 1x2, on a
    dataset written here; a step whose padded edges do not divide into the
    model axis; ranks whose batches differ in shape."""
    data = os.path.join(tmp, "ds")
    t_synthetic.write_dataset(data, 2, 8, seed=4, n_links=12, n_paths=8, max_path_len=4)
    desc = routenet_description(num_iterations=2, hs=8)
    desc_path = os.path.join(tmp, "model.json")
    with open(desc_path, "w") as f:
        json.dump(desc, f)
    pad = dict(mode="multiple", multiple=64, min_size=64)
    config = dict(train_dataset=data, eval_dataset=data, json_path=desc_path,
                  model_dir=os.path.join(tmp, "runs"), batch_size=2, train_steps=12,
                  eval_samples=2, eval_batch_size=2, accumulate_steps=1, log_every=0,
                  shuffle_train_samples=False)
    # two graphs, edges padded to a multiple of 7 (42) that 4 does not divide
    t_ir = igt.parse_model_description(copy.deepcopy(desc), dict(DIMS))
    rng = np.random.default_rng(2)
    spec = igt.SampleSpec.from_ir(t_ir)
    odd = igt.build_batch([igt.convert_sample(t_synthetic.make_routenet_sample(rng, 9, 7, 3),
                                              spec) for _ in range(2)], t_ir,
                          igt.PaddingConfig(mode="multiple", multiple=7, min_size=7),
                          training=True)
    odd_stacked, odd_meta = stack_batches([odd], t_ir)
    assert any(odd_meta.edges(a.name) % 4 for a in t_ir.adjacency_info())
    small = igt.build_batch([igt.convert_sample(t_synthetic.make_routenet_sample(rng, 9, 7, 3),
                                                spec)], t_ir, igt.PaddingConfig(), training=True)
    params = map_params(lambda t: t.numpy(), igt.build(t_ir).init(
        __import__("torch").Generator().manual_seed(0)))
    common = dict(desc=desc, dims=DIMS, params=params)
    return [
        dict(common, name="trainer_2x2", kind="train", mesh=(2, 2), data=data, steps=25,
             padding=pad, checkpoint_dir=os.path.join(tmp, "ckpt")),
        dict(common, name="runner_1x2", kind="runner", mesh=(1, 2), config=config, padding=pad),
        dict(common, name="edges_not_divisible_1x4", kind="step_raises", mesh=(1, 4),
             stacked=odd_stacked, meta=odd_meta),
        dict(common, name="differing_metas_2x1", kind="step_raises", mesh=(2, 1),
             meta=odd_meta, stacked_by_rank={(0, 0): odd_stacked,
                                             (1, 0): stack_batches([small], t_ir)[0]}),
    ]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(cases by name, each rank's results) of the one world of 4."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    cases = {c.name: c for c in _cases()}
    loops = _loop_cases(tmp)
    # the port's serial mean of every step case, in the first rank alone
    serial = [c.job("serial_step", "_serial", (1, 1)) for c in cases.values()
              if c.kind == "step" and c.name != "hinge_step_2x1"]
    # a 1x1 mesh (ranks 1-3 outside it) and the single-device trainer step
    serial += [cases["step_1x2"].job("step", "_1x1", (1, 1)),
               cases["step_1x2"].job("single_step", "_single", (1, 1))]
    # the steps built with the trainer's `Graphs`, as its mesh loop builds them
    shared = [dict(cases[n].job(suffix="_shared_graphs"), shared_graphs=True)
              for n in ("step_2x2", "step_1x2")]
    ranks = spawn_world(4, [c.job() for c in cases.values()] + serial + loops + shared,
                        os.path.join(tmp, "world"))
    return cases, ranks, tmp


def _on_every_rank(ranks, name, size):
    """The result of `name` on the mesh's ranks, held equal across them."""
    got = [r[name] for r in ranks[:size]]
    assert all(name not in r for r in ranks[size:])
    first = got[0]
    for other in got[1:]:
        if isinstance(first, np.ndarray):
            np.testing.assert_array_equal(other, first)
        else:
            assert other["losses"] == first["losses"]
    return first


@pytest.mark.parametrize("name", ["dp_apply_4x1", "qsize_dp_apply_4x1",
                                  "mixed_blocks_dp_apply_2x1"])
def test_data_parallel_apply_matches_jax(world, name):
    """4x1 and 2x1 (mixed block-diagonal and dense batches, whose stacking
    drops the blocks for everyone; Q-size's interleave companions survive
    the stacking): the stacked predictions against the JAX function's."""
    cases, ranks, _ = world
    case = cases[name]
    got = _on_every_rank(ranks, name, case.mesh[0] * case.mesh[1])
    if name == "mixed_blocks_dp_apply_2x1":
        assert "inc_blocks_adj_paths_links" in case.t_batches[0][0]
        assert "inc_blocks_adj_paths_links" not in case.t_stacked
    if name == "qsize_dp_apply_4x1":
        assert "ilv_slice_path_s0m0" in case.t_stacked
    want = case.j_apply()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **DP_TOL)


@pytest.mark.parametrize("name", ["edge_apply_2x2", "attention_edge_apply_1x4",
                                  "linkpred_apply_1x2"])
def test_edge_partitioned_apply_matches_jax(world, name):
    """Edges split over the model axis (2x2; the attention model at 1x4;
    linkpred's edge-domain predictions gathered back from the blocks at
    1x2) against the JAX function at the same mesh. For linkpred the JAX
    sharded forward raises under this JAX (its shard_map cannot infer that
    the gathered predictions are replicated over 'model'), so the reference
    is the JAX single-device forward, which that gather reproduces."""
    cases, ranks, _ = world
    case = cases[name]
    got = _on_every_rank(ranks, name, case.mesh[0] * case.mesh[1])
    want = case.j_single_apply() if name == "linkpred_apply_1x2" else case.j_apply()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **EDGE_TOL)


def _hold_step(got, case, want_losses, want_params, firm=None):
    """A sharded step's losses and parameters against a reference: the
    elementwise limits everywhere (`firm` None: the same package), else on
    the firm elements and 2 lr a step on every element."""
    np.testing.assert_allclose(got["losses"], np.atleast_1d(want_losses), rtol=1e-5)
    for k, v in want_params.items():
        g = got["params"][k]
        if firm is None:
            np.testing.assert_allclose(g, v, err_msg=k, **PARAM_TOL)
        else:
            np.testing.assert_allclose(g[firm[k]], v[firm[k]], err_msg=k, **PARAM_TOL)
            assert np.abs(g - v).max() <= 2 * case.lr() * case.steps, k


@pytest.mark.parametrize("name", ["step_2x2", "step_1x2", "step_1x2_sgd"])
def test_train_step_matches_the_serial_mean_and_jax(world, name):
    """One step at 2x2 and at 1x2 (under the description's Adam and under
    SGD) against the serial mean of the batches' losses and gradients (the
    port's, at the JAX test's limits) and against the JAX step at the same
    mesh."""
    cases, ranks, _ = world
    case = cases[name]
    got = _on_every_rank(ranks, name, case.mesh[0] * case.mesh[1])
    serial = ranks[0][name + "_serial"]
    _hold_step(got, case, serial["losses"], serial["params"])
    _hold_step(got, case, *case.j_step(), firm=case.firm())


@pytest.mark.parametrize("name", ["step_2x2", "step_1x2"])
def test_step_with_the_trainers_graphs_matches_jax(world, name):
    """The step built with the trainer's `Graphs` (the trainer's mesh loop
    hands them over; eager on gloo and says so) against the serial mean and
    the JAX step at the same mesh, as the step of its own graphs is."""
    cases, ranks, _ = world
    case = cases[name]
    got = _on_every_rank(ranks, name + "_shared_graphs", case.mesh[0] * case.mesh[1])
    assert got["graphs_are_the_trainers"] and got["ran"] == "eager"
    assert "runs on cpu" in got["why_eager"]
    serial = ranks[0][name + "_serial"]
    _hold_step(got, case, serial["losses"], serial["params"])
    _hold_step(got, case, *case.j_step(), firm=case.firm())


def test_one_by_one_mesh_step_matches_the_single_device_step(world):
    """A step over a 1x1 mesh of the world of 4, the other ranks outside it
    and waiting, against the single-device trainer step on the same batch
    and weights, at the JAX test's limits."""
    cases, ranks, _ = world
    got = _on_every_rank(ranks, "step_1x2_1x1", 1)
    single = ranks[0]["step_1x2_single"]
    _hold_step(got, cases["step_1x2"], single["losses"], single["params"])


def test_edge_domain_step_combines_the_loss_over_the_model_axis(world):
    """linkpred (labels on the edges, split with them): two steps at 1x2,
    each loss the mask-weighted mean over both blocks, against the serial
    steps and the JAX step."""
    cases, ranks, _ = world
    case = cases["linkpred_step_1x2"]
    assert batch_partition_specs(case.t_ir, case.t_stacked)["label"] == ("data", "model")
    got = _on_every_rank(ranks, case.name, 2)
    serial = ranks[0][case.name + "_serial"]
    _hold_step(got, case, serial["losses"], serial["params"])
    _hold_step(got, case, *case.j_step(), firm=case.firm())


def _hinge_unconverted(labels, preds, mask):
    """Hinge with the labels as they are: what the effective batch's false
    all-binary test gives every row."""
    import jax.numpy as jnp

    err = jnp.maximum(1.0 - labels * preds, 0.0)
    return jnp.sum(err * mask) / jnp.maximum(jnp.sum(mask), 1.0)


def test_hinge_label_test_spans_the_data_axis(world):
    """Hinge over 2x1, labels binary in one data row only: the all-binary
    test is false for the effective batch, so no row's labels are mapped to
    +-1; the loss and update are the JAX step's. A test per row would give
    another loss (held here, so the case tells the two apart)."""
    cases, ranks, _ = world
    case = cases["hinge_step_2x1"]
    got = _on_every_rank(ranks, case.name, 2)
    _hold_step(got, case, *case.j_step(), firm=case.firm(_hinge_unconverted))
    loss_fn = j_get_loss("Hinge")
    per_row = [float(loss_fn(a["label"], case.j_model.apply(case.j_params, a, m, training=True),
                             a["label_mask"])) for a, m in case.j_batches]
    assert abs(np.mean(per_row) - got["losses"][0]) > 1e-3


def test_trainer_over_a_mesh_lowers_the_loss(world):
    """`Trainer.train(mesh=...)` at 2x2, 25 steps: the evaluation loss falls;
    every rank ends with the same parameters; only the first rank wrote the
    checkpoint."""
    _, ranks, tmp = world
    got = [r["trainer_2x2"] for r in ranks]
    assert all(g["step"] == 25 for g in got)
    assert got[0]["after"] < got[0]["before"]
    for g in got[1:]:
        for k, v in got[0]["params"].items():
            np.testing.assert_array_equal(g["params"][k], v)
    assert os.listdir(os.path.join(tmp, "ckpt")) == ["25"]


def test_runner_over_a_mesh_trains(world):
    """`Runner(model, mesh=...)` at 1x2: train_and_evaluate from a RunConfig
    lowers the evaluation loss, one run directory for the mesh."""
    _, ranks, tmp = world
    a, b = ranks[0]["runner_1x2"], ranks[1]["runner_1x2"]
    assert a["step"] == b["step"] == 12
    assert a["after"] < a["before"]
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v)
    (run,) = os.listdir(os.path.join(tmp, "runs"))
    assert os.listdir(os.path.join(tmp, "runs", run)) == ["12"]


def test_sharded_step_refuses_what_would_hang_or_misplace(world):
    """Padded edges that do not divide into the model axis raise (as JAX's
    sharding does); ranks that step with batches of different shapes raise
    on every rank rather than issue differing collectives."""
    _, ranks, _ = world
    for r in range(4):
        assert "do not divide into 4 blocks" in ranks[r]["edges_not_divisible_1x4"]
    for r in range(2):
        assert "different padded shapes" in ranks[r]["differing_metas_2x1"]
