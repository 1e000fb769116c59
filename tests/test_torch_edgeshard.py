"""The port's destination sharding (v2: `parallel/edgeshard.py`, the halo
exchange of `ops/segment.py`, `GnnModel.apply(node_axis=)`) against the JAX
package on the CPU: the counterparts of `tests/test_edgeshard.py` and
`tests/test_halo_overlap.py`.

One world of 4 gloo processes (`test_torch_distributed.spawn_world`) runs
every case of the module in one spawn, each on its mesh (1x2, 1x4, 2x2; the
ranks outside a smaller mesh wait). The batches are the port's
`build_batch` output of the JAX tests' seeded graphs, partitioned by the
port's `partition_batch` (held equal to the JAX package's in
`tests/test_torch_locality.py`); the weights are the JAX init, carried over
by `params_from_jax`. The JAX side runs in this process.

Limits are the JAX tests': the forward rtol 1e-5 / atol 1e-6 (the vector
aggregations 1e-4 / 1e-5); a step's parameters rtol 5e-4 / atol 5e-5
against the port's single-device step on the merged batch (the serial
gradients), its loss rtol 1e-4 against the JAX serial loss, and its
parameters against the JAX serial update by `tests/test_torch_train.py`'s
rule for two implementations (the elements whose first gradient is above
1e-3 of the leaf's largest at those limits, every element within 2 lr); the
overlapped gather against `halo_extend(table)[src]` at rtol 1e-6; the
cross-rank max tie's gradient at rtol 1e-6. The step cases run on one
graph whose partition has a non-empty halo (held here): that is what
catches a gradient off by the model axis.
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ignnition_tpu_torch as igt
from ignnition_tpu.data import SampleSpec as JSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data.graph import PaddingConfig as JPadding
from ignnition_tpu.data.synthetic import make_routenet_sample
from ignnition_tpu.frontend import parser as j_parser
from ignnition_tpu.model import build as j_build
from ignnition_tpu.ops import segment as j_seg
from ignnition_tpu.training import get_loss as j_get_loss
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data import synthetic as t_synthetic
from ignnition_tpu_torch.data.graph import merge_metas, repad_to_meta
from ignnition_tpu_torch.model.builder import flatten_params, map_params
from ignnition_tpu_torch.parallel import partition_batch, partition_dims

from helpers import qsize_description, routenet_description
from test_torch_distributed import spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = {"link_capacity": 1, "traffic": 1, "queue_sizes": 1}
PAD = dict(mode="multiple", multiple=32, min_size=32)
ONE_GRAPH_PAD = dict(mode="multiple", multiple=8, min_size=8)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
AGG_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=5e-4, atol=5e-5)


def _attention(kind):
    def edit(desc):
        desc["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"] = kind
        return desc
    return edit


def _readout(*ops):
    def edit(desc):
        desc["readout"] = list(ops)
        return desc
    return edit


EDGE_READOUT = _readout(
    {"type": "extend_adjacencies", "adj_list": "adj_links_paths", "input": ["link", "path"],
     "output_name_src": "esrc", "output_name_dst": "edst"},
    {"type": "product", "type_product": "element_wise", "input": ["esrc", "edst"],
     "output_name": "pair"},
    {"type": "predict", "input": ["pair"], "label": "edge_label", "nn_name": "readout_model"})


def _kl(desc):
    desc["learning_options"]["loss"] = "KLDivergence"
    del desc["readout"][0]["label_normalization"]
    return desc


def _edge_labels(rng, raw):
    n = sum(len(v) for v in raw["adj_links_paths"].values())
    raw["edge_label"] = rng.uniform(0.1, 1.0, n).round(3).tolist()
    return raw


def _path_weights(rng, raw):
    n = sum(1 for t in raw["entities"].values() if t == "path")
    raw["path_weights"] = rng.uniform(0.5, 2.0, n).round(3).tolist()
    return raw


def _raws(seed, n, size=(14, 10, 4), extra=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        raw = make_routenet_sample(rng, *size)
        out.append(extra(rng, raw) if extra else raw)
    return out


QSIZE_RAW = {
    "entities": {**{f"l{i}": "link" for i in range(4)}, **{f"p{i}": "path" for i in range(3)},
                 **{f"n{i}": "node" for i in range(2)}},
    "link_capacity": [1.0, 2.0, 3.0, 4.0], "traffic": [0.5, 1.5, 1.0],
    "queue_sizes": [3.0, 7.0], "delay": [0.2, 0.4, 0.3],
    "adj_links_paths": {"p0": ["l0", "l1"], "p1": ["l1", "l2"], "p2": ["l3"]},
    "adj_nodes_paths": {"p0": ["n0"], "p1": ["n1"], "p2": ["n0"]},
    "adj_paths_links": {"l0": ["p0"], "l1": ["p0", "p1"], "l2": ["p1"], "l3": ["p2"]},
    "adj_paths_nodes": {"n0": ["p0", "p2"], "n1": ["p1"]},
    "path_interleave": ["link", "node"],
}


class Case:
    """One case: its description and weights (the JAX init of `key`), the
    JAX and the port's batches of the same raw graphs (one merged batch a
    data row), and the port's partitioned, stacked batch."""

    def __init__(self, name, kind, mesh, desc, rows, key=0, pad=PAD, steps=1,
                 reorder=False):
        self.name, self.kind, self.mesh, self.steps = name, kind, mesh, steps
        self.desc, self.dims = desc, dict(DIMS)
        self.j_ir = j_parser.parse_model_description(copy.deepcopy(desc), dict(DIMS))
        self.t_ir = igt.parse_model_description(copy.deepcopy(desc), dict(DIMS))
        self.j_model = j_build(self.j_ir)
        self.j_params = self.j_model.init(jax.random.PRNGKey(key))
        j_spec, t_spec = JSpec.from_ir(self.j_ir), igt.SampleSpec.from_ir(self.t_ir)
        self.j_batches, self.t_batches = [], []
        for raws in rows:
            t_samples = [igt.convert_sample(copy.deepcopy(r), t_spec) for r in raws]
            j_samples = [j_convert(copy.deepcopy(r), j_spec) for r in raws]
            if reorder:
                from ignnition_tpu.parallel.locality import reorder_sample as j_reorder
                from ignnition_tpu_torch.parallel.locality import reorder_sample

                j_samples = [j_reorder(s, self.j_ir, n_model=mesh[1])[0] for s in j_samples]
                t_samples = [reorder_sample(s, self.t_ir, n_model=mesh[1])[0]
                             for s in t_samples]
            self.j_batches.append(j_build_batch(j_samples, self.j_ir, JPadding(**pad),
                                                training=True))
            self.t_batches.append(igt.build_batch(t_samples, self.t_ir,
                                                  igt.PaddingConfig(**pad), training=True))
        if len(self.t_batches) > 1:
            # the data rows as the trainer streams them: one common meta
            target = merge_metas([m for _, m in self.t_batches], self.t_ir)
            self.t_batches = [(repad_to_meta(a, m, target, self.t_ir), target)
                              for a, m in self.t_batches]
        parts = [partition_batch(a, m, self.t_ir, mesh[1]) for a, m in self.t_batches]
        dims = [partition_dims(p[0]) for p in parts]
        if any(d != dims[0] for d in dims):
            grown = {g: {a: max(d[g].get(a, 0) for d in dims)
                         for a in set().union(*(d[g] for d in dims))} for g in dims[0]}
            parts = [partition_batch(a, m, self.t_ir, mesh[1], pad_to=grown)
                     for a, m in self.t_batches]
        self.meta = parts[0][1]
        self.stacked = {k: np.stack([p[0][k] for p in parts]) for k in parts[0][0]}

    def halo_rows(self) -> int:
        return sum(v.shape[-1] for k, v in self.stacked.items() if k.startswith("halo_send_"))

    def job(self, **extra) -> dict:
        return dict(name=self.name, kind=self.kind, mesh=self.mesh, steps=self.steps,
                    desc=copy.deepcopy(self.desc), dims=dict(self.dims), meta=self.meta,
                    stacked=self.stacked,
                    params=map_params(lambda t: t.numpy(), igt.params_from_jax(self.j_params)),
                    **extra)

    # references
    def j_forward(self, i=0):
        arrays, meta = self.j_batches[i]
        return np.asarray(self.j_model.apply(self.j_params, arrays, meta))

    def _j_serial_loss(self, p, with_reg=True):
        loss_fn = j_get_loss(self.j_ir.learning.loss)
        total = 0.0
        for arrays, meta in self.j_batches:
            preds = self.j_model.apply(p, arrays, meta, training=True)
            total += loss_fn(arrays["label"], preds, arrays["label_mask"])
        total = total / len(self.j_batches)
        return total + self.j_model.regularization_loss(p) if with_reg else total

    def j_loss(self) -> float:
        return float(self._j_serial_loss(self.j_params, with_reg=False))

    def firm(self):
        grads = jax.grad(self._j_serial_loss)(self.j_params)
        flat = {k: v.numpy() for k, v in flatten_params(igt.params_from_jax(grads)).items()}
        return {k: np.abs(g) >= 1e-3 * np.abs(g).max() for k, g in flat.items()}

    def t_serial(self):
        """The port's single-device steps: each step the mean of the data
        rows' gradients, one update; the mean of their losses."""
        import torch

        from ignnition_tpu_torch.model.builder import with_leaves

        trainer = igt.Trainer(igt.build(self.t_ir), device="cpu")
        state = trainer.init_state(params=igt.params_from_jax(self.j_params))
        grads_fn = trainer.grads_fn(self.t_batches[0][1])
        assert all(repr(m) == repr(self.t_batches[0][1]) for _, m in self.t_batches)
        losses = []
        for _ in range(self.steps):
            total, loss = None, 0.0
            for arrays, _ in self.t_batches:
                g, m = grads_fn(state.params, to_device(arrays, "cpu"))
                g = list(flatten_params(g).values())
                total = g if total is None else [a + b for a, b in zip(total, g)]
                loss += float(m["loss"])
            mean = [t / len(self.t_batches) for t in total]
            with torch.no_grad():
                trainer.optimizer.step(state.params, with_leaves(state.params, mean),
                                       state.opt_state)
            losses.append(loss / len(self.t_batches))
        return losses, {k: v.detach().numpy() for k, v in flatten_params(state.params).items()}

    def lr(self) -> float:
        spec = self.t_ir.learning.optimizer
        if spec.schedule is not None:
            return float(dict(spec.schedule.params)["initial_learning_rate"])
        return float(dict(spec.params)["learning_rate"])


def _flagship640(m):
    """`__graft_entry__._edgeshard_scaling_diagnostic`'s case: the flagship at
    full width (hs 32, 8 iterations) on one graph of 192 links and 128
    paths of length 8 (640 edges a direction), renumbered for m shards."""
    sys.path.insert(0, REPO)
    import chip_smoke

    rng = np.random.default_rng(3)
    raw = make_routenet_sample(rng, 192, 128, 8)
    desc = chip_smoke.flagship_description(8, 32)
    return Case(f"flagship640_1x{m}", "es_step", (1, m), desc, [[raw]],
                pad=dict(mode="multiple", multiple=64, min_size=64), reorder=True)


def _cases():
    flag = routenet_description(num_iterations=2, hs=8)
    one_graph = [_raws(7, 1, (40, 30, 5))]
    c = [
        Case("fwd_1x2", "es_apply", (1, 2), flag, [_raws(5, 2)]),
        Case("fwd_1x4", "es_apply", (1, 4), flag, [_raws(5, 2)]),
        Case("step_1x4", "es_step", (1, 4), flag, [_raws(5, 2)]),
        Case("step_1x2_one_graph", "es_step", (1, 2), flag, one_graph, pad=ONE_GRAPH_PAD,
             steps=2),
        Case("step_2x2", "es_step", (2, 2), flag, [_raws(7, 1, (40, 30, 5)),
                                                   _raws(8, 1, (36, 28, 5))],
             pad=ONE_GRAPH_PAD),
        Case("qsize_fwd_1x2", "es_apply", (1, 2), qsize_description(num_iterations=2, hs=8),
             [[QSIZE_RAW]], key=1),
        Case("attention_fwd_1x4", "es_apply", (1, 4), _attention({"type": "attention"})(
            copy.deepcopy(flag)), [_raws(9, 2, (12, 8, 4))], key=2),
        Case("reference_fwd_1x4", "es_apply", (1, 4), _attention(
            {"type": "attention", "attention_softmax": "reference"})(copy.deepcopy(flag)),
            [_raws(9, 2, (12, 8, 4))], key=2),
        Case("convolution_fwd_1x4", "es_apply", (1, 4), _attention({"type": "convolution"})(
            copy.deepcopy(flag)), [_raws(9, 2, (12, 8, 4))], key=2),
        Case("reference_step_1x2", "es_step", (1, 2), _attention(
            {"type": "attention", "attention_softmax": "reference"})(copy.deepcopy(flag)),
            one_graph, pad=ONE_GRAPH_PAD),
        Case("pooling_fwd_1x4", "es_apply", (1, 4), _readout(
            {"type": "pooling", "type_pooling": "mean", "input": ["path"],
             "output_name": "g_emb"},
            {"type": "product", "type_product": "element_wise", "input": ["path", "g_emb"],
             "output_name": "scaled"},
            {"type": "predict", "input": ["scaled"], "label": "delay",
             "nn_name": "readout_model"})(copy.deepcopy(flag)), [_raws(5, 2)]),
        Case("edge_fwd_1x2", "es_apply", (1, 2), EDGE_READOUT(copy.deepcopy(flag)),
             [_raws(13, 2, extra=_edge_labels)], key=3),
        Case("edge_fwd_1x4", "es_apply", (1, 4), EDGE_READOUT(copy.deepcopy(flag)),
             [_raws(13, 2, extra=_edge_labels)], key=3),
        Case("edge_step_1x4", "es_step", (1, 4), EDGE_READOUT(copy.deepcopy(flag)),
             [_raws(13, 2, extra=_edge_labels)], key=3),
        Case("extra_fwd_1x2", "es_apply", (1, 2), _readout(
            {"type": "product", "type_product": "element_wise",
             "input": ["path", "path_weights"], "output_name": "weighted"},
            {"type": "predict", "input": ["weighted"], "label": "delay",
             "nn_name": "readout_model"})(copy.deepcopy(flag)),
            [_raws(21, 2, extra=_path_weights)], key=4),
        Case("kl_step_1x2", "es_step", (1, 2), _kl(copy.deepcopy(flag)), one_graph,
             pad=ONE_GRAPH_PAD),
        _flagship640(2),
        _flagship640(4),
    ]
    return {x.name: x for x in c}


def _gather_jobs(cases):
    """The overlapped gather against the synchronous one, on the local
    batches of the one-graph case partitioned at 1x2 and at 1x4."""
    jobs = []
    case = cases["step_1x2_one_graph"]
    arrays, meta = case.t_batches[0]
    for m in (2, 4):
        stacked, local_meta = partition_batch(arrays, meta, case.t_ir, m)
        stacked = {k: v[None] for k, v in stacked.items()}
        tables = {a.name: local_meta.nodes(a.src) for a in case.t_ir.adjacency_info()}
        assert all(f"halo_send_{a}" in stacked for a in tables)
        jobs.append(dict(name=f"gather_1x{m}", kind="es_gather", mesh=(1, m), stacked=stacked,
                         tables=tables, width=6))
    return jobs


def _train_jobs(tmp, params):
    """`Trainer.train` under dest_shard: 2x2 on `tests/test_edgeshard.py`'s
    dataset (locality "auto"), 1x2 with the renumbering on and off (one
    graph a batch of two), and 1x2 over an edge-label dataset with the
    batch cache."""
    data = os.path.join(tmp, "ds")
    t_synthetic.write_dataset(data, 2, 6, seed=3)
    small = os.path.join(tmp, "ds_small")
    t_synthetic.write_dataset(small, 1, 4, seed=9, n_links=24, n_paths=20)
    edge = os.path.join(tmp, "ds_edge")
    os.makedirs(edge)
    import tarfile
    from io import BytesIO

    payload = json.dumps(_raws(17, 4, extra=_edge_labels)).encode()
    with tarfile.open(os.path.join(edge, "s.tar.gz"), "w:gz") as tar:
        info = tarfile.TarInfo("data.json")
        info.size = len(payload)
        tar.addfile(info, BytesIO(payload))
    flag = routenet_description(num_iterations=2, hs=8)
    common = dict(desc=flag, dims=dict(DIMS), params=params, padding=ONE_GRAPH_PAD)
    return [
        dict(common, name="train_2x2", kind="es_train", mesh=(2, 2), data=data, steps=6,
             batch_size=1),
        dict(common, name="train_reorder_on_1x2", kind="es_train", mesh=(1, 2), data=small,
             steps=3, batch_size=2, locality_reorder=True),
        dict(common, name="train_reorder_off_1x2", kind="es_train", mesh=(1, 2), data=small,
             steps=3, batch_size=2, locality_reorder=False),
        dict(common, name="train_edge_1x2", kind="es_train", mesh=(1, 2), data=edge, steps=4,
             batch_size=1, cache=True, desc=EDGE_READOUT(copy.deepcopy(flag)),
             params=map_params(lambda t: t.numpy(), igt.build(igt.parse_model_description(
                 EDGE_READOUT(copy.deepcopy(flag)), dict(DIMS))).init(
                 __import__("torch").Generator().manual_seed(0)))),
    ]


TIE_X = [[1.0], [3.0], [3.0], [2.0]]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(cases by name, each rank's results, the training params) of the one
    world of 4."""
    import torch

    tmp = str(tmp_path_factory.mktemp("edgeshard"))
    cases = _cases()
    t_ir = igt.parse_model_description(routenet_description(num_iterations=2, hs=8),
                                       dict(DIMS))
    params = map_params(lambda t: t.numpy(), igt.build(t_ir).init(
        torch.Generator().manual_seed(1)))
    jobs = [c.job() for c in cases.values()] + _gather_jobs(cases) + _train_jobs(tmp, params)
    jobs.append(dict(name="pool_tie_1x2", kind="es_pool_tie", mesh=(1, 2), x=TIE_X))
    # the steps built with the trainer's `Graphs`, as its mesh loop builds them
    jobs += [dict(cases[n].job(), name=n + "_shared_graphs", shared_graphs=True)
             for n in ("step_1x2_one_graph", "step_2x2")]
    # ranks whose partitions differ in shape: every rank raises
    jobs.append(dict(cases["step_1x2_one_graph"].job(), name="differing_1x2",
                     kind="es_step_raises",
                     stacked_by_rank={(0, 0): cases["step_1x2_one_graph"].stacked,
                                      (0, 1): cases["fwd_1x2"].stacked}))
    ranks = spawn_world(4, jobs, os.path.join(tmp, "world"))
    return cases, ranks


def _on_every_rank(ranks, name, size):
    got = [r[name] for r in ranks[:size]]
    assert all(name not in r for r in ranks[size:])
    for other in got[1:]:
        if isinstance(got[0], np.ndarray):
            np.testing.assert_array_equal(other, got[0])
        else:
            assert other["losses"] == got[0]["losses"]
            for k, v in got[0]["params"].items():
                np.testing.assert_array_equal(other["params"][k], v, err_msg=k)
    return got[0]


def _real_rows(case):
    return np.asarray(case.t_batches[0][0]["node_mask_path"]) > 0


@pytest.mark.parametrize("name", ["fwd_1x2", "fwd_1x4", "qsize_fwd_1x2", "extra_fwd_1x2",
                                  "pooling_fwd_1x4"])
def test_forward_matches_jax(world, name):
    """The destination-sharded forward at m = 2 and 4 (RouteNet; Q-size's
    interleave; an entity-shaped additional input; mean pooling combined
    over the model axis then broadcast back) against the JAX single-device
    forward on the real rows, in the global padded row order."""
    cases, ranks = world
    case = cases[name]
    got = _on_every_rank(ranks, name, case.mesh[0] * case.mesh[1])[0]
    want = case.j_forward()
    mask = _real_rows(case)
    assert got.shape[0] >= mask.size and got.dtype == np.float32
    np.testing.assert_allclose(got[:mask.size][mask], want[mask], **FWD_TOL)


@pytest.mark.parametrize("name", ["attention_fwd_1x4", "reference_fwd_1x4",
                                  "convolution_fwd_1x4"])
def test_vector_aggregations_match_jax(world, name):
    """Attention (per destination and the `reference` softmax, whose
    per-graph max and denominator cross ranks) and convolution at 1x4."""
    cases, ranks = world
    case = cases[name]
    got = _on_every_rank(ranks, name, 4)[0]
    mask = _real_rows(case)
    np.testing.assert_allclose(got[:mask.size][mask], case.j_forward()[mask], **AGG_TOL)


@pytest.mark.parametrize("name", ["edge_fwd_1x2", "edge_fwd_1x4"])
def test_edge_domain_forward_matches_jax(world, name):
    """Edge-domain predictions scattered back through `edge_origin_*` into
    the merged batch's edge order: the real-edge prefix."""
    cases, ranks = world
    case = cases[name]
    got = _on_every_rank(ranks, name, case.mesh[1])[0]
    n_real = int((case.t_batches[0][0]["edge_mask_adj_links_paths"] > 0).sum())
    assert got.shape[0] == n_real
    np.testing.assert_allclose(got, case.j_forward()[:n_real], **FWD_TOL)


def _hold_step(got, case, jax_update=True):
    """A sharded step against the port's serial steps (every element at
    STEP_TOL) and the JAX serial loss (rtol 1e-4) and, with `jax_update`,
    update (the firm elements at STEP_TOL, every element within 2 lr a
    step)."""
    losses, params = case.t_serial()
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["losses"][0], case.j_loss(), rtol=1e-4)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=k, **STEP_TOL)
    if jax_update and case.steps == 1:
        import optax

        from ignnition_tpu.training import build_optimizer

        opt = build_optimizer(case.j_ir.learning.optimizer)
        grads = jax.grad(case._j_serial_loss)(case.j_params)
        updates, _ = opt.update(grads, opt.init(case.j_params), case.j_params)
        want = {k: v.numpy() for k, v in flatten_params(igt.params_from_jax(
            optax.apply_updates(case.j_params, updates))).items()}
        firm = case.firm()
        for k, v in want.items():
            g = got["params"][k]
            np.testing.assert_allclose(g[firm[k]], v[firm[k]], err_msg=k, **STEP_TOL)
            assert np.abs(g - v).max() <= 2 * case.lr(), k


@pytest.mark.parametrize("name", ["step_1x4", "step_1x2_one_graph", "step_2x2",
                                  "reference_step_1x2", "edge_step_1x4", "kl_step_1x2"])
def test_train_step_matches_the_serial_step_and_jax(world, name):
    """A step (two for the one-graph case) at 1x4, 1x2 and 2x2 (two data
    rows, one graph each), the `reference` softmax, the edge-domain model
    and a sum-reduction loss (KLDivergence: the ranks' sums add), held to
    the serial steps; the halo of the 1x2 and 2x2 cases is not empty."""
    cases, ranks = world
    case = cases[name]
    if name in ("step_1x2_one_graph", "step_2x2", "reference_step_1x2", "kl_step_1x2"):
        assert case.halo_rows() > 0
    got = _on_every_rank(ranks, name, case.mesh[0] * case.mesh[1])
    _hold_step(got, case)


@pytest.mark.parametrize("name", ["step_1x2_one_graph", "step_2x2"])
def test_step_with_the_trainers_graphs_matches_the_serial_step_and_jax(world, name):
    """The destination-sharded step built with the trainer's `Graphs` (the
    trainer's mesh loop hands them over; eager on gloo and says so) held as
    the step of its own graphs is."""
    cases, ranks = world
    case = cases[name]
    got = _on_every_rank(ranks, name + "_shared_graphs", case.mesh[0] * case.mesh[1])
    assert got["graphs_are_the_trainers"] and got["ran"] == "eager"
    assert "runs on cpu" in got["why_eager"]
    _hold_step(got, case)


@pytest.mark.parametrize("m", [2, 4])
def test_flagship_diagnostic_loss_equals_the_single_device_loss(world, m):
    """`_edgeshard_scaling_diagnostic`'s flagship (hs 32, 8 iterations, one
    graph of 640 edges a direction), renumbered for m shards: the sharded
    step's loss equals the JAX single-device loss on the same weights
    (3.724015 in MULTICHIP_r05), which the renumbering leaves unchanged."""
    cases, ranks = world
    case = cases[f"flagship640_1x{m}"]
    assert case.halo_rows() > 0
    got = _on_every_rank(ranks, case.name, m)
    np.testing.assert_allclose(got["losses"][0], case.j_loss(), rtol=1e-5)
    assert abs(case.j_loss() - 3.724015) < 5e-6
    _hold_step(got, case, jax_update=False)


@pytest.mark.parametrize("m", [2, 4])
def test_overlapped_gather_equals_the_synchronous_one(world, m):
    """`_halo_gather` (the interior gather issued while the exchange is in
    flight, then the boundary gather from the received rows) against
    `halo_extend(table)[src]`: outputs on the real edges and the table's
    gradients, on every rank, at rtol 1e-6."""
    _, ranks = world
    for r in range(m):
        for adj, ((y, g), (y_ref, g_ref)) in ranks[r][f"gather_1x{m}"].items():
            np.testing.assert_allclose(y, y_ref, rtol=1e-6, err_msg=adj)
            np.testing.assert_allclose(g, g_ref, rtol=1e-6, err_msg=adj)
            assert np.abs(g).max() > 0


def test_max_pool_tie_across_ranks_splits_the_gradient(world):
    """A maximum tied across the two ranks: the pooled value is the max, and
    the gradient splits as the serial `segment_max`'s (JAX's)."""
    _, ranks = world
    x = jnp.asarray(np.array(TIE_X, np.float32))
    want = np.asarray(jax.grad(lambda v: j_seg.graph_pool(
        v, jnp.zeros(4, jnp.int32), 1, jnp.ones(4, jnp.float32), "max").sum())(x))
    got = np.concatenate([ranks[r]["pool_tie_1x2"]["grad"] for r in range(2)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["pool_tie_1x2"]["value"], [[3.0]])


def test_trainer_dest_shard_trains(world):
    """`Trainer.train(mesh, model_strategy="dest_shard")` at 2x2 (locality
    "auto": on) lowers the evaluation loss; every rank ends with the same
    parameters."""
    _, ranks = world
    got = [r["train_2x2"] for r in ranks]
    assert all(g["step"] == 6 for g in got)
    assert got[0]["after"] < got[0]["before"]
    for g in got[1:]:
        for k, v in got[0]["params"].items():
            np.testing.assert_array_equal(g["params"][k], v)


def test_locality_reorder_leaves_the_training_unchanged(world):
    """The same 1x2 run with the renumbering on and off lands on the same
    parameters (`tests/test_edgeshard.py`'s limits) and the same loss."""
    _, ranks = world
    on, off = ranks[0]["train_reorder_on_1x2"], ranks[0]["train_reorder_off_1x2"]
    assert on["step"] == off["step"] == 3
    np.testing.assert_allclose(on["after"], off["after"], rtol=1e-5)
    assert on["after"] < on["before"]
    for k, v in off["params"].items():
        np.testing.assert_allclose(on["params"][k], v, rtol=2e-4, atol=1e-6, err_msg=k)


def test_trainer_dest_shard_edge_domain_with_the_batch_cache(world):
    """Edge labels stream through the dest_shard path with cached batches
    (the partition memo): finite parameters, a falling loss."""
    _, ranks = world
    a, b = ranks[0]["train_edge_1x2"], ranks[1]["train_edge_1x2"]
    assert a["step"] == 4 and a["after"] < a["before"]
    for k, v in a["params"].items():
        assert np.isfinite(v).all(), k
        np.testing.assert_array_equal(b["params"][k], v)


def test_ranks_with_differing_partitions_raise(world):
    """Ranks that step with partitions of different shapes raise on every
    rank before any collective of the model, rather than hang; `apply` with
    both axes raises (a BuildError, as in JAX)."""
    _, ranks = world
    for r in range(2):
        assert "different padded shapes" in ranks[r]["differing_1x2"]
    model = igt.build(igt.parse_model_description(
        routenet_description(num_iterations=2, hs=8), dict(DIMS)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        model.apply({}, {}, None, edge_axis=object(), node_axis=object())


def test_destshard_memo_ignores_transient_repadded_dicts(tmp_path, monkeypatch):
    """`tests/test_edgeshard.py`'s regression on the port's iterator: the
    cache's partition memo is keyed by the batch object; the mixed-meta
    branch re-pads into transient dicts whose ids recycle (forced here by a
    pool of two), and the second group must still come back with its own
    values. The iterator needs only the mesh's shape."""
    import tarfile
    from io import BytesIO

    import ignnition_tpu_torch.data.graph as graph_mod

    rng = np.random.default_rng(11)
    small = make_routenet_sample(rng, 14, 10, 4)
    large = make_routenet_sample(rng, 40, 30, 6)
    small2, large2 = copy.deepcopy(small), copy.deepcopy(large)
    small2["traffic"] = [t + 1.0 for t in small["traffic"]]
    large2["traffic"] = [t + 1.0 for t in large["traffic"]]
    d = tmp_path / "ds"
    d.mkdir()
    payload = json.dumps([small, large, small2, large2]).encode()
    with tarfile.open(d / "sample_0.tar.gz", "w:gz") as tar:
        info = tarfile.TarInfo("data.json")
        info.size = len(payload)
        tar.addfile(info, BytesIO(payload))
    real_repad = graph_mod.repad_to_meta
    pool, calls = [{}, {}], {"n": 0}

    def recycling_repad(arrays, meta, target, ir):
        out = real_repad(arrays, meta, target, ir)
        slot = pool[calls["n"] % 2]
        calls["n"] += 1
        slot.clear()
        slot.update(out)
        return slot

    monkeypatch.setattr(graph_mod, "repad_to_meta", recycling_repad)
    ir = igt.parse_model_description(routenet_description(num_iterations=2, hs=8), dict(DIMS))
    trainer = igt.Trainer(igt.build(ir), padding=igt.PaddingConfig(**PAD), device="cpu")

    class Shape:
        shape = {"data": 2, "model": 2}

    it = trainer._destshard_batch_iter(str(d), 1, Shape(), shuffle=False, cache=True)
    out1 = {k: np.array(v) for k, v in next(it)[0].items()}
    out2 = next(it)[0]
    it.close()
    assert calls["n"] >= 4
    assert any(out1[k].shape != np.shape(out2[k]) or not np.allclose(out1[k], out2[k])
               for k in out1)
