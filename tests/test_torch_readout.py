"""Homogeneous-graph models in the port against the JAX package, on the CPU.

`examples/graphprop` (attention with a feed-forward update, convolution
with a GRU, a mean-pooled graph-level label) and `examples/linkpred` (a sum,
then `extend_adjacencies` and an element-wise `product` to an edge-level
label) as written, and variants of them: the convolution at each of its
lowerings (block-diagonal and dense incidence products, the sorted sum
with row pointers, the id-keyed sum without them, several sources), a
feed-forward update after sum, attention and convolution shared by three
passes, every pooling, the dot product, a batch feature and a broadcast
graph-level tensor as readout inputs, and padded batches. One parameter
tree (JAX init, moved across with `params_from_jax`) and the same seeded
samples go through each package's own `build_batch`; the lowering is
chosen by the batch (equal-sized graphs give block-diagonal incidences,
unequal ones a dense incidence) and by the dense-incidence cap, patched to
0 in both packages for the CSR sums. The JAX package's slot-rate attention
is not ported: both take the per-edge form there, which computes the same
function. f32 agrees at atol = rtol = 1e-4, bf16 at 3e-2, `graph_pool` at
1e-5 (bf16 at 1e-2); forward, loss, every gradient leaf and 10 Adam steps.
Also: every example under `examples/` builds, predicts like the JAX package
and takes a training step in the port, and the model's own errors name
what they refuse.
"""

import collections
import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import ignnition_tpu as ig
import ignnition_tpu.data.graph as j_graph
import ignnition_tpu.model.builder as j_builder
import ignnition_tpu_torch as igt
import ignnition_tpu_torch.data.graph as t_graph
from ignnition_tpu.data import SampleSpec as JSampleSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data import synthetic as j_synthetic
from ignnition_tpu.frontend import parse_model_description as j_parse
from ignnition_tpu.model import build as j_build
from ignnition_tpu.ops import segment as j_seg
from ignnition_tpu.training import optimizers as j_opt
from ignnition_tpu.training.trainer import Trainer as JTrainer
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data import synthetic as t_synthetic
from ignnition_tpu_torch.model import builder as t_builder
from ignnition_tpu_torch.model.builder import BuildError, flatten_params
from ignnition_tpu_torch.ops import segment as t_seg
from ignnition_tpu_torch.ops.cuda import segment_kernels as t_sk
from ignnition_tpu_torch.training import optimizers as t_opt

from helpers import dense
from test_torch_model import BF16_TOL, F32_TOL
from test_torch_train import _check_adam_trajectory, _check_loss_and_gradients, _jax_flat

torch.set_num_threads(1)

POOL_TOL = dict(atol=1e-5, rtol=1e-5)
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
ADJ = "adj_nodes_nodes"


def example(name):
    with open(EXAMPLES / name / "model_description.yaml") as f:
        return yaml.safe_load(f)


# --------------------------------------------------------------------------
# descriptions
# --------------------------------------------------------------------------


def _node_pass(aggregation, update):
    return {"destination_entity": "node",
            "source_entities": [{"name": "node", "adj_vector": ADJ,
                                 "message": [{"type": "direct_assignation"}]}],
            "aggregation": aggregation, "update": update}


def _gcn(sources=1):
    """One node entity at hs=16, 2 iterations of one convolution pass into a
    GRU, sum pooling to the graph-level label `y` (graphprop samples)."""
    d = example("graphprop")
    d["entities"][0]["hidden_state_dimension"] = 16
    update = {"type": "recurrent_neural_network", "nn_name": "node_gru"}
    mp = _node_pass({"type": "convolution"}, update)
    mp["source_entities"] *= sources
    d["message_passing"] = {"num_iterations": 2,
                            "stages": [{"stage_name": "convolve", "stage_mp": [mp]}]}
    d["readout"][1]["type_pooling"] = "sum"
    return d


def _ff_updates():
    """Three passes updating `node` by one feed-forward network with an l2
    penalty, after a sum, an attention and a convolution: the passes share
    `node_ff_update`, whose penalty counts once."""
    d = example("graphprop")
    d["entities"][0]["hidden_state_dimension"] = 16
    ff = {"type": "neural_network", "nn_name": "node_update"}
    d["message_passing"] = {"num_iterations": 2, "stages": [
        {"stage_name": name, "stage_mp": [_node_pass({"type": kind}, ff)]}
        for name, kind in (("add", "sum"), ("attend", "attention"), ("convolve", "convolution"))
    ]}
    net = next(n for n in d["neural_networks"] if n["nn_name"] == "node_update")
    net["nn_architecture"] = [dense(24, "relu", 0.01), dense(16, None, 0.01)]
    return d


def _readout_variant(readout, networks=()):
    d = example("graphprop")
    d["readout"] = readout
    d["neural_networks"] += list(networks)
    return d


def _pooling(kind):
    d = example("graphprop")
    d["readout"][1]["type_pooling"] = kind
    return d


# a graph-level tensor broadcast onto node rows twice: a network over
# [graph_emb, node] and an element-wise product with graph_emb, then a max
BROADCAST = _readout_variant([
    {"type": "neural_network", "input": ["node"], "nn_name": "node_embed",
     "output_name": "node_emb"},
    {"type": "pooling", "type_pooling": "mean", "input": ["node_emb"],
     "output_name": "graph_emb"},
    {"type": "neural_network", "input": ["graph_emb", "node"], "nn_name": "node_ctx",
     "output_name": "ctx"},
    {"type": "product", "type_product": "element_wise", "input": ["graph_emb", "ctx"],
     "output_name": "mix"},
    {"type": "pooling", "type_pooling": "max", "input": ["mix"], "output_name": "graph_max"},
    {"type": "predict", "input": ["graph_max"], "label": "y", "nn_name": "graph_readout"},
], [{"nn_name": "node_ctx", "nn_type": "feed_forward",
     "nn_architecture": [dense(64, "tanh")]}])

# a batch feature (the node feature `cap`, f32 [n, 1]) beside the final
# states: in bf16 the concatenation promotes to f32, as in the JAX package
FEATURE_INPUT = _readout_variant([
    {"type": "neural_network", "input": ["node", "cap"], "nn_name": "node_embed",
     "output_name": "node_emb"},
    {"type": "pooling", "type_pooling": "sum", "input": ["node_emb"], "output_name": "graph_emb"},
    {"type": "predict", "input": ["graph_emb"], "label": "y", "nn_name": "graph_readout"},
])


def _dot_product():
    d = example("linkpred")
    d["readout"][2]["type_product"] = "dot_product"
    return d


# case -> (description, make_sample name, node counts of the graphs, knobs,
# keys dropped from both batches). Knobs: "cap0" the dense-incidence cap
# patched to 0 in both packages (the CSR sums); "pad64" padding to
# multiples of 64 rows. Equal node counts give block-diagonal incidences,
# unequal ones a dense incidence under the cap.
UNEQUAL, EQUAL = (10, 14, 12), (12, 12, 12)
CASES = {
    "graphprop_blocks": (lambda: example("graphprop"), "graphprop", EQUAL, (), ()),
    "graphprop_dense": (lambda: example("graphprop"), "graphprop", UNEQUAL, (), ()),
    "graphprop_csr": (lambda: example("graphprop"), "graphprop", UNEQUAL, ("cap0",), ()),
    "linkpred": (lambda: example("linkpred"), "linkpred", UNEQUAL, (), ()),
    "linkpred_csr_padded": (lambda: example("linkpred"), "linkpred", UNEQUAL,
                            ("cap0", "pad64"), ()),
    "gcn_blocks": (_gcn, "graphprop", EQUAL, (), ()),
    "gcn_dense": (_gcn, "graphprop", UNEQUAL, (), ()),
    "gcn_csr": (_gcn, "graphprop", UNEQUAL, ("cap0",), ()),
    # without row pointers the sorted sum is keyed by the destination ids
    "gcn_sorted_ids": (_gcn, "graphprop", UNEQUAL, ("cap0",), (f"row_ptr_{ADJ}",)),
    # two sources: their edges concatenated, an unsorted sum
    "gcn_two_sources": (lambda: _gcn(sources=2), "graphprop", UNEQUAL, (), ()),
    "ff_updates_dense": (_ff_updates, "graphprop", UNEQUAL, (), ()),
    "ff_updates_csr": (_ff_updates, "graphprop", UNEQUAL, ("cap0",), ()),
    "pool_sum": (lambda: _pooling("sum"), "graphprop", UNEQUAL, (), ()),
    "pool_max": (lambda: _pooling("max"), "graphprop", UNEQUAL, (), ()),
    "broadcast": (lambda: BROADCAST, "graphprop", UNEQUAL, ("pad64",), ()),
    "feature_input": (lambda: FEATURE_INPUT, "graphprop", UNEQUAL, (), ()),
    "dot_product": (_dot_product, "linkpred", UNEQUAL, (), ()),
}
DIMS = {"graphprop": {"x": 1, "cap": 1}, "linkpred": {"x": 1}}


def case_batches(name, monkeypatch, training=True):
    """(JAX ir, port ir, JAX arrays, port arrays, meta) of a case, with its
    knobs patched in both packages."""
    make_desc, kind, sizes, knobs, drop = CASES[name]
    # the attention cases hold the per-edge form and the incidence products:
    # slot-rate attention off in both packages
    for builder in (j_builder, t_builder):
        monkeypatch.setattr(builder, "_SLOT_ATTN", False)
    if "cap0" in knobs:
        for g in (j_graph, t_graph):
            monkeypatch.setattr(g, "_DENSE_INC_MAX_ENTRIES", 0)
    desc = make_desc()
    out, irs = [], []
    for parse, spec_cls, convert, synthetic, build, pad in (
        (j_parse, JSampleSpec, j_convert, j_synthetic, j_build_batch, j_graph.PaddingConfig),
        (igt.parse_model_description, igt.SampleSpec, igt.convert_sample, t_synthetic,
         igt.build_batch, igt.PaddingConfig),
    ):
        ir = parse(copy.deepcopy(desc), dict(DIMS[kind]))
        make = getattr(synthetic, f"make_{kind}_sample")
        rng = np.random.default_rng(0)
        spec = spec_cls.from_ir(ir)
        samples = [convert(make(rng, n_nodes=n), spec) for n in sizes]
        padding = pad(mode="multiple", multiple=64, min_size=64) if "pad64" in knobs else pad()
        arrays, meta = build(samples, ir, padding, training=training)
        for k in [k for k in arrays if drop and k.startswith(drop)]:
            del arrays[k]
        irs.append(ir)
        out.append((arrays, meta))
    (j_arrays, meta), (t_arrays, t_meta) = out
    assert sorted(j_arrays) == sorted(t_arrays) and repr(meta) == repr(t_meta)
    # the id-keyed kernel keys graph pooling by ids that never decrease over
    # the real rows (a host check, once per batch)
    ids = t_arrays["graph_id_node"][t_arrays["node_mask_node"] > 0]
    assert np.all(np.diff(ids) >= 0)
    return irs[0], irs[1], j_arrays, t_arrays, meta


def _extra_dims(name):
    return {"cap": 1} if name == "feature_input" else None


def _jax_params(name, j_ir_):
    return j_build(j_ir_).init(jax.random.PRNGKey(0), extra_dims=_extra_dims(name))


def _port_model(t_ir_, j_params):
    model = igt.build(t_ir_)
    model.load_params(igt.params_from_jax(j_params))
    return model


def _forward_both(name, monkeypatch, compute_dtype):
    j_ir_, t_ir_, j_arrays, t_arrays, meta = case_batches(name, monkeypatch)
    j_params = _jax_params(name, j_ir_)
    got = _port_model(t_ir_, j_params)(
        to_device(t_arrays, "cpu"), meta, compute_dtype=compute_dtype
    )
    want = j_build(j_ir_).apply(
        j_params, j_arrays, meta,
        compute_dtype=None if compute_dtype is None else jnp.bfloat16,
    )
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_readout_forward_matches_jax_f32(name, monkeypatch):
    got, want = _forward_both(name, monkeypatch, None)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("name", ["graphprop_blocks", "graphprop_csr", "linkpred",
                                  "ff_updates_dense", "broadcast", "feature_input"])
def test_readout_forward_matches_jax_bf16(name, monkeypatch):
    got, want = _forward_both(name, monkeypatch, torch.bfloat16)
    np.testing.assert_allclose(got, want, **BF16_TOL)


# --------------------------------------------------------------------------
# which lowering each pass and readout op takes
# --------------------------------------------------------------------------


def _spy(monkeypatch, targets):
    calls = collections.Counter()
    for mod, name in targets:
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return calls


# per forward (2 iterations; graphprop 3): the convolution's product or sum,
# the attention's form, the pooling's id-keyed sum (the plain versions of
# the kernels here: `sorted_segment_sum_csr_plain` is kernel A's); per-edge
# messages of a state table are gathered by `gather_rows` (its backward
# kernel A), the incidence products read the table itself
ROUTES = {
    "graphprop_blocks": {"direct_segment_sum_blocks": 3, "_flash_masked_softmax_matmul": 3,
                         "graph_pool": 1, "sorted_segment_sum_ids_plain": 1},
    "graphprop_dense": {"direct_segment_sum_dense": 3, "_flash_masked_softmax_matmul": 3,
                        "graph_pool": 1, "sorted_segment_sum_ids_plain": 1},
    # per iteration: the convolution's sum, the attention's numerator and
    # denominator (kernel A)
    "graphprop_csr": {"sorted_segment_sum_csr_plain": 9, "sorted_softmax_aggregate": 3,
                      "graph_pool": 1, "sorted_segment_sum_ids_plain": 1, "gather_rows": 6},
    "gcn_sorted_ids": {"sorted_segment_sum_ids_plain": 3, "graph_pool": 1, "gather_rows": 2},
    # the sum past the cap is a gather and kernel A, the readout's gathers none
    "linkpred_csr_padded": {"sorted_segment_sum_csr_plain": 2, "gather_rows": 1,
                            "gather_by_dst": 1},
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_readout_routes(name, monkeypatch):
    j_ir_, t_ir_, _, t_arrays, meta = case_batches(name, monkeypatch)
    calls = _spy(monkeypatch, [
        (t_seg, "direct_segment_sum_blocks"), (t_seg, "direct_segment_sum_dense"),
        (t_seg, "_flash_masked_softmax_matmul"), (t_seg, "sorted_softmax_aggregate"),
        (t_seg, "graph_pool"), (t_seg, "gather_rows"), (t_seg, "gather_by_dst"),
        (t_sk, "sorted_segment_sum_csr_plain"), (t_sk, "sorted_segment_sum_ids_plain"),
    ])
    _port_model(t_ir_, _jax_params(name, j_ir_))(to_device(t_arrays, "cpu"), meta)
    want = dict(ROUTES[name])
    if name == "graphprop_csr":
        # the attention's destination scores are gathered per edge
        want["gather_by_dst"] = 3
    assert dict(calls) == want


def test_step_kernels_on_the_csr_paths(monkeypatch):
    """A training step's sums on graphprop's and linkpred's CSR batches (the
    plain versions here): graphprop's forward (9 of kernel A, 1 id-keyed
    pooling sum), the attention's destination-score gathers transposed (3
    of kernel A) and the message gathers transposed (kernel A: the
    convolution's 3, the attention's 2, as the first iteration's attention
    reads the features); linkpred's sums (2) and both readout gathers
    transposed (2 of kernel A). The sums' own backwards are gathers."""
    for name, want in (("graphprop_csr", dict(csr=17, ids=1)),
                       ("linkpred_csr_padded", dict(csr=4, ids=0))):
        j_ir_, t_ir_, _, t_arrays, meta = case_batches(name, monkeypatch)
        calls = _spy(monkeypatch, [(t_sk, "sorted_segment_sum_csr_plain"),
                                   (t_sk, "sorted_segment_sum_ids_plain")])
        trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
        state = trainer.init_state(params=igt.params_from_jax(_jax_params(name, j_ir_)))
        trainer.grads_fn(meta)(state.params, to_device(t_arrays, "cpu"))
        assert (calls["sorted_segment_sum_csr_plain"],
                calls["sorted_segment_sum_ids_plain"]) == (want["csr"], want["ids"]), name
        monkeypatch.undo()


# --------------------------------------------------------------------------
# graph_pool
# --------------------------------------------------------------------------


def _pool_inputs(rng, dtype):
    """Rows of 4 graphs and 3 padding rows: graph 1 all masked, graph 3 of one
    row, ties in graph 0 (rows 0-1 share a column's max)."""
    gid = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3], np.int64)
    mask = np.array([1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    x = rng.standard_normal((13, 5)).astype(np.float32)
    x[1, 2] = x[0, 2] = 3.0
    x = np.asarray(jnp.asarray(x, dtype)).astype(np.float32)  # representable in dtype
    return x, gid, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sum", "mean", "max"])
def test_graph_pool_matches_jax(kind, dtype):
    """Forward and backward against the JAX `graph_pool`, with ties (the
    cotangent split among them), an all-masked graph (0), a one-row graph
    and padding rows in another graph."""
    rng = np.random.default_rng(7)
    x, gid, mask = _pool_inputs(rng, getattr(jnp, dtype))
    ct = rng.standard_normal((4, 5)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want, vjp = jax.vjp(
        lambda v: j_seg.graph_pool(v, jnp.asarray(gid), 4, jnp.asarray(mask), kind), jx)
    (want_ct,) = vjp(jnp.asarray(ct, want.dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = t_seg.graph_pool(tx, torch.from_numpy(gid), 4, torch.from_numpy(mask), kind)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    (got_ct,) = torch.autograd.grad(got, tx, torch.from_numpy(ct).to(got.dtype))
    tol = POOL_TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)
    np.testing.assert_allclose(got_ct.float().numpy(), np.asarray(want_ct, np.float32), **tol)
    assert np.all(got.detach().float().numpy()[1] == 0.0)
    if kind == "max":
        # the tie of rows 0 and 1 in column 2 splits its cotangent
        np.testing.assert_allclose(got_ct.float().numpy()[[0, 1], 2], ct[0, 2] / 2, rtol=1e-2)


def test_graph_pool_keys_padding_rows_between_graphs():
    """Per-graph padding puts padding rows (id num_graphs - 1) between
    graphs: the id-keyed sum still gives each graph its own rows."""
    gid = torch.tensor([0, 0, 2, 2, 1, 1, 2, 2, 2])
    mask = torch.tensor([1, 1, 0, 0, 1, 1, 1, 0, 0], dtype=torch.float32)
    x = torch.arange(18, dtype=torch.float32).reshape(9, 2)
    for kind in ("sum", "mean"):
        got = t_seg.graph_pool(x, gid, 3, mask, kind)
        want = j_seg.graph_pool(jnp.asarray(x.numpy()), jnp.asarray(gid.numpy()), 3,
                                jnp.asarray(mask.numpy()), kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **POOL_TOL)


def test_pool_ids_leave_trailing_padding_out():
    """Padding rows take the graph of the next real row, and `num_graphs`
    past the last one, which the id-keyed sum does not count: the last
    graph's segment holds its real rows only. The id-keyed sum's backward
    (the kernel's, on the card) gives those rows zero, as the plain
    version's autograd does."""
    gid = torch.tensor([0, 0, 2, 1, 1, 2, 2, 2, 2, 2])
    mask = torch.tensor([1, 1, 0, 1, 1, 1, 0, 0, 0, 0], dtype=torch.float32)
    ids = t_seg._pool_ids(gid, 3, mask)
    assert ids.tolist() == [0, 0, 1, 1, 1, 2, 3, 3, 3, 3]
    data = torch.randn(10, 4, requires_grad=True)
    ct = torch.randn(3, 4)
    (want,) = torch.autograd.grad(t_sk.sorted_segment_sum_ids_plain(data, ids, 3), data, ct)
    got = t_sk.sorted_segment_sum_ids_transpose(ct, ids)
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)
    assert got[6:].abs().max() == 0


# --------------------------------------------------------------------------
# the slice as a whole: loss, reg, gradients, Adam trajectory
# --------------------------------------------------------------------------


def _trainers(name, monkeypatch):
    j_ir_, t_ir_, j_arrays, t_arrays, meta = case_batches(name, monkeypatch)
    j_model = j_build(j_ir_)
    j_init = j_model.init
    j_model.init = lambda rng: j_init(rng, extra_dims=_extra_dims(name))
    j_trainer = JTrainer(j_model, compute_dtype=None)
    t_trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
    j_state = j_trainer.init_state(jax.random.PRNGKey(0))
    t_state = t_trainer.init_state(params=igt.params_from_jax(j_state.params))
    return j_trainer, t_trainer, j_state, t_state, j_arrays, to_device(t_arrays, "cpu"), meta


TRAIN_CASES = ["graphprop_blocks", "graphprop_dense", "graphprop_csr", "linkpred",
               "linkpred_csr_padded", "gcn_sorted_ids", "gcn_two_sources", "ff_updates_csr",
               "broadcast", "feature_input", "dot_product", "pool_max"]


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_readout_loss_and_gradients_match_jax(name, monkeypatch):
    _check_loss_and_gradients(_trainers(name, monkeypatch))


# learning rates: graphprop's 0.002 (its staircase decay stays flat over 10
# steps), linkpred's 0.003
@pytest.mark.parametrize("name,lr", [("graphprop_csr", 0.002), ("graphprop_blocks", 0.002),
                                     ("linkpred_csr_padded", 0.003),
                                     ("ff_updates_dense", 0.002)])
def test_readout_adam_trajectory_matches_jax(name, lr, monkeypatch):
    _check_adam_trajectory(_trainers(name, monkeypatch), lr=lr)


def test_ff_update_is_shared_and_its_l2_counted_once(monkeypatch):
    """The three passes read one `node_ff_update`; its l2 penalty counts
    once, as in the JAX package."""
    j_ir_, t_ir_, *_ = case_batches("ff_updates_dense", monkeypatch)
    j_model = j_build(j_ir_)
    j_params = j_model.init(jax.random.PRNGKey(0))
    t_params = igt.build(t_ir_).init(torch.Generator().manual_seed(0))
    assert list(t_params["update"]) == list(j_params["update"]) == ["node_ff_update"]
    got = igt.build(t_ir_).regularization_loss(igt.params_from_jax(j_params))
    want = j_model.regularization_loss(j_params)
    once = sum(0.01 * float(jnp.sum(layer["kernel"] ** 2))
               for layer in j_params["update"]["node_ff_update"]["layers"])
    np.testing.assert_allclose(got.item(), float(want), **F32_TOL)
    np.testing.assert_allclose(got.item(), once, **F32_TOL)


def test_padding_edges_get_no_cotangent(monkeypatch):
    """extend_adjacencies on a padded batch (padding edges and padding
    nodes): under the masked loss the per-edge predictions of padding edges
    get a zero cotangent, and with such a cotangent the port's two gathers,
    whose backwards sum real edges only (kernel A over the row pointers and
    the source sort), give the node-table gradient of the JAX package's
    plain indexing, which sums the padding edges too. A cotangent on the
    padding edges would tell the two apart."""
    j_ir_, t_ir_, j_arrays, t_arrays, meta = case_batches("linkpred_csr_padded", monkeypatch)
    emask = t_arrays[f"edge_mask_{ADJ}"]
    assert (emask == 0).any() and (t_arrays["node_mask_node"] == 0).any()
    batch = to_device(t_arrays, "cpu")
    trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
    model = _port_model(t_ir_, _jax_params("linkpred_csr_padded", j_ir_))
    preds = model(batch, meta).detach().requires_grad_(True)
    assert preds.shape == emask.shape
    (ct,) = torch.autograd.grad(
        trainer.loss_fn(batch["label"], preds, batch["label_mask"]), preds)
    assert torch.all(ct[emask == 0] == 0) and torch.any(ct[emask > 0] != 0)

    rng = np.random.default_rng(1)
    n, d = meta.nodes("node"), 8
    table = rng.standard_normal((n, d)).astype(np.float32)
    src, dst = t_arrays[f"src_{ADJ}"], t_arrays[f"dst_{ADJ}"]
    j_gather = jax.vjp(lambda x: (x[src], x[dst]), jnp.asarray(table))[1]
    for on_padding in (0.0, 1.0):
        weight = np.where(emask > 0, 1.0, on_padding).astype(np.float32)[:, None]
        cts = [(rng.standard_normal((len(emask), d)) * weight).astype(np.float32)
               for _ in range(2)]
        x = torch.from_numpy(table).requires_grad_(True)
        gathered = (t_builder._gather_src(batch, ADJ, x), t_builder._gather_dst(batch, ADJ, x))
        (got,) = torch.autograd.grad(gathered, x, [torch.from_numpy(c) for c in cts])
        (want,) = j_gather(tuple(jnp.asarray(c) for c in cts))
        if on_padding:
            assert not np.allclose(got.numpy(), np.asarray(want), **F32_TOL)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("name", ["graphprop_csr", "linkpred", "ff_updates_dense",
                                  "feature_input", "broadcast"])
def test_init_tree_matches_jax_layout(name, monkeypatch):
    """`init` draws the convolution kernel, the feed-forward update and the
    readout networks at the JAX widths under the JAX keys."""
    j_ir_, t_ir_, *_ = case_batches(name, monkeypatch)
    j_params = _jax_params(name, j_ir_)
    t_params = igt.build(t_ir_).init(torch.Generator().manual_seed(0),
                                     extra_dims=_extra_dims(name))
    want = {k: np.shape(v) for k, v in _jax_flat(j_params).items()}
    assert {k: tuple(v.shape) for k, v in flatten_params(t_params).items()} == want


def test_graphprop_schedule_matches_jax():
    """graphprop's ExponentialDecay with `staircase: "True"` (a string)."""
    spec = igt.parse_model_description(example("graphprop"), DIMS["graphprop"]).learning
    sched = spec.optimizer.schedule
    got = t_opt.build_schedule(sched)
    want = j_opt.build_schedule(j_parse(example("graphprop"), DIMS["graphprop"])
                                .learning.optimizer.schedule)
    for step in (0, 1, 19_999, 20_000, 39_999, 40_000, 70_001):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert got(19_999) == 0.002 and got(20_000) == pytest.approx(0.0016)


# --------------------------------------------------------------------------
# serving: graph- and edge-level predictions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["graphprop_csr", "linkpred_csr_padded"])
def test_serving_predicts_graph_and_edge_rows(name, monkeypatch):
    """`ServingModel.predict_samples` gives one prediction per graph, or one
    per real edge in each sample's original edge order (`label_perm`), equal
    to the JAX package's apply reordered alike."""
    make_desc, kind, sizes, knobs, _ = CASES[name]
    j_ir_, t_ir_, j_arrays, _, meta = case_batches(name, monkeypatch, training=False)
    j_params = _jax_params(name, j_ir_)
    want = np.asarray(j_build(j_ir_).apply(j_params, j_arrays, meta))
    rng = np.random.default_rng(0)
    make = getattr(t_synthetic, f"make_{kind}_sample")
    spec = igt.SampleSpec.from_ir(t_ir_)
    raws = [make(rng, n_nodes=n) for n in sizes]
    samples = [igt.convert_sample(r, spec) for r in raws]
    server = igt.ServingModel(igt.build(t_ir_), igt.params_from_jax(j_params), meta, t_ir_,
                              compute_dtype=None, device="cpu")
    got = server.predict_samples(samples)
    if kind == "graphprop":
        assert got.shape == (len(sizes),)
    else:
        n_edges = sum(len(v) for r in raws for v in r[ADJ].values())
        assert got.shape == (n_edges,)
        # `label_perm` takes the destination-sorted edges back to the
        # samples' insertion order, where their labels lie
        perm = server.build_batch(samples)["label_perm"]
        labelled, _ = igt.build_batch(samples, t_ir_, training=True, target=meta)
        labels = np.concatenate([r["edge_score"] for r in raws]).astype(np.float32)
        np.testing.assert_array_equal(labelled["label"][perm][:n_edges], labels)
        want = want[perm][:n_edges]
    np.testing.assert_allclose(got, want, **F32_TOL)


# --------------------------------------------------------------------------
# every example under examples/ builds, predicts and trains in the port
# --------------------------------------------------------------------------


def _normalization_routenet(feature, name):
    """`examples/routenet/main.py`'s scaling."""
    if name == "traffic":
        return (feature - 170.0) / 130.0
    if name == "link_capacity":
        return (feature - 25000.0) / 40000.0
    return feature


def _normalization_queue_size(feature, name):
    """`examples/qsize/main.py`'s scaling."""
    if name == "delay":
        return (np.log(feature) + 1.78) / 0.93
    if name == "traffic":
        return (feature - 0.28) / 0.15
    if name == "jitter":
        return (feature + 1.9) / 1.5
    return feature


# example -> (feature widths, sample maker name, its arguments)
EXAMPLE_DATA = {
    "gat": ({"signal": 1, "importance": 1}, "make_gat_sample", dict(n_nodes=12)),
    "graphprop": (DIMS["graphprop"], "make_graphprop_sample", dict(n_nodes=12)),
    "linkpred": (DIMS["linkpred"], "make_linkpred_sample", dict(n_nodes=12)),
    "qsize": ({"link_capacity": 1, "traffic": 1, "queue_sizes": 1}, "make_routenet_sample",
              dict(n_links=10, n_paths=8, max_path_len=4, with_nodes=True)),
    "routenet": ({"link_capacity": 1, "traffic": 1}, "make_routenet_sample",
                 dict(n_links=10, n_paths=8, max_path_len=4)),
}


def test_every_example_is_tested():
    assert sorted(p.name for p in EXAMPLES.iterdir() if (p / "model_description.yaml").exists()) \
        == sorted(EXAMPLE_DATA)


@pytest.mark.parametrize("name", sorted(EXAMPLE_DATA))
def test_every_example_builds_predicts_and_trains(name, monkeypatch):
    """Each `examples/*/model_description.yaml` as written: the port builds
    it, predicts like the JAX package from the same parameters on a batch of
    two small graphs, and takes one training step with a finite loss. Both
    packages on the JAX package's default of `_SLOT_ATTN` (on; the port's is
    off): slot-rate attention where the JAX package takes it."""
    monkeypatch.setattr(t_builder, "_SLOT_ATTN", j_builder._SLOT_ATTN)
    for register in (ig.register_normalization, igt.register_normalization):
        register("normalization_routenet", _normalization_routenet)
        register("normalization_queue_size", _normalization_queue_size)
    dims, maker, kw = EXAMPLE_DATA[name]
    out = []
    for parse, spec_cls, convert, synthetic, build in (
        (j_parse, JSampleSpec, j_convert, j_synthetic, j_build_batch),
        (igt.parse_model_description, igt.SampleSpec, igt.convert_sample, t_synthetic,
         igt.build_batch),
    ):
        ir = parse(example(name), dict(dims))
        rng = np.random.default_rng(1)
        spec = spec_cls.from_ir(ir)
        samples = [convert(getattr(synthetic, maker)(rng, **kw), spec) for _ in range(2)]
        out.append((ir,) + tuple(build(samples, ir, training=True)))
    (j_ir_, j_arrays, meta), (t_ir_, t_arrays, _) = out
    j_params = j_build(j_ir_).init(jax.random.PRNGKey(0))
    want = np.asarray(j_build(j_ir_).apply(j_params, j_arrays, meta))
    model = _port_model(t_ir_, j_params)
    batch = to_device(t_arrays, "cpu")
    np.testing.assert_allclose(model(batch, meta).numpy(), want, **F32_TOL)
    trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
    state = trainer.init_state(params=igt.params_from_jax(j_params))
    state, metrics = trainer.train_step_fn(meta)(state, batch)
    assert state.step == 1 and np.isfinite(metrics["total"].item())


# --------------------------------------------------------------------------
# the model's own errors
# --------------------------------------------------------------------------


def _ff_after_ordered(d):
    d["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"] = {"type": "ordered"}
    d["message_passing"]["stages"][1]["stage_mp"][0]["update"] = {
        "type": "neural_network", "nn_name": "node_update"}


def _narrow_messages(d):
    # a message network of width 8 into a convolution over 32-wide states
    d["neural_networks"].append({"nn_name": "msg", "nn_type": "feed_forward",
                                 "nn_architecture": [dense(8, "relu")]})
    d["message_passing"]["stages"][1]["stage_mp"][0]["source_entities"][0]["message"] = [
        {"type": "neural_network", "nn_name": "msg", "input": ["hs_source"]}]


def _pool_graph_tensor(d):
    d["readout"].insert(2, {"type": "pooling", "type_pooling": "sum", "input": ["graph_emb"],
                            "output_name": "graph_emb2"})


BUILD_ERRORS = {
    "ff_after_ordered": (_ff_after_ordered, BuildError,
                         "a feed-forward update requires a single-vector aggregation"),
    "convolution_width": (_narrow_messages, BuildError,
                          r"convolution aggregation requires message dim \(8\) == "
                          r"destination state dim \(32\)"),
}


@pytest.mark.parametrize("name", sorted(BUILD_ERRORS))
def test_unported_and_invalid_models_raise_by_name(name):
    mutate, error, text = BUILD_ERRORS[name]
    d = example("graphprop")
    mutate(d)
    ir = igt.parse_model_description(d, dict(DIMS["graphprop"]))
    with pytest.raises(error, match=text):
        igt.build(ir)


def test_pooling_a_graph_tensor_raises_as_jax_does(monkeypatch):
    """Pooling accepts entity rows only; the model says so when it runs, as
    the JAX package does."""
    j_ir_, t_ir_, _, t_arrays, meta = case_batches("graphprop_dense", monkeypatch)
    d = example("graphprop")
    _pool_graph_tensor(d)
    ir = igt.parse_model_description(d, dict(DIMS["graphprop"]))
    model = igt.build(ir)
    model.init(torch.Generator().manual_seed(0))
    with pytest.raises(BuildError, match="pooling over domain"):
        model(to_device(t_arrays, "cpu"), meta)


def test_unknown_readout_input_width_raises():
    d = FEATURE_INPUT
    ir = igt.parse_model_description(copy.deepcopy(d), dict(DIMS["graphprop"]))
    igt.build(ir).init(torch.Generator().manual_seed(0))  # `cap` is a feature
    d2 = copy.deepcopy(d)
    d2["readout"][0]["input"] = ["node", "capacity_hint"]
    ir = igt.parse_model_description(d2, dict(DIMS["graphprop"]))
    with pytest.raises(BuildError, match="readout input 'capacity_hint' has unknown width"):
        igt.build(ir).init(torch.Generator().manual_seed(0))
    igt.build(ir).init(torch.Generator().manual_seed(0), extra_dims={"capacity_hint": 3})


# --------------------------------------------------------------------------
# the kernel path against the plain path, on a CUDA device (phase 8 of
# chip_smoke.py at a small size)
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())


def _launches():
    from ignnition_tpu_torch.ops.cuda import attention_kernels as ak

    return dict(a=t_sk.launch_count, ids=t_sk.ids_launch_count, d=ak.fwd_launch_count,
                e=ak.bwd_launch_count)


# case -> launches of one forward, of one training step
CUDA_LAUNCHES = {
    "graphprop_csr": (dict(a=9, ids=1, d=0, e=0), dict(a=17, ids=1, d=0, e=0)),
    "graphprop_blocks": (dict(a=0, ids=1, d=3, e=0), dict(a=0, ids=1, d=3, e=3)),
    "linkpred_csr_padded": (dict(a=2, ids=0, d=0, e=0), dict(a=4, ids=0, d=0, e=0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_graph_pool_kernel_matches_plain_on_cuda(cuda_device, kind):
    """`graph_pool` through the id-keyed kernel with padding rows between
    graphs and past the last, forward and backward, against the CPU."""
    rng = np.random.default_rng(11)
    sizes = rng.integers(3, 9, size=40)
    gid = np.concatenate([np.full(n, g) for g, n in enumerate(sizes)] + [np.full(100, 39)])
    mask = np.concatenate([np.ones(int(sizes.sum())), np.zeros(100)]).astype(np.float32)
    mask[5] = 0.0  # a padding row inside a graph
    x = rng.standard_normal((gid.shape[0], 24)).astype(np.float32)
    ct = rng.standard_normal((40, 24)).astype(np.float32)
    out = {}
    for device in ("cpu", cuda_device):
        tx = torch.from_numpy(x).to(device).requires_grad_(True)
        before = t_sk.ids_launch_count
        got = t_seg.graph_pool(tx, torch.from_numpy(gid).to(device), 40,
                               torch.from_numpy(mask).to(device), kind)
        (g,) = torch.autograd.grad(got, tx, torch.from_numpy(ct).to(device))
        out[str(device)] = (got.detach().cpu(), g.cpu(), t_sk.ids_launch_count - before)
    (want, want_g, _), (got, got_g, launched) = out["cpu"], out[str(cuda_device)]
    assert launched == 1
    torch.testing.assert_close(got, want, **POOL_TOL)
    torch.testing.assert_close(got_g, want_g, **POOL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_LAUNCHES))
def test_kernel_path_matches_plain_on_cuda(cuda_device, name, monkeypatch):
    """Predictions (f32, bf16), step-0 loss and gradients (f32) of the kernel
    path against the same model on the CPU, with the launch counts."""
    _, t_ir_, _, t_arrays, meta = case_batches(name, monkeypatch)
    params = igt.build(t_ir_).init(torch.Generator().manual_seed(0))
    fwd, step = CUDA_LAUNCHES[name]
    for dtype, tol in ((None, F32_TOL), (torch.bfloat16, BF16_TOL)):
        cpu, card = igt.build(t_ir_), igt.build(t_ir_)
        cpu.load_params(params)
        card.load_params(params, device=cuda_device)
        with torch.inference_mode():
            want = cpu(to_device(t_arrays, "cpu"), meta, compute_dtype=dtype)
            before = _launches()
            got = card(to_device(t_arrays, cuda_device), meta, compute_dtype=dtype)
            torch.cuda.synchronize()
            grown = {k: v - before[k] for k, v in _launches().items()}
        assert grown == fwd
        torch.testing.assert_close(got.cpu(), want, **tol)
    out = {}
    for device in ("cpu", cuda_device):
        trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device=device)
        state = trainer.init_state(params=params)
        before = _launches()
        grads, metrics = trainer.grads_fn(meta)(state.params, to_device(t_arrays, device))
        grown = {k: v - before[k] for k, v in _launches().items()}
        out[str(device)] = (flatten_params(grads), metrics["total"].item(), grown)
    (want, want_total, _), (got, got_total, launched) = out["cpu"], out[str(cuda_device)]
    assert launched == step
    np.testing.assert_allclose(got_total, want_total, **F32_TOL)
    for k, v in got.items():
        top = float(want[k].abs().max())
        torch.testing.assert_close(v.cpu(), want[k], atol=1e-4 * top, rtol=1e-3, msg=k)
