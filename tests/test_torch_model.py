"""The port's serving slice against the JAX package, end to end on the CPU.

The flagship RouteNet at hs=8 with 2 iterations: one parameter tree (JAX
init, moved across with `params_from_jax`), one batch description built by
each package's own `build_batch`, JAX `apply` against the port's `forward`.
Each stage-2 sum branch is taken in turn by the batch's companion arrays:
block-diagonal and dense incidence, and the CSR forms (kernel A's plain
version on the CPU) once the dense-incidence cap is patched to 0 in both
packages. The attention family (stage 2's aggregation switched to
`attention`) goes through its three branches the same way: dense and
block-diagonal attention over the int8 incidence (kernels D and E's plain
versions on the CPU) and the per-edge form (the JAX package's slot-rate
lowering switched off, so that it takes its per-edge form too).
f32 agrees at atol = rtol = 1e-4."""

import collections
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignnition_tpu.data.graph as j_graph
import ignnition_tpu.model.builder as j_builder
import ignnition_tpu_torch as igt
import ignnition_tpu_torch.data.graph as t_graph
import ignnition_tpu_torch.model.builder as t_builder
from ignnition_tpu.data import SampleSpec as JSampleSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data.synthetic import make_routenet_sample as j_make_sample
from ignnition_tpu.frontend import parse_model_description as j_parse
from ignnition_tpu.model import build as j_build
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data.synthetic import make_routenet_sample

from __graft_entry__ import _flagship
from helpers import qsize_description, routenet_description

torch.set_num_threads(1)

DIMS = {"link_capacity": 1, "traffic": 1}
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16: the port's scan carries h in f32 with bf16-rounded operands (the TPU
# kernel's numerics) while the JAX CPU reference's lax.scan keeps h in bf16,
# so bf16 roundings fall differently; a few bf16 ulps at |pred| < 1
BF16_TOL = dict(atol=3e-2, rtol=3e-2)

# stage-2 branch -> (graphs per batch, dense cap patched to 0, keys dropped)
BRANCHES = {
    "blocks": (2, False, ()),
    "dense": (1, False, ()),
    "csr_sliced": (1, True, ()),
    "csr_direct": (1, True, ("bwd_slice_dst_",)),
    "csr_edges": (1, True, ("bwd_slice_dst_", "dst_in_src_order_")),
}


# attention on stage 2: branch -> (graphs per batch, dense cap patched to 0
# and the JAX slot-rate attention off, keys dropped)
ATTENTION_BRANCHES = {
    "blocks": (4, False, ()),
    "dense": (1, False, ()),
    "edges": (1, True, ()),
}


# Q-size (tests/helpers.qsize_description: link and node states interleaved
# into each path's sequence, stage 2 summing paths into links and nodes) at
# hs=8, 2 iterations: branch -> (graphs per batch, dense cap patched to 0,
# keys dropped). Stage 1 takes the fast interleave through the combined
# slice map, or without `ilv_*` the padded sequences permuted per graph;
# stage 2 the incidence products (dense, blocks over 2 graphs) or the CSR
# sums past the cap.
QSIZE_DIMS = {"link_capacity": 1, "traffic": 1, "queue_sizes": 1}
QSIZE_BRANCHES = {
    "fast": (1, False, ()),
    "fast_2g": (2, False, ()),
    "fast_csr": (1, True, ()),
    "generic": (1, False, ("ilv_",)),
    "generic_2g": (2, False, ("ilv_",)),
    "generic_csr_2g": (2, True, ("ilv_",)),
    # slice sorts in windows of 50 slots (`_SLICE_SORT_CHUNK` in both)
    "fast_windowed_2g": (2, False, (), 50),
}
# stage 1 of Q-size aggregated by concat, ordered or sum instead: variant ->
# (aggregation, keys dropped); concat and ordered through one slice map per
# source, or without the maps through the padded sequences; the sum adds
# each source's incidence product
STAGE1_VARIANTS = {
    "concat1": ({"type": "concat", "concat_axis": 1}, ()),
    "concat1_generic": ({"type": "concat", "concat_axis": 1}, ("slice_src_",)),
    "concat2": ({"type": "concat", "concat_axis": 2}, ()),
    "concat2_generic": ({"type": "concat", "concat_axis": 2}, ("slice_src_",)),
    "ordered": ({"type": "ordered"}, ()),
    "ordered_generic": ({"type": "ordered"}, ("slice_src_",)),
    "sum": ({"type": "sum"}, ()),
}


def qsize_dict(aggregation=None, num_iterations=2, hs=8):
    d = qsize_description(num_iterations=num_iterations, hs=hs)
    if aggregation is not None:
        d["message_passing"]["stages"][0]["stage_mp"][0]["aggregation"] = aggregation
    return d


def sequence_variant(name):
    """(description, branches entry) of a stage-1 variant of Q-size."""
    aggregation, drop = STAGE1_VARIANTS[name]
    return qsize_dict(aggregation), (1, False, drop)


def spy_routes(monkeypatch):
    """Count the builder's calls of each sequence route of the port."""
    import ignnition_tpu_torch.nn.rnn as t_rnn
    import ignnition_tpu_torch.ops.segment as t_seg

    calls = collections.Counter()
    for mod, name in ((t_rnn, "masked_update"), (t_rnn, "masked_update_from_edges"),
                      (t_seg, "gather_state_slices"), (t_seg, "scatter_to_sequences")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return calls


def to_attention(d):
    """`bench._mutate_attention`: stage 2 aggregates by attention."""
    d["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"] = {"type": "attention"}


def patch_branch(monkeypatch, cap0):
    """Past the dense-incidence cap in both packages (their knobs are
    distinct objects), both on the per-edge attention form (slot-rate
    attention off)."""
    if cap0:
        monkeypatch.setattr(j_graph, "_DENSE_INC_MAX_ENTRIES", 0)
        monkeypatch.setattr(t_graph, "_DENSE_INC_MAX_ENTRIES", 0)
        for builder in (j_builder, t_builder):
            monkeypatch.setattr(builder, "_SLOT_ATTN", False)


def flagship_dict(num_iterations=2, hs=8, mutate=None):
    captured = []

    def grab(d):
        if mutate is not None:
            mutate(d)
        captured.append(copy.deepcopy(d))

    _flagship(num_iterations, hs, mutate=grab)
    return captured[0]


def _batches(desc, n_graphs, seed=0, dims=DIMS, with_nodes=False):
    """(JAX ir, port ir, JAX arrays, port arrays, meta) for one merged batch
    of the __graft_entry__._batch shape, built by each package."""
    j_ir = j_parse(copy.deepcopy(desc), dims)
    t_ir = igt.parse_model_description(copy.deepcopy(desc), dims)
    out = []
    for ir, spec_cls, convert, make, build, pad in (
        (j_ir, JSampleSpec, j_convert, j_make_sample, j_build_batch, j_graph.PaddingConfig),
        (t_ir, igt.SampleSpec, igt.convert_sample, make_routenet_sample,
         igt.build_batch, igt.PaddingConfig),
    ):
        rng = np.random.default_rng(seed)
        spec = spec_cls.from_ir(ir)
        samples = [
            convert(make(rng, 32, 24, 6, with_nodes=with_nodes), spec) for _ in range(n_graphs)
        ]
        out.append(build(samples, ir, pad(mode="multiple", multiple=64, min_size=64)))
    (j_arrays, meta), (t_arrays, _) = out
    return j_ir, t_ir, j_arrays, t_arrays, meta


def _port_model(t_ir, j_params):
    model = igt.build(t_ir)
    model.load_params(igt.params_from_jax(j_params))
    return model


def prepared_batches(desc, entry, monkeypatch):
    """`_batches` for a branch entry (graphs per batch, dense cap patched to
    0, keys dropped[, slice-sort window]): the knobs patched and the keys
    deleted in both packages' batches. A description with a `node` entity
    (Q-size) gets graphs with nodes."""
    n_graphs, cap0, drop, *chunk = entry
    patch_branch(monkeypatch, cap0)
    for g in (j_graph, t_graph):
        for c in chunk:
            monkeypatch.setattr(g, "_SLICE_SORT_CHUNK", c)
    qsize = any(e["name"] == "node" for e in desc["entities"])
    out = _batches(desc, n_graphs, dims=QSIZE_DIMS if qsize else DIMS, with_nodes=qsize)
    for arrays in out[2:4]:
        for k in [k for k in arrays if k.startswith(drop)] if drop else []:
            del arrays[k]
    inc = sorted(k for k in out[3] if "inc" in k)
    assert bool(inc) == (not cap0), inc
    return out


def _run_both(desc, branch, monkeypatch, compute_dtype, branches=BRANCHES):
    j_ir, t_ir, j_arrays, t_arrays, meta = prepared_batches(
        desc, branches[branch], monkeypatch
    )
    model = j_build(j_ir)
    j_params = model.init(jax.random.PRNGKey(0))
    want = model.apply(
        j_params, j_arrays, meta,
        compute_dtype=None if compute_dtype is None else jnp.bfloat16,
    )
    got = _port_model(t_ir, j_params)(
        to_device(t_arrays, "cpu"), meta, compute_dtype=compute_dtype
    )
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_flagship_forward_matches_jax_f32(branch, monkeypatch):
    got, want = _run_both(flagship_dict(), branch, monkeypatch, None)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("branch", ["dense", "csr_sliced"])
def test_flagship_forward_matches_jax_bf16(branch, monkeypatch):
    got, want = _run_both(flagship_dict(), branch, monkeypatch, torch.bfloat16)
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("branch", sorted(ATTENTION_BRANCHES))
def test_attention_forward_matches_jax_f32(branch, monkeypatch):
    got, want = _run_both(
        flagship_dict(mutate=to_attention), branch, monkeypatch, None, ATTENTION_BRANCHES
    )
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("branch", sorted(ATTENTION_BRANCHES))
def test_attention_forward_matches_jax_bf16(branch, monkeypatch):
    got, want = _run_both(
        flagship_dict(mutate=to_attention), branch, monkeypatch, torch.bfloat16,
        ATTENTION_BRANCHES,
    )
    np.testing.assert_allclose(got, want, **BF16_TOL)


def qsize_routes(branch_or_variant, iterations=2):
    """The sequence routes a Q-size forward takes at stage 1 (`spy_routes`):
    the combined or per-source slice gathers, or the padded sequences of
    both sources and one padded scan, each iteration."""
    if branch_or_variant.startswith("generic") or branch_or_variant.endswith("_generic"):
        return {"scatter_to_sequences": 2 * iterations, "masked_update": iterations}
    if branch_or_variant == "sum":
        return {}
    if branch_or_variant in STAGE1_VARIANTS:
        return {"gather_state_slices": 2 * iterations}
    return {"gather_state_slices": iterations}


@pytest.mark.parametrize("branch", sorted(QSIZE_BRANCHES))
def test_qsize_forward_matches_jax_f32(branch, monkeypatch):
    calls = spy_routes(monkeypatch)
    got, want = _run_both(qsize_dict(), branch, monkeypatch, None, QSIZE_BRANCHES)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert calls == qsize_routes(branch)


@pytest.mark.parametrize("branch", ["fast", "generic_2g"])
def test_qsize_forward_matches_jax_bf16(branch, monkeypatch):
    got, want = _run_both(qsize_dict(), branch, monkeypatch, torch.bfloat16, QSIZE_BRANCHES)
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("variant", sorted(STAGE1_VARIANTS))
def test_qsize_stage1_variants_forward_matches_jax_f32(variant, monkeypatch):
    """Stage 1 of Q-size by concat on the time axis (1) or the feature axis
    (2, a GRU over 16-wide inputs), by multi-source ordered and by a
    multi-source sum."""
    calls = spy_routes(monkeypatch)
    desc, entry = sequence_variant(variant)
    got, want = _run_both(desc, variant, monkeypatch, None, {variant: entry})
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert calls == qsize_routes(variant)


# the flagship with its stage-1 slice maps deleted: the ordered update reads
# the sorted edge messages (`masked_update_from_edges`)
UNMAPPED = {"dense_unmapped": (1, False, ("slice_src_", "slice_sort_"))}


def test_flagship_ordered_update_without_slice_map_matches_jax(monkeypatch):
    calls = spy_routes(monkeypatch)
    got, want = _run_both(flagship_dict(), "dense_unmapped", monkeypatch, None, UNMAPPED)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert calls == {"masked_update_from_edges": 2}


def test_attention_at_a_width_off_128_takes_the_id_keyed_sum(monkeypatch):
    """hs=48 does not divide 128: the per-edge numerator goes through
    `sorted_segment_sum_ids`, as in the TPU function, and still matches."""
    from ignnition_tpu_torch.ops.cuda import segment_kernels as t_sk

    calls = []
    real = t_sk.sorted_segment_sum_ids_plain
    monkeypatch.setattr(
        t_sk, "sorted_segment_sum_ids_plain", lambda *a: calls.append(a[0].shape) or real(*a)
    )
    got, want = _run_both(
        flagship_dict(hs=48, mutate=to_attention), "edges", monkeypatch, None,
        ATTENTION_BRANCHES,
    )
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert len(calls) == 2 and all(shape[1] == 48 for shape in calls)  # one per iteration


def _wide_path_convolution(d):
    """Stage 2 aggregating 12-wide path states into 8-wide links by the
    convolution, which needs messages of the destination's width."""
    d["message_passing"]["stages"][1]["stage_mp"][0].update(
        aggregation={"type": "convolution", "activation_function": "relu"})
    next(e for e in d["entities"] if e["name"] == "path")["hidden_state_dimension"] = 12


@pytest.mark.parametrize(
    "mutate,error,feature",
    [
        # the convolution is ported: what it refuses names it
        (_wide_path_convolution, ValueError,
         r"convolution aggregation requires message dim \(12\) == destination state dim"),
    ],
    ids=["convolution"],
)
def test_unported_aggregations_raise_by_name(mutate, error, feature):
    desc = flagship_dict(mutate=mutate)
    ir = igt.parse_model_description(copy.deepcopy(desc), DIMS)
    with pytest.raises(error, match=feature):
        igt.build(ir)


STAGE2_LOWERING_KEYS = tuple(
    f"{k}_adj_paths_links" for k in ("row_ptr", "bwd_slice_dst", "dst_in_src_order", "dense_inc")
)


def test_stage2_sum_without_row_pointers_is_the_sorted_sum(monkeypatch):
    """Without row pointers or an incidence matrix stage 2 sums its masked
    edge messages by their sorted destination ids, as the JAX package does
    (`indices_are_sorted=True`): the id-keyed sum, f32 out, no atomics.
    Forward and every gradient leaf against JAX in f32; the bf16 sum comes
    back in f32."""
    from ignnition_tpu.training.trainer import Trainer as JTrainer
    from ignnition_tpu_torch.model.builder import flatten_params
    from ignnition_tpu_torch.ops import segment as t_seg

    j_ir, t_ir, j_arrays, t_arrays, meta = _batches(flagship_dict(), 1)
    for arrays in (j_arrays, t_arrays):
        for k in STAGE2_LOWERING_KEYS:
            del arrays[k]
    sums = []
    real = t_seg.segment_sum

    def spy(data, *args, **kw):
        out = real(data, *args, **kw)
        sums.append((data.dtype, out.dtype, kw.get("indices_are_sorted")))
        return out

    monkeypatch.setattr(t_seg, "segment_sum", spy)
    j_trainer = JTrainer(j_build(j_ir), compute_dtype=None)
    t_trainer = igt.Trainer(igt.build(t_ir), compute_dtype=None, device="cpu")
    j_state = j_trainer.init_state(jax.random.PRNGKey(0))
    params = igt.params_from_jax(j_state.params)
    batch = to_device(t_arrays, "cpu")
    (want_total, _), want_g = jax.value_and_grad(j_trainer._loss, has_aux=True)(
        j_state.params, j_arrays, meta, jax.random.PRNGKey(1)
    )
    got_g, got = t_trainer.grads_fn(meta)(t_trainer.init_state(params=params).params, batch)
    np.testing.assert_allclose(got["total"].item(), float(want_total), **F32_TOL)
    want_flat = {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(want_g)
    }
    got_flat = flatten_params(got_g)
    assert sorted(got_flat) == sorted(want_flat)
    for k, v in got_flat.items():
        np.testing.assert_allclose(v.numpy(), want_flat[k], err_msg=k, **F32_TOL)

    model = _port_model(t_ir, j_state.params)
    want = j_build(j_ir).apply(j_state.params, j_arrays, meta)
    np.testing.assert_allclose(model(batch, meta).numpy(), np.asarray(want), **F32_TOL)
    sums.clear()
    model(batch, meta, compute_dtype=torch.bfloat16)
    assert sums and all(s == (torch.bfloat16, torch.float32, True) for s in sums), sums


def test_routenet_description_forward_matches_jax(monkeypatch):
    got, want = _run_both(routenet_description(), "dense", monkeypatch, None)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_lstm_updates_match_jax(monkeypatch):
    def to_lstm(d):
        for nn_ in d["neural_networks"]:
            if nn_["nn_name"] == "gru":
                nn_["recurrent_type"] = "LSTM"

    got, want = _run_both(flagship_dict(mutate=to_lstm), "dense", monkeypatch, None)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_serving_predict_samples_matches_apply_and_trim():
    desc = flagship_dict()
    j_ir, t_ir, j_arrays, _, meta = _batches(desc, 2)
    model = j_build(j_ir)
    j_params = model.init(jax.random.PRNGKey(1))
    want = np.asarray(model.apply(j_params, j_arrays, meta))
    want = want[j_arrays["node_mask_path"] > 0]

    rng = np.random.default_rng(0)  # the samples _batches made
    spec = igt.SampleSpec.from_ir(t_ir)
    samples = [igt.convert_sample(make_routenet_sample(rng, 32, 24, 6), spec)
               for _ in range(2)]
    server = igt.ServingModel(
        igt.build(t_ir), igt.params_from_jax(j_params), meta, t_ir,
        compute_dtype=None, device="cpu",
    )
    got = server.predict_samples(samples)
    assert got.shape == want.shape == (48,)
    np.testing.assert_allclose(got, want, **F32_TOL)


def with_message_network(d):
    """Stage 1's links send a message network's output over [hs_source,
    hs_dest] (`bench._mutate_mlp_message` on one stage)."""
    d["neural_networks"].append(
        {"nn_name": "msg", "nn_type": "feed_forward",
         "nn_architecture": [{"type_layer": "Dense", "units": 12, "activation": "relu"},
                             {"type_layer": "Dense", "units": 8, "activation": "None"}]})
    d["message_passing"]["stages"][0]["stage_mp"][0]["source_entities"][0]["message"] = [
        {"type": "neural_network", "nn_name": "msg", "input": ["hs_source", "hs_dest"]}]


def test_params_from_jax_keeps_every_key_path():
    """Keys that hold a `/` (`s1/m0` under `aggregation`, `s0/m0/src0/op0`
    under `message`) stay one level, through `params_from_jax`, the module's
    own tree, a compute-dtype cast and the trainer's state and gradients."""
    desc = flagship_dict(mutate=lambda d: (to_attention(d), with_message_network(d)))
    j_ir, t_ir, _, t_arrays, meta = _batches(desc, 1)
    j_params = j_build(j_ir).init(jax.random.PRNGKey(0))

    def paths(tree):
        return [
            tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)
        ]

    def t_paths(tree, prefix=()):
        if isinstance(tree, dict):
            return [p for k, v in tree.items() for p in t_paths(v, prefix + (k,))]
        if isinstance(tree, tuple):
            return [p for i, v in enumerate(tree) for p in t_paths(v, prefix + (i,))]
        return [prefix]

    want = sorted(paths(j_params), key=str)
    assert ("aggregation", "s1/m0", "kernel1") in want
    assert ("message", "s0/m0/src0/op0", "layers", 1, "bias") in want
    t_params = igt.params_from_jax(j_params)
    assert sorted(t_paths(t_params), key=str) == want
    assert list(t_params["aggregation"]) == ["s1/m0"]
    assert list(t_params["message"]) == ["s0/m0/src0/op0"]
    model = igt.build(t_ir)
    model.load_params(t_params)
    assert sorted(t_paths(model.param_tree()), key=str) == want
    for k, v in igt.model.builder.flatten_params(model.param_tree()).items():
        assert torch.equal(v, igt.model.builder.flatten_params(t_params)[k]), k
    trainer = igt.Trainer(igt.build(t_ir), compute_dtype=torch.bfloat16, device="cpu")
    state = trainer.init_state(params=t_params)
    assert sorted(t_paths(state.params), key=str) == want
    assert sorted(t_paths(state.opt_state["mu"]), key=str) == want
    grads, _ = trainer.grads_fn(meta)(state.params, to_device(t_arrays, "cpu"))
    assert sorted(t_paths(grads), key=str) == want
    fresh = igt.build(t_ir).init(torch.Generator().manual_seed(0))
    assert sorted(t_paths(fresh), key=str) == want


def test_attention_init_tree_matches_jax_layout():
    """The three Glorot matrices of an attention pass, under the JAX key."""
    desc = flagship_dict(mutate=to_attention)
    j_ir = j_parse(copy.deepcopy(desc), DIMS)
    t_ir = igt.parse_model_description(copy.deepcopy(desc), DIMS)
    j_params = j_build(j_ir).init(jax.random.PRNGKey(0))
    t_params = igt.build(t_ir).init(torch.Generator().manual_seed(0))
    assert list(t_params["aggregation"]) == list(j_params["aggregation"]) == ["s1/m0"]
    ap = t_params["aggregation"]["s1/m0"]
    assert {k: tuple(v.shape) for k, v in ap.items()} == {
        k: tuple(v.shape) for k, v in j_params["aggregation"]["s1/m0"].items()
    } == {"kernel1": (8, 8), "kernel2": (8, 8), "attn_kernel": (16, 1)}
    for k, v in ap.items():  # Glorot uniform: within the limit, not degenerate
        limit = (6.0 / sum(v.shape)) ** 0.5
        assert float(v.abs().max()) <= limit and float(v.std()) > 0.3 * limit, k
    flat = igt.model.builder.flatten_params(t_params)
    assert list(flat)[:3] == [f"aggregation/s1/m0/{k}" for k in ("kernel1", "kernel2", "attn_kernel")]


def test_init_tree_matches_jax_layout():
    desc = flagship_dict()
    j_ir = j_parse(copy.deepcopy(desc), DIMS)
    t_ir = igt.parse_model_description(copy.deepcopy(desc), DIMS)
    j_params = j_build(j_ir).init(jax.random.PRNGKey(0))
    model = igt.build(t_ir)
    t_params = model.init(torch.Generator().manual_seed(0))
    j_flat = {k: np.shape(v) for k, v in jax.tree_util.tree_leaves_with_path(j_params)}
    t_flat = igt.model.builder.flatten_params(t_params)
    j_paths = {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): shape
        for path, shape in j_flat.items()
    }
    assert {k: tuple(v.shape) for k, v in t_flat.items()} == j_paths
    again = igt.build(t_ir).init(torch.Generator().manual_seed(0))
    other = igt.build(t_ir).init(torch.Generator().manual_seed(1))
    for k, v in t_flat.items():
        assert torch.equal(v, igt.model.builder.flatten_params(again)[k])
    k0 = "update/path_update/kernel"
    assert not torch.equal(t_flat[k0], igt.model.builder.flatten_params(other)[k0])
    w = t_flat["update/path_update/recurrent_kernel"]  # orthogonal [8, 24]
    torch.testing.assert_close(w @ w.T, torch.eye(8), atol=1e-5, rtol=0)
