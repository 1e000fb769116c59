"""Message neural networks in the port against the JAX package, on the CPU.

The mlp_message family (`bench._mutate_mlp_message`: a message network over
[hs_source, hs_dest] on both stages of the flagship) and the message chains
of the JAX side's tests (`test_slice_mlp._mlp_desc` with its named-output
and two-op chains, `edge_params`, source-local chains, attention), at hs=8
with 2 iterations. One parameter tree (JAX init, moved across with
`params_from_jax`) and the same seeded samples go through each package's
own `build_batch`. Each lowering is taken in turn by the batch's companion
arrays and the packages' knobs, patched alike in both:
  * stage 1 (ordered) through the slice map (one slice gather of
    `src_table @ Ksrc`, the network's tail over the [L, n_dst, H] slot
    tensor, then kernel B's scan), and without the map over the per-edge
    messages (`masked_update_from_edges`);
  * stage 2 (sum) at slot rate, and past `IR.SLOT_PAD_CAP` through the
    sorted sum of the per-edge messages, a factored last layer after it;
  * source-local chains under ordered, the dense / block-diagonal / CSR sums
    and dense attention; per-edge attention over message networks; an
    interleave of per-edge messages (Q-size).
The JAX package runs with its defaults and with its scan tail off
(`IGNNITION_TPU_SCAN_TAIL=0`, the whole-tensor tail that the port takes);
the port matches both. f32 agrees at atol = rtol = 1e-4, bf16 at 3e-2; the
helpers and `gather_rows` at 1e-5.
"""

import collections
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignnition_tpu.data.graph as j_graph
import ignnition_tpu.frontend.ir as j_ir
import ignnition_tpu.model.builder as j_builder
import ignnition_tpu_torch as igt
import ignnition_tpu_torch.data.graph as t_graph
import ignnition_tpu_torch.frontend.ir as t_ir
import ignnition_tpu_torch.model.builder as t_builder
from ignnition_tpu.data import SampleSpec as JSampleSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data.synthetic import make_routenet_sample as j_make_sample
from ignnition_tpu.frontend import parse_model_description as j_parse
from ignnition_tpu.model import build as j_build
from ignnition_tpu.nn import mlp as j_mlp
from ignnition_tpu.ops import segment as j_seg
from ignnition_tpu.training.trainer import Trainer as JTrainer
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data.synthetic import make_routenet_sample
from ignnition_tpu_torch.nn import mlp as t_mlp
from ignnition_tpu_torch.ops import segment as t_seg

from bench import _mutate_mlp_message
from helpers import dense
from test_torch_model import BF16_TOL, DIMS, F32_TOL, QSIZE_DIMS, flagship_dict, qsize_dict
from test_torch_train import _check_adam_trajectory, _check_loss_and_gradients

torch.set_num_threads(1)

HELPER_TOL = dict(atol=1e-5, rtol=1e-5)
STAGE1, STAGE2 = "adj_links_paths", "adj_paths_links"


# --------------------------------------------------------------------------
# descriptions
# --------------------------------------------------------------------------


def _msg_nn(reg=0.0):
    """`test_slice_mlp._mlp_desc`'s message network: 12 relu, then 8 linear."""
    return {"nn_name": "msg", "nn_type": "feed_forward",
            "nn_architecture": [dense(12, "relu", reg), dense(8, None, reg)]}


def _chain(inputs=("hs_source", "hs_dest"), extra_op=False, output_name=None):
    """`test_slice_mlp._mlp_desc`'s message chains."""
    msg = {"type": "neural_network", "nn_name": "msg", "input": list(inputs)}
    if output_name:
        msg["output_name"] = output_name
    if extra_op:
        return [dict(msg, output_name="m1"),
                {"type": "neural_network", "nn_name": "msg", "input": ["m1"]}]
    return [msg]


def _with_messages(chain, stages=(0, 1), aggregation2=None, reg=0.0, nns=None):
    """The flagship at hs=8 with `chain` as the message of the given stages;
    stage 2 aggregating by `aggregation2` where given; `nns` in place of the
    message network."""
    def mutate(d):
        d["neural_networks"].extend(nns or [_msg_nn(reg)])
        for si in stages:
            for mp in d["message_passing"]["stages"][si]["stage_mp"]:
                for se in mp["source_entities"]:
                    se["message"] = copy.deepcopy(chain)
        if aggregation2 is not None:
            d["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"] = aggregation2
    return flagship_dict(mutate=mutate)


def _interleave_per_edge():
    """Q-size with its link messages made per edge by the message network:
    the interleave's fast branch needs message tables, so it falls to the
    padded sequences permuted per graph."""
    d = qsize_dict()
    d["neural_networks"].append(_msg_nn())
    mp = d["message_passing"]["stages"][0]["stage_mp"][0]
    assert mp["aggregation"]["type"] == "interleave"
    mp["source_entities"][0]["message"] = _chain()
    return d


def _factor_last_nn(last=None, use_bias=True):
    """`test_factor_last._desc(three_layer=True)`'s network: 12 relu, 10
    tanh, then 8 with the `last` activation."""
    last_layer = dense(8, last)
    if not use_bias:
        last_layer["use_bias"] = False
    return [{"nn_name": "msg", "nn_type": "feed_forward",
             "nn_architecture": [dense(12, "relu"), dense(10, "tanh"), last_layer]}]


# `test_split_first_dense.test_named_output_still_published`: a split-first
# network publishes m1, which a second network reads beside hs_source
NAMED_THEN_CONCAT = [
    {"type": "neural_network", "nn_name": "msg", "input": ["hs_source", "hs_dest"],
     "output_name": "m1"},
    {"type": "neural_network", "nn_name": "msg2", "input": ["m1", "hs_source"]},
]
ATTENTION = {"type": "attention"}
EDGE_PARAMS = ("hs_source", "hs_dest", "edge_params")

# case -> (description, graphs per batch, knobs, keys dropped from both
# batches). Knobs: "cap0" past the dense-incidence cap; "slot" and "slot0"
# the slot cap (`IR.SLOT_PAD_CAP`) raised to 1e9 or set to 0: these small
# graphs of up to 6 hops fill under 3 of their ~5 padded slots per edge, so
# without "slot" stage 2 lies past the cap (the flagship's 16,384 paths of 8
# hops over 2,048 links fill ~2); "params" edge params of width 2 on both
# adjacencies; "win" slice sorts in windows of 50 slots (`_SLICE_SORT_CHUNK`).
# Drops are key prefixes.
UNMAPPED = tuple(f"{k}_{STAGE1}" for k in ("slice_src", "slice_sort_perm", "slice_sort_ids",
                                            "slice_sort_row_ptr"))
CASES = {
    # the mlp_message family: stage 1 on the slot route, stage 2 the slot-rate sum
    "mlp_message": (lambda: flagship_dict(mutate=_mutate_mlp_message), 1, ("slot",), ()),
    "mlp_message_2g": (lambda: flagship_dict(mutate=_mutate_mlp_message), 2, ("slot",), ()),
    "mlp_message_windowed": (lambda: flagship_dict(mutate=_mutate_mlp_message), 1,
                             ("slot", "win"), ()),
    # stage 1 without its slice map: masked_update_from_edges
    "mlp_message_unmapped": (lambda: flagship_dict(mutate=_mutate_mlp_message), 1,
                             ("slot",), UNMAPPED),
    # stage 2 past the slot cap: the sorted sum of the prefixes, then `post`
    "mlp_message_past_cap": (lambda: flagship_dict(mutate=_mutate_mlp_message), 1,
                             ("slot0",), ()),
    "mlp_message_past_cap_no_row_ptr": (lambda: flagship_dict(mutate=_mutate_mlp_message), 1,
                                        ("slot0",), (f"row_ptr_{STAGE2}",)),
    "hs_dest_only": (lambda: _with_messages(_chain(("hs_dest",))), 1, ("slot",), ()),
    # source-local chains: message tables on every table lowering
    "source_local_dense": (lambda: _with_messages(_chain(("hs_source",))), 1, (), ()),
    "source_local_twice_blocks": (lambda: _with_messages(_chain(("hs_source", "hs_source"))),
                                  2, (), ()),
    "source_local_csr": (lambda: _with_messages(_chain(("hs_source",))), 1, ("cap0",), ()),
    "source_local_csr_direct": (lambda: _with_messages(_chain(("hs_source",))), 1, ("cap0",),
                                (f"bwd_slice_dst_{STAGE2}",)),
    "source_local_attention_dense": (
        lambda: _with_messages(_chain(("hs_source",)), aggregation2=ATTENTION), 1, (), ()),
    "source_local_attention_per_edge": (
        lambda: _with_messages(_chain(("hs_source",)), aggregation2=ATTENTION), 1, ("cap0",),
        ()),
    # factor last past the slot cap: a three-layer network, a last layer
    # without bias, and a nonlinear last layer that is not factored
    "factor_last_three_layer": (
        lambda: _with_messages(_chain(), stages=(1,), nns=_factor_last_nn()), 1, ("slot0",),
        ()),
    "factor_last_no_bias": (
        lambda: _with_messages(_chain(), stages=(1,), nns=_factor_last_nn(use_bias=False)), 1,
        ("slot0",), ()),
    "nonlinear_last": (
        lambda: _with_messages(_chain(), stages=(1,), nns=_factor_last_nn("tanh")), 1,
        ("slot0",), ()),
    # published outputs: per-edge layouts (split first, and a two-op chain)
    "named_output_then_concat": (
        lambda: _with_messages(NAMED_THEN_CONCAT, stages=(0,),
                               nns=[_msg_nn(), dict(_msg_nn(), nn_name="msg2")]), 1, (), ()),
    "output_name": (lambda: _with_messages(_chain(output_name="mvar")), 1, (), ()),
    "extra_op": (lambda: _with_messages(_chain(extra_op=True)), 1, (), ()),
    # edge params: in the slot layout (`params_slice_*`) on both stages
    "edge_params": (lambda: _with_messages(_chain(EDGE_PARAMS)), 1, ("params", "slot"), ()),
    "edge_params_past_cap": (lambda: _with_messages(_chain(EDGE_PARAMS)), 1,
                             ("params", "slot0"), ()),
    # per-edge attention over a message network's messages
    "attention_per_edge": (lambda: _with_messages(_chain(), aggregation2=ATTENTION), 1, (), ()),
    # an interleave of per-edge messages
    "interleave_per_edge": (_interleave_per_edge, 1, (), ()),
}


def _with_edge_params(sample, rng, width=2):
    """The sample with `width` random parameters on every edge of both
    adjacencies (the reference's [[node, params], ...] lists)."""
    out = dict(sample)
    for key in (STAGE1, STAGE2):
        out[key] = {d: [[s, rng.uniform(0.0, 1.0, width).tolist()] for s in srcs]
                    for d, srcs in sample[key].items()}
    return out


def case_batches(name, monkeypatch):
    """(JAX ir, port ir, JAX arrays, port arrays, meta) of a case, with its
    knobs patched in both packages."""
    make_desc, n_graphs, knobs, drop = CASES[name]
    desc = make_desc()
    for g in (j_graph, t_graph):
        if "cap0" in knobs:
            monkeypatch.setattr(g, "_DENSE_INC_MAX_ENTRIES", 0)
        if "win" in knobs:
            monkeypatch.setattr(g, "_SLICE_SORT_CHUNK", 50)
    for knob, cap in (("slot", 1e9), ("slot0", 0.0)):
        if knob in knobs:
            for mod in (j_ir, t_ir):
                monkeypatch.setattr(mod, "SLOT_PAD_CAP", cap)
    # these cases hold the per-edge attention form: slot-rate attention off
    # in both packages (`test_torch_surface.py` holds it on)
    for builder in (j_builder, t_builder):
        monkeypatch.setattr(builder, "_SLOT_ATTN", False)
    qsize = any(e["name"] == "node" for e in desc["entities"])
    dims = dict(QSIZE_DIMS if qsize else DIMS)
    if "params" in knobs:
        dims.update({STAGE1: 2, STAGE2: 2})
    irs = (j_parse(copy.deepcopy(desc), dict(dims)),
           igt.parse_model_description(copy.deepcopy(desc), dict(dims)))
    out = []
    for ir, spec_cls, convert, make, build, pad in (
        (irs[0], JSampleSpec, j_convert, j_make_sample, j_build_batch, j_graph.PaddingConfig),
        (irs[1], igt.SampleSpec, igt.convert_sample, make_routenet_sample, igt.build_batch,
         igt.PaddingConfig),
    ):
        rng = np.random.default_rng(0)
        spec = spec_cls.from_ir(ir)
        samples = []
        for _ in range(n_graphs):
            raw = make(rng, 32, 24, 6, with_nodes=qsize)
            if "params" in knobs:
                raw = _with_edge_params(raw, rng)
            samples.append(convert(raw, spec))
        arrays, meta = build(samples, ir, pad(mode="multiple", multiple=64, min_size=64))
        for k in [k for k in arrays if drop and k.startswith(drop)]:
            del arrays[k]
        out.append((arrays, meta))
    (j_arrays, meta), (t_arrays, _) = out
    assert sorted(j_arrays) == sorted(t_arrays)
    return irs[0], irs[1], j_arrays, t_arrays, meta


def _port_model(t_ir_, j_params):
    model = igt.build(t_ir_)
    model.load_params(igt.params_from_jax(j_params))
    return model


def _jax_forward(j_ir_, j_params, j_arrays, meta, compute_dtype, scan_tail, monkeypatch):
    monkeypatch.setattr(j_builder, "_SCAN_TAIL", scan_tail)
    want = j_build(j_ir_).apply(
        j_params, j_arrays, meta,
        compute_dtype=None if compute_dtype is None else jnp.bfloat16,
    )
    return np.asarray(want)


# the cases whose stage 1 runs a per-edge network on the slot route, the
# lowering that the JAX package's scan tail changes
SCAN_TAIL_CASES = {"mlp_message", "mlp_message_2g", "mlp_message_windowed", "mlp_message_past_cap",
                   "mlp_message_past_cap_no_row_ptr", "hs_dest_only", "edge_params",
                   "edge_params_past_cap", "attention_per_edge"}


def _forward_both(name, monkeypatch, compute_dtype):
    """The port's predictions and the JAX package's, with the scan tail on
    (its default) and, where it changes the lowering, off."""
    j_ir_, t_ir_, j_arrays, t_arrays, meta = case_batches(name, monkeypatch)
    j_params = j_build(j_ir_).init(jax.random.PRNGKey(0))
    got = _port_model(t_ir_, j_params)(
        to_device(t_arrays, "cpu"), meta, compute_dtype=compute_dtype
    )
    assert got.dtype == torch.float32
    wants = [_jax_forward(j_ir_, j_params, j_arrays, meta, compute_dtype, tail, monkeypatch)
             for tail in ((True, False) if name in SCAN_TAIL_CASES else (True,))]
    assert got.shape == wants[0].shape
    return got.numpy(), wants


@pytest.mark.parametrize("name", sorted(CASES))
def test_message_forward_matches_jax_f32(name, monkeypatch):
    got, wants = _forward_both(name, monkeypatch, None)
    for want, tail in zip(wants, ("scan tail on", "scan tail off")):
        np.testing.assert_allclose(got, want, err_msg=tail, **F32_TOL)


BF16_CASES = ["mlp_message", "mlp_message_past_cap", "edge_params", "attention_per_edge",
              "interleave_per_edge", "source_local_dense"]


@pytest.mark.parametrize("name", BF16_CASES)
def test_message_forward_matches_jax_bf16(name, monkeypatch):
    got, wants = _forward_both(name, monkeypatch, torch.bfloat16)
    for want, tail in zip(wants, ("scan tail on", "scan tail off")):
        np.testing.assert_allclose(got, want, err_msg=tail, **BF16_TOL)


# --------------------------------------------------------------------------
# which lowering each stage takes
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


ROUTES = {
    # per iteration: stage 1's and stage 2's slice gathers, one scan; stage 2
    # one cell step; no per-edge message is made
    "mlp_message": {"gather_state_slices": 4, "masked_gru_scan": 2, "_gru_step": 2},
    "mlp_message_unmapped": {"gather_state_slices": 2, "masked_update_from_edges": 2,
                             "gather_rows": 2, "gather_by_dst": 2, "masked_gru_scan": 2,
                             "_gru_step": 2},
    "mlp_message_past_cap": {"gather_state_slices": 2, "gather_rows": 2, "gather_by_dst": 2,
                             "segment_sum": 2, "masked_gru_scan": 2, "_gru_step": 2},
    # the links' per-edge network and the nodes' state table each gather
    # their source rows by `gather_rows` (its backward kernel A)
    "interleave_per_edge": {"gather_rows": 4, "gather_by_dst": 2, "scatter_to_sequences": 4,
                            "masked_gru_scan": 2, "_gru_step": 4},
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_message_routes(name, monkeypatch):
    """With a GRU the ordered stage runs `masked_gru_scan` (kernel B on the
    card) and never the step loop: `_gru_step` runs only for stage 2's cell
    steps (twice per iteration in Q-size, links and nodes). The JAX package
    takes the same lowering per stage."""
    import ignnition_tpu_torch.nn.rnn as t_rnn

    j_ir_, t_ir_, j_arrays, t_arrays, meta = case_batches(name, monkeypatch)
    calls = _spy(monkeypatch, [
        (t_seg, "gather_state_slices"), (t_seg, "gather_rows"), (t_seg, "gather_by_dst"),
        (t_seg, "segment_sum"), (t_seg, "scatter_to_sequences"),
        (t_rnn, "masked_update_from_edges"), (t_rnn, "masked_gru_scan"), (t_rnn, "_gru_step"),
    ])
    j_params = j_build(j_ir_).init(jax.random.PRNGKey(0))
    _port_model(t_ir_, j_params)(to_device(t_arrays, "cpu"), meta)
    assert dict(calls) == ROUTES[name]

    # the JAX package takes the same lowering: the same slice gathers, sums
    # and sequence routes (its un-jitted forward also makes the per-edge
    # messages that jit would drop, so per-edge gathers are not compared)
    import ignnition_tpu.nn.rnn as j_rnn

    lowering = ("gather_state_slices", "segment_sum", "scatter_to_sequences",
                "masked_update_from_edges")
    j_calls = _spy(monkeypatch, [(j_seg, n) for n in lowering[:3]] + [(j_rnn, lowering[3])])
    j_build(j_ir_).apply(j_params, j_arrays, meta)
    assert {k: v for k, v in j_calls.items() if v} == {
        k: v for k, v in ROUTES[name].items() if k in lowering}


def test_mlp_message_step_sums_both_slot_maps(monkeypatch):
    """A training step's kernel-A calls on the slot routes (their plain
    versions here): stage 1's slice gather transposes at every iteration,
    since `Ksrc` needs its gradient even where the link states (iteration
    1's) need none; stage 2's but for the last iteration, whose link states
    reach no prediction. No other sum runs, forward or backward."""
    j_ir_, t_ir_, _, t_arrays, meta = case_batches("mlp_message", monkeypatch)
    calls = _spy(monkeypatch, [(t_seg, "sorted_segment_sum_csr_windows"),
                               (t_seg, "sorted_segment_sum_csr"),
                               (t_seg, "sorted_segment_sum_ids")])
    trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    trainer.grads_fn(meta)(state.params, to_device(t_arrays, "cpu"))
    assert dict(calls) == {"sorted_segment_sum_csr_windows": 2 * t_ir_.num_iterations - 1}


def test_inference_mode_forward_with_windowed_slice_sorts(monkeypatch):
    """A forward that records no graph reads the slice maps by a plain
    gather, also with the sort companions of several windows, on a batch
    made inside `torch.inference_mode` (whose tensors keep no version)."""
    j_ir_, t_ir_, _, t_arrays, meta = case_batches("mlp_message_windowed", monkeypatch)
    assert (t_arrays[f"slice_sort_row_ptr_{STAGE2}"].shape[0] - 1) // meta.nodes("path") > 1
    model = _port_model(t_ir_, j_build(j_ir_).init(jax.random.PRNGKey(0)))
    want = model(to_device(t_arrays, "cpu"), meta)
    with torch.inference_mode():
        got = model(to_device(t_arrays, "cpu"), meta)
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


# --------------------------------------------------------------------------
# nn/mlp helpers and gather_rows
# --------------------------------------------------------------------------


@pytest.mark.parametrize("last", [None, "tanh"])
def test_mlp_helpers_match_jax(last):
    """The split-first and factor-last helpers of `nn/mlp.py` on a 3-D
    [L, N, H] tensor and on a 2-D one, against the JAX functions."""
    rng = np.random.default_rng(3)
    nn = {"nn_name": "m", "nn_type": "feed_forward",
          "nn_architecture": [dense(12, "relu"), dense(6, "selu"), dense(8, last)]}
    chain = [{"type": "neural_network", "nn_name": "m", "input": ["hs_source", "hs_dest"]}]

    def mutate(d):
        d["neural_networks"].append(nn)
        d["message_passing"]["stages"][0]["stage_mp"][0]["source_entities"][0]["message"] = chain

    desc = flagship_dict(mutate=mutate)
    j_spec = j_parse(copy.deepcopy(desc), DIMS).stages[0].passes[0].sources[0].ops[0].mlp
    t_spec = igt.parse_model_description(copy.deepcopy(desc), DIMS).stages[0].passes[0] \
        .sources[0].ops[0].mlp
    j_params, out = j_mlp.init(jax.random.PRNGKey(1), j_spec, 16)
    assert out == t_mlp.output_dim(t_spec, 16) == j_mlp.output_dim(j_spec, 16) == 8
    t_params = igt.params_from_jax(j_params)
    assert t_mlp.can_split_first(t_spec) == j_mlp.can_split_first(j_spec) is True
    assert t_mlp.can_factor_last(t_spec) == j_mlp.can_factor_last(j_spec) == (last is None)
    for shape in ((5, 7, 12), (9, 12)):
        pre = rng.standard_normal(shape).astype(np.float32)
        x = rng.standard_normal(shape[:-1] + (16,)).astype(np.float32)
        for fn, arg in (("apply_from_first_preact", pre), ("prefix_from_first_preact", pre),
                        ("apply_prefix", x), ("apply", x)):
            got = getattr(t_mlp, fn)(t_spec, t_params, torch.from_numpy(arg))
            want = getattr(j_mlp, fn)(j_spec, j_params, jnp.asarray(arg))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=fn, **HELPER_TOL)
    (tk, tb), (jk, jb) = t_mlp.last_dense(t_spec, t_params), j_mlp.last_dense(j_spec, j_params)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("width", [8, 12])
def test_gather_rows_matches_jax(width, monkeypatch):
    """`gather_rows` with the source sort of a real batch: forward, and the
    backward (the sorted segment sum: kernel A's plain version at width 8,
    the id-keyed sum's at 12) against `jax.vjp` of the JAX function; and
    without the sort, a plain index."""
    _, _, j_arrays, t_arrays, meta = case_batches("mlp_message", monkeypatch)
    t = to_device(t_arrays, "cpu")
    a = STAGE2
    rng = np.random.default_rng(width)
    n = meta.nodes("path")
    states = rng.standard_normal((n, width)).astype(np.float32)
    # padding edges carry no cotangent (their messages are masked upstream)
    ct = rng.standard_normal((j_arrays[f"src_{a}"].shape[0], width)).astype(np.float32)
    ct *= j_arrays[f"edge_mask_{a}"][:, None]
    args = [j_arrays[f"{k}_{a}"] for k in ("src", "src_perm", "src_row_ptr")]
    want, vjp = jax.vjp(lambda s: j_seg.gather_rows(s, *args[:1], perm=args[1],
                                                    row_ptr=args[2]), jnp.asarray(states))
    (want_ct,) = vjp(jnp.asarray(ct))
    x = torch.from_numpy(states).requires_grad_(True)
    got = t_seg.gather_rows(x, t[f"src_{a}"], t[f"src_perm_{a}"], t[f"src_row_ptr_{a}"])
    (got_ct,) = torch.autograd.grad(got, x, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **HELPER_TOL)
    np.testing.assert_allclose(got_ct.numpy(), np.asarray(want_ct), **HELPER_TOL)
    plain = t_seg.gather_rows(torch.from_numpy(states), t[f"src_{a}"])
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# the slice as a whole: loss, reg, gradients, Adam trajectory
# --------------------------------------------------------------------------

# the mlp_message family on its three stage branches, and the message
# network with an l2 penalty (edge params, both stages at slot rate)
TRAIN_CASES = ["mlp_message", "mlp_message_windowed", "mlp_message_unmapped",
               "mlp_message_past_cap", "edge_params_regularized"]
CASES["edge_params_regularized"] = (
    lambda: _with_messages(_chain(EDGE_PARAMS), reg=0.01), 1, ("params", "slot"), ())


def _trainers(name, monkeypatch):
    j_ir_, t_ir_, j_arrays, t_arrays, meta = case_batches(name, monkeypatch)
    j_trainer = JTrainer(j_build(j_ir_), compute_dtype=None)
    t_trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
    j_state = j_trainer.init_state(jax.random.PRNGKey(0))
    t_state = t_trainer.init_state(params=igt.params_from_jax(j_state.params))
    return j_trainer, t_trainer, j_state, t_state, j_arrays, to_device(t_arrays, "cpu"), meta


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_message_loss_and_gradients_match_jax(name, monkeypatch):
    got = _check_loss_and_gradients(_trainers(name, monkeypatch))
    assert any(k.startswith("message/s0/m0/src0/op0/layers/0/kernel") for k in got)


@pytest.mark.parametrize("name", ["mlp_message", "mlp_message_past_cap",
                                  "edge_params_regularized"])
def test_message_adam_trajectory_matches_jax(name, monkeypatch):
    _check_adam_trajectory(_trainers(name, monkeypatch))


def test_message_regularization_matches_jax(monkeypatch):
    """The message networks' l2 joins the readout's, as in the JAX package."""
    j_ir_, t_ir_, *_ = case_batches("edge_params_regularized", monkeypatch)
    j_model = j_build(j_ir_)
    j_params = j_model.init(jax.random.PRNGKey(0))
    got = igt.build(t_ir_).regularization_loss(igt.params_from_jax(j_params))
    want = j_model.regularization_loss(j_params)
    readout_only = sum(
        float(j_mlp.l2_loss(op.mlp, j_params["readout"][f"op{i}"]))
        for i, op in enumerate(j_ir_.readout))
    assert float(want) > readout_only
    np.testing.assert_allclose(got.item(), float(want), **F32_TOL)


# --------------------------------------------------------------------------
# building and parameters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mlp_message", "source_local_dense", "extra_op",
                                  "named_output_then_concat", "factor_last_no_bias",
                                  "edge_params_regularized", "interleave_per_edge"])
def test_init_tree_matches_jax_layout(name, monkeypatch):
    """`init` draws every message network under the JAX key, in the JAX
    tree, and `params_from_jax` carries the `message` subtree letter for
    letter."""
    make_desc, _, knobs, _ = CASES[name]
    desc = make_desc()
    qsize = any(e["name"] == "node" for e in desc["entities"])
    dims = dict(QSIZE_DIMS if qsize else DIMS, **({STAGE1: 2, STAGE2: 2} if "params" in knobs
                                                  else {}))
    j_params = j_build(j_parse(copy.deepcopy(desc), dict(dims))).init(jax.random.PRNGKey(0))
    t_params = igt.build(igt.parse_model_description(copy.deepcopy(desc), dict(dims))).init(
        torch.Generator().manual_seed(0))
    assert t_params["message"]
    assert list(t_params["message"]) == list(j_params["message"])
    assert list(igt.params_from_jax(j_params)["message"]) == list(j_params["message"])
    j_flat = {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.shape(v)
        for path, v in jax.tree_util.tree_leaves_with_path(j_params)
    }
    t_flat = igt.model.builder.flatten_params(t_params)
    assert {k: tuple(v.shape) for k, v in t_flat.items()} == j_flat


# --------------------------------------------------------------------------
# the kernel path against the plain path, on a CUDA device (phase 7 of
# chip_smoke.py at a small size)
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())


def _launches():
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    return dict(a=sk.launch_count, windows=sk.windows_launch_count, ids=sk.ids_launch_count,
                b=rk.launch_count, c=rk.bwd_launch_count)


def _grown(before):
    return {k: v - before[k] for k, v in _launches().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(None, F32_TOL), (torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_mlp_message_forward_kernels_match_plain_on_cuda(cuda_device, dtype, tol, monkeypatch):
    """The mlp_message forward on the card (kernel B once per iteration,
    nothing else of the port's) against the same model on the CPU."""
    j_ir_, t_ir_, _, t_arrays, meta = case_batches("mlp_message", monkeypatch)
    params = igt.build(t_ir_).init(torch.Generator().manual_seed(0))
    cpu, card = igt.build(t_ir_), igt.build(t_ir_)
    cpu.load_params(params)
    card.load_params(params, device=cuda_device)
    with torch.inference_mode():
        want = cpu(to_device(t_arrays, "cpu"), meta, compute_dtype=dtype)
        before = _launches()
        got = card(to_device(t_arrays, cuda_device), meta, compute_dtype=dtype)
        torch.cuda.synchronize()
    assert _grown(before) == dict(a=0, windows=0, ids=0, b=t_ir_.num_iterations, c=0)
    mask = torch.from_numpy(t_arrays["node_mask_path"] > 0)
    torch.testing.assert_close(got.cpu()[mask], want[mask], **tol)


@pytest.mark.cuda
def test_mlp_message_gradients_match_plain_on_cuda(cuda_device, monkeypatch):
    """Step-0 loss and gradients in f32 on the card (B and C once per
    iteration, A as both slot maps' backward: `2 * iterations - 1`) against
    the CPU, each leaf within 1e-4 of its largest entry."""
    from ignnition_tpu_torch.model.builder import flatten_params, map_params

    _, t_ir_, _, t_arrays, meta = case_batches("mlp_message", monkeypatch)
    params = igt.build(t_ir_).init(torch.Generator().manual_seed(0))
    out = {}
    for device in ("cpu", cuda_device):
        trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device=device)
        state = trainer.init_state(params=map_params(lambda v: v.clone(), params))
        before = _launches()
        grads, metrics = trainer.grads_fn(meta)(state.params, to_device(t_arrays, device))
        out[str(device)] = (flatten_params(grads), metrics["total"].item(), _grown(before))
    (want, want_total, _), (got, got_total, launched) = out["cpu"], out[str(cuda_device)]
    iters = t_ir_.num_iterations
    assert launched == dict(a=2 * iters - 1, windows=0, ids=0, b=iters, c=iters)
    np.testing.assert_allclose(got_total, want_total, **F32_TOL)
    for k, v in got.items():
        top = float(want[k].abs().max())
        torch.testing.assert_close(v.cpu(), want[k], atol=1e-4 * top, rtol=1e-3, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slot_map_backward_kernel_matches_plain_on_cuda(cuda_device, dtype, monkeypatch):
    """Kernel A over stage 2's slot-map sort (invalid slots all on the last
    path row) against its plain version, one launch a call, bitwise
    repeatable; small integers keep the f32 sums exact in any order."""
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    _, _, _, t_arrays, meta = case_batches("mlp_message", monkeypatch)
    t = to_device(t_arrays, cuda_device)
    n_src = meta.nodes("path")
    rp = t[f"slice_sort_row_ptr_{STAGE2}"]
    windows = (rp.shape[0] - 1) // n_src
    perm = t[f"slice_sort_perm_{STAGE2}"]
    if windows > 1:
        perm = t_seg._whole_sort_perm(perm, windows)
    rng = np.random.default_rng(5)
    ct = torch.from_numpy(rng.integers(-4, 5, size=(perm.shape[0], 32)).astype(np.float32))
    sorted_ct = ct.to(cuda_device, dtype)[perm]
    before = _launches()
    got = [sk.sorted_segment_sum_csr_windows(sorted_ct, rp, n_src) for _ in range(2)]
    torch.cuda.synchronize()
    assert _grown(before)["a"] == 2
    assert torch.equal(got[0], got[1])
    want = sk.sorted_segment_sum_csr_windows_plain(sorted_ct, rp, n_src)
    torch.testing.assert_close(got[0], want, atol=1e-4, rtol=1e-5)
