"""The rest of the description language in the port against the JAX package,
on the CPU: every built-in layer kind, the random layers in training mode,
`register_layer`, `segment_softmax`, both attention softmax modes on every
per-edge route (one source with and without row pointers, two sources, a
merged batch of 3 graphs), every optimizer, and the training-mode rules
(the readout draws from the trainer's generator, message networks stay
deterministic, BatchNormalization's moving statistics move under AdamW
only).

The same numpy inputs from a seed go through the JAX function and the
port's. The random layers are held through the port's mask-taking
functions: the JAX output with a fixed key gives back its keep mask or its
noise, which the port's function takes. Small sizes: hs 8, 2 iterations.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ignnition_tpu.model.builder as j_builder
import ignnition_tpu.nn.layers as j_layers
import ignnition_tpu_torch as igt
import ignnition_tpu_torch.model.builder as t_builder
import ignnition_tpu_torch.nn.layers as t_layers
from ignnition_tpu.data import SampleSpec as JSampleSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data.synthetic import make_routenet_sample as j_make_sample
from ignnition_tpu.frontend import ir as j_ir_mod
from ignnition_tpu.frontend import parse_model_description as j_parse
from ignnition_tpu.frontend import parser as j_parser
from ignnition_tpu.frontend.ir import OptimizerSpec as JOptimizerSpec
from ignnition_tpu.frontend.ir import ScheduleSpec as JScheduleSpec
from ignnition_tpu.model import build as j_build
from ignnition_tpu.nn import mlp as j_mlp
from ignnition_tpu.ops import segment as j_seg
from ignnition_tpu.training import optimizers as j_opt
from ignnition_tpu.training.trainer import Trainer as JTrainer
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data.synthetic import make_routenet_sample
from ignnition_tpu_torch.frontend import ir as t_ir_mod
from ignnition_tpu_torch.frontend import parser as t_parser
from ignnition_tpu_torch.frontend.ir import OptimizerSpec, ScheduleSpec
from ignnition_tpu_torch.model.builder import flatten_params
from ignnition_tpu_torch.nn import mlp as t_mlp
from ignnition_tpu_torch.ops import segment as t_seg
from ignnition_tpu_torch.training import optimizers as t_opt

from test_torch_model import DIMS, flagship_dict, prepared_batches, qsize_dict, to_attention
from test_torch_train import _check_adam_trajectory, _check_loss_and_gradients, _jax_flat

torch.set_num_threads(1)

LAYER_TOL = dict(atol=1e-6, rtol=1e-6)
SLICE_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# the layers, one by one
# --------------------------------------------------------------------------

LAYERS = {
    "dense_selu": {"type_layer": "Dense", "units": 4, "activation": "selu"},
    "dense_no_bias": {"type_layer": "Dense", "units": 3, "use_bias": False},
    "activation": {"type_layer": "Activation", "activation": "tanh"},
    "dropout": {"type_layer": "Dropout", "rate": 0.3},
    "layer_norm": {"type_layer": "LayerNormalization"},
    "layer_norm_eps_no_center": {"type_layer": "LayerNormalization", "epsilon": 0.1,
                                 "center": False},
    "layer_norm_no_scale": {"type_layer": "LayerNormalization", "scale": False},
    "batch_norm": {"type_layer": "BatchNormalization"},
    "batch_norm_eps_no_scale": {"type_layer": "BatchNormalization", "epsilon": 0.01,
                                "scale": False},
    "leaky_relu": {"type_layer": "LeakyReLU"},
    "leaky_relu_alpha": {"type_layer": "LeakyReLU", "alpha": 0.05},
    "relu": {"type_layer": "ReLU"},
    "relu_options": {"type_layer": "ReLU", "negative_slope": 0.1, "threshold": 0.2,
                     "max_value": 0.9},
    "elu": {"type_layer": "ELU"},
    "elu_alpha": {"type_layer": "ELU", "alpha": 0.5},
    "prelu": {"type_layer": "PReLU"},
    "softmax": {"type_layer": "Softmax"},
    "softmax_axis0": {"type_layer": "Softmax", "axis": 0},
    "gaussian_noise": {"type_layer": "GaussianNoise", "stddev": 0.3},
    "alpha_dropout": {"type_layer": "AlphaDropout", "rate": 0.2},
}


def _layer_pair(layer: dict, in_dim: int = 5, seed: int = 0):
    """(JAX spec, port spec, JAX params, port params) of a network of one
    layer; parameters drawn by the JAX init, then every leaf set to seeded
    values (a PReLU slope, normalization scales and moving statistics that
    are not their initial constants)."""
    j_spec = j_ir_mod.MLPSpec(name="net", layers=(j_parser._parse_layer(layer, 0, "t"),))
    t_spec = t_ir_mod.MLPSpec(name="net", layers=(t_parser._parse_layer(layer, 0, "t"),))
    params, _ = j_mlp.init(jax.random.PRNGKey(seed), j_spec, in_dim)
    rng = np.random.default_rng(seed)

    def fill(path, v):
        name = str(path[-1].key)
        a = rng.standard_normal(v.shape).astype(np.float32)
        if name == "moving_variance":
            a = np.abs(a) + 0.5
        return jnp.asarray(a)

    params = jax.tree_util.tree_map_with_path(fill, params)
    return j_spec, t_spec, params, igt.params_from_jax(params)


def _grads_both(j_fn, t_fn, x, j_params, t_params, ct):
    """Output and gradients (input and every parameter leaf) of both."""
    want, vjp = jax.vjp(j_fn, jnp.asarray(x), j_params)
    want_dx, want_dp = vjp(jnp.asarray(ct))
    tx = _t(x).requires_grad_(True)
    leaves = list(flatten_params(t_params).values())
    for v in leaves:
        v.requires_grad_(True)
    got = t_fn(tx, t_params)
    grads = torch.autograd.grad(got, [tx] + leaves, _t(ct), allow_unused=True,
                                materialize_grads=True)
    return got, np.asarray(want), grads, np.asarray(want_dx), _jax_flat(want_dp)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_each_layer_matches_jax_deterministic(name):
    j_spec, t_spec, jp, tp = _layer_pair(LAYERS[name])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    j_fn = lambda x, p: j_mlp._apply_layers(j_spec.layers, p["layers"], x)
    t_fn = lambda x, p: t_mlp._apply_layers(t_spec, t_spec.layers, p["layers"], x)
    ct = rng.standard_normal(np.asarray(j_fn(x, jp)).shape).astype(np.float32)
    got, want, grads, want_dx, want_dp = _grads_both(j_fn, t_fn, x, jp, tp, ct)
    np.testing.assert_allclose(got.detach().numpy(), want, **LAYER_TOL)
    np.testing.assert_allclose(grads[0].numpy(), want_dx, **LAYER_TOL)
    names = list(flatten_params(tp))
    assert sorted(names) == sorted(want_dp)
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), want_dp[k], err_msg=k, **LAYER_TOL)
    if name.startswith("batch_norm"):
        # the moving statistics are not trained: zero gradients in both
        for k in names:
            if "moving" in k:
                assert not want_dp[k].any() and not grads[1 + names.index(k)].any()


def test_init_tree_matches_jax_for_every_kind():
    """Each kind's parameter leaves and their initial values (width-
    preserving kinds `{}`; PReLU's alpha zeros; the normalizations' gamma /
    beta under their flags; BatchNormalization's moving statistics)."""
    layers = [{"type_layer": "Dense", "units": 6}] + [
        v for k, v in sorted(LAYERS.items()) if not k.startswith("dense")]
    j_spec = j_ir_mod.MLPSpec("net", tuple(j_parser._parse_layer(l, i, "t")
                                           for i, l in enumerate(layers)))
    t_spec = t_ir_mod.MLPSpec("net", tuple(t_parser._parse_layer(l, i, "t")
                                           for i, l in enumerate(layers)))
    jp, j_dim = j_mlp.init(jax.random.PRNGKey(0), j_spec, 3)
    tp, t_dim = t_mlp.init(torch.Generator().manual_seed(0), t_spec, 3)
    assert j_dim == t_dim == 6 == t_mlp.output_dim(t_spec, 3)
    want = _jax_flat(jp)
    got = flatten_params(tp)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and tuple(v.shape) == want[k].shape, k
        if "kernel" not in k:
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


# --------------------------------------------------------------------------
# the random layers in training mode
# --------------------------------------------------------------------------

RANDOM_LAYERS = ["dropout", "alpha_dropout", "gaussian_noise"]


def _alpha_dropped_value(rate):
    """AlphaDropout's value at a dropped entry, as the JAX package rounds it
    in f32: a * alpha' + b."""
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = ((1.0 - rate) * (1.0 + rate * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * rate
    return np.float32(np.float32(a) * np.float32(alpha_p)) + np.float32(b)


@pytest.mark.parametrize("name", RANDOM_LAYERS)
def test_random_layer_in_training_matches_jax_given_its_mask(name):
    """JAX with a fixed key; its keep mask or noise recovered from its output
    (on a nowhere-zero input) and fed to the port's mask-taking function:
    output and input gradient at 1e-6."""
    layer = LAYERS[name]
    j_spec, _, jp, _ = _layer_pair(layer)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 5)).astype(np.float32)
    x = np.where(np.abs(x) < 1e-3, 1.0, x).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    j_fn = lambda x: j_mlp._apply_layers(j_spec.layers, jp["layers"], x,
                                         deterministic=False, rng=key)
    out, vjp = jax.vjp(j_fn, jnp.asarray(x))
    out, (want_dx,) = np.asarray(out), vjp(jnp.asarray(ct))
    if name == "dropout":
        keep = out != 0
        t_fn = lambda tx: t_layers.dropout(tx, _t(keep), layer["rate"])
    elif name == "alpha_dropout":
        keep = out != _alpha_dropped_value(layer["rate"])
        t_fn = lambda tx: t_layers.alpha_dropout(tx, _t(keep), layer["rate"])
    else:
        noise = (out - x) / layer["stddev"]
        keep = np.ones_like(x, bool)
        t_fn = lambda tx: t_layers.gaussian_noise(tx, _t(noise), layer["stddev"])
    if name != "gaussian_noise":
        assert 0 < (~keep).sum() < keep.size  # some entries dropped, some kept
    tx = _t(x).requires_grad_(True)
    got = t_fn(tx)
    (dx,) = torch.autograd.grad(got, tx, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), out, **LAYER_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **LAYER_TOL)


@pytest.mark.parametrize("name", RANDOM_LAYERS)
def test_random_layer_draws_are_repeatable_and_need_a_generator(name):
    """The port's generator path: one seed gives one output, another seed
    another; the keep rate is 1 - rate; deterministic mode is the identity
    and reads no generator; training mode without a generator raises, as
    the JAX package raises without an rng."""
    layer = LAYERS[name]
    j_spec, t_spec, jp, tp = _layer_pair(layer)
    x = _t(np.random.default_rng(3).standard_normal((400, 5)).astype(np.float32))
    run = lambda g, det=False: t_mlp._apply_layers(
        t_spec, t_spec.layers, tp["layers"], x, deterministic=det, generator=g)
    a = run(torch.Generator().manual_seed(5))
    assert torch.equal(a, run(torch.Generator().manual_seed(5)))
    assert not torch.equal(a, run(torch.Generator().manual_seed(6)))
    if name == "dropout":
        assert abs(float((a != 0).float().mean()) - (1 - layer["rate"])) < 0.03
        assert torch.equal(a[a != 0], (x / (1 - layer["rate"]))[a != 0])
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    assert torch.equal(run(g, det=True), x)
    assert torch.equal(g.get_state(), state)
    with pytest.raises(ValueError, match="requires a generator"):
        run(None)
    with pytest.raises(ValueError, match="requires an rng"):
        j_mlp._apply_layers(j_spec.layers, jp["layers"], jnp.asarray(x.numpy()),
                            deterministic=False, rng=None)


def test_draws_do_not_depend_on_the_compute_dtype():
    """A bf16, f32 or f64 input draws the same mask and noise from one
    generator state (noise rounded to the input's dtype)."""
    x = torch.ones(50, 8)
    keeps = [t_layers.draw_keep(torch.Generator().manual_seed(1), x.to(dt), 0.4)
             for dt in (torch.bfloat16, torch.float32, torch.float64)]
    assert all(torch.equal(k, keeps[0]) for k in keeps)
    noise = {dt: t_layers.draw_normal(torch.Generator().manual_seed(1), x.to(dt))
             for dt in (torch.bfloat16, torch.float32, torch.float64)}
    assert noise[torch.bfloat16].dtype == torch.bfloat16
    assert torch.equal(noise[torch.float64].float(), noise[torch.float32])
    assert torch.equal(noise[torch.float32].bfloat16(), noise[torch.bfloat16])


# --------------------------------------------------------------------------
# register_layer
# --------------------------------------------------------------------------


@pytest.fixture
def param_scale():
    """`ParamScale` (x * a trainable per-feature scale, initialized to the
    description's `gain`) and `Widen` (a width-changing kind that declares
    `units`), registered on both packages, each in its own registry."""
    def j_init(rng, layer, in_dim):
        return {"scale": jnp.full((in_dim,), float(layer.extra.get("gain", 1.0)))}, in_dim

    def t_init(generator, layer, in_dim):
        return {"scale": torch.full((in_dim,), float(layer.extra.get("gain", 1.0)))}, in_dim

    def j_widen(rng, layer, in_dim):
        return {}, int(layer.units)

    def t_widen(generator, layer, in_dim):
        return {}, int(layer.units)

    j_layers.register_layer("ParamScale", j_init,
                            lambda l, p, x, *, deterministic, rng: x * p["scale"])
    t_layers.register_layer("ParamScale", t_init,
                            lambda l, p, x, *, deterministic, generator: x * p["scale"])
    j_layers.register_layer("Widen", j_widen,
                            lambda l, p, x, **kw: jnp.concatenate([x, x], axis=-1))
    t_layers.register_layer("Widen", t_widen, lambda l, p, x, **kw: torch.cat([x, x], -1))
    yield
    for registry in (j_layers.CUSTOM_LAYERS, t_layers.CUSTOM_LAYERS):
        registry.pop("ParamScale", None)
        registry.pop("Widen", None)


def _custom_readout(d):
    d["neural_networks"].append({"nn_name": "hidden", "nn_type": "feed_forward",
                                 "nn_architecture": [
                                     {"type_layer": "Dense", "units": 6, "activation": "relu"},
                                     {"type_layer": "ParamScale", "gain": 2.0},
                                     {"type_layer": "Widen", "units": 12}]})
    d["readout"].insert(0, {"type": "neural_network", "input": ["path"], "nn_name": "hidden",
                            "output_name": "hid"})
    d["readout"][1]["input"] = ["hid"]


def test_register_layer_through_a_whole_model(monkeypatch, param_scale):
    """A registered kind with parameters and a width-changing one (its
    declared `units` give the next network's input width), in a readout
    network: init tree, forward, loss and every gradient leaf against the
    JAX package, and a trained custom scale."""
    desc = flagship_dict(mutate=_custom_readout)
    j_ir, t_ir, j_arrays, t_arrays, meta = prepared_batches(desc, (1, False, ()), monkeypatch)
    hidden = next(op.mlp for op in t_ir.readout if op.kind == "neural_network")
    assert t_mlp.output_dim(hidden, 8) == 12
    j_tr = JTrainer(j_build(j_ir))
    t_tr = igt.Trainer(igt.build(t_ir), device="cpu")
    j_state = j_tr.init_state(jax.random.PRNGKey(0))
    t_init = flatten_params(igt.build(t_ir).init(torch.Generator().manual_seed(0)))
    assert sorted(t_init) == sorted(_jax_flat(j_state.params))
    assert torch.equal(t_init["readout/op0/layers/1/scale"], torch.full((6,), 2.0))
    t_state = t_tr.init_state(params=igt.params_from_jax(j_state.params))
    batch = to_device(t_arrays, "cpu")
    got = t_tr.model.apply(t_state.params, batch, meta)
    want = j_tr.model.apply(j_state.params, j_arrays, meta)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SLICE_TOL)
    grads = _check_loss_and_gradients((j_tr, t_tr, j_state, t_state, j_arrays, batch, meta))
    assert grads["readout/op0/layers/1/scale"].abs().max() > 0


def test_the_registries_are_separate_and_refuse_built_in_kinds(param_scale):
    """A kind registered on the JAX package alone is unknown to the port: its
    init raises naming the kind, the network and the port's extensions; no
    registry lets a built-in kind be shadowed."""
    j_layers.register_layer("JaxOnly", lambda r, l, d: ({}, d), lambda l, p, x, **kw: x)
    try:
        layer = {"type_layer": "JaxOnly"}
        spec = t_ir_mod.MLPSpec("net", (t_parser._parse_layer(layer, 0, "t"),))
        with pytest.raises(ValueError, match="unsupported layer type 'JaxOnly' in network "
                                             "'net'.*registered extensions: ParamScale, Widen"):
            t_mlp.init(torch.Generator(), spec, 4)
    finally:
        j_layers.CUSTOM_LAYERS.pop("JaxOnly")
    for module in (j_layers, t_layers):
        with pytest.raises(ValueError, match="cannot override built-in layer kind 'Dropout'"):
            module.register_layer("Dropout", None, None)
    assert igt.register_layer is t_layers.register_layer


# --------------------------------------------------------------------------
# segment_softmax
# --------------------------------------------------------------------------


def test_segment_softmax_and_max_match_jax():
    """Unsorted ids with two empty segments, masked edges and one segment
    whose every edge is masked: weights and the gradient of a weighted sum."""
    rng = np.random.default_rng(4)
    e, n = 60, 12
    ids = rng.choice([i for i in range(n) if i not in (3, 7)], size=e).astype(np.int32)
    mask = (rng.random(e) > 0.25).astype(np.float32)
    mask[ids == 5] = 0.0
    scores = (3 * rng.standard_normal(e)).astype(np.float32)
    ct = rng.standard_normal(e).astype(np.float32)
    j_fn = lambda s: j_seg.segment_softmax(s, jnp.asarray(ids), n, jnp.asarray(mask))
    want, vjp = jax.vjp(j_fn, jnp.asarray(scores))
    (want_ds,) = vjp(jnp.asarray(ct))
    s = _t(scores).requires_grad_(True)
    got = t_seg.segment_softmax(s, _t(ids), n, _t(mask))
    (ds,) = torch.autograd.grad(got, s, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), atol=1e-6, rtol=1e-5)
    w = got.detach().numpy()
    assert not w[mask == 0].any() and not w[ids == 5].any()
    sums = np.bincount(ids, weights=w, minlength=n)
    real = np.bincount(ids, weights=mask, minlength=n) > 0
    np.testing.assert_allclose(sums[real], 1.0, rtol=1e-5)
    assert not sums[~real].any()
    data = rng.standard_normal((e, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_seg.segment_max(_t(data), _t(ids), n).numpy(),
        np.asarray(jax.ops.segment_max(jnp.asarray(data), jnp.asarray(ids), n)))


# --------------------------------------------------------------------------
# attention: both softmax modes on every per-edge route
# --------------------------------------------------------------------------


def _softmax_mode(mode):
    def mutate(d):
        for stage in d["message_passing"]["stages"]:
            for mp in stage["stage_mp"]:
                if mp["aggregation"]["type"] == "attention":
                    mp["aggregation"]["attention_softmax"] = mode
    return mutate


def _two_source_attention(mode):
    """Q-size with stage 1's interleave replaced by attention over its two
    sources (link and node states into each path)."""
    d = qsize_dict({"type": "attention"})
    _softmax_mode(mode)(d)
    return d


# case -> (description, branches entry: graphs, dense cap patched to 0, keys dropped)
ATTENTION_CASES = {
    "reference_row_ptr": (
        lambda: flagship_dict(mutate=lambda d: (to_attention(d), _softmax_mode("reference")(d))),
        (1, True, ())),
    "reference_no_row_ptr": (
        lambda: flagship_dict(mutate=lambda d: (to_attention(d), _softmax_mode("reference")(d))),
        (1, True, ("row_ptr_adj_paths_links",))),
    # a batch made for the per_destination mode, with its dense incidence
    # matrix, which the reference mode does not read
    "reference_dense_batch": (
        lambda: flagship_dict(mutate=lambda d: (to_attention(d), _softmax_mode("reference")(d))),
        (1, False, ()), lambda: flagship_dict(mutate=to_attention)),
    "reference_two_sources": (lambda: _two_source_attention("reference"), (1, False, ())),
    "reference_merged_3": (
        lambda: flagship_dict(mutate=lambda d: (to_attention(d), _softmax_mode("reference")(d))),
        (3, True, ())),
    "per_destination_no_row_ptr": (lambda: flagship_dict(mutate=to_attention),
                                   (1, True, ("row_ptr_adj_paths_links",))),
    "per_destination_two_sources": (lambda: _two_source_attention("per_destination"),
                                    (1, False, ())),
}


def _attention_trainers(case, monkeypatch):
    make, entry, *batch_desc = ATTENTION_CASES[case]
    desc = make()
    # the per-edge routes: slot-rate attention off in both packages
    for builder in (j_builder, t_builder):
        monkeypatch.setattr(builder, "_SLOT_ATTN", False)
    j_ir, t_ir, j_arrays, t_arrays, meta = prepared_batches(
        batch_desc[0]() if batch_desc else desc, entry, monkeypatch)
    if batch_desc:
        j_ir, t_ir = j_parse(copy.deepcopy(desc), DIMS), igt.parse_model_description(desc, DIMS)
        assert "dense_inc_adj_paths_links" in t_arrays
    j_tr = JTrainer(j_build(j_ir))
    t_tr = igt.Trainer(igt.build(t_ir), device="cpu")
    j_state = j_tr.init_state(jax.random.PRNGKey(0))
    t_state = t_tr.init_state(params=igt.params_from_jax(j_state.params))
    return j_tr, t_tr, j_state, t_state, j_arrays, to_device(t_arrays, "cpu"), meta


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_route_matches_jax(case, monkeypatch):
    """Forward, loss, every gradient leaf and 10 Adam steps at 1e-4. The
    reference mode bypasses the dense routes as in the JAX package (no
    kernel D on a batch that has an incidence matrix); a single sorted
    source with row pointers ends in kernel A's sum."""
    from ignnition_tpu_torch.ops.cuda import attention_kernels as t_ak
    from ignnition_tpu_torch.ops.cuda import segment_kernels as t_sk

    trainers = _attention_trainers(case, monkeypatch)
    j_tr, t_tr, j_state, t_state, j_batch, t_batch, meta = trainers
    calls = []
    for mod, name in ((t_sk, "sorted_segment_sum_csr_plain"),
                      (t_ak, "flash_gat_forward_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    with torch.no_grad():
        got = t_tr.model.apply(t_state.params, t_batch, meta)
    want = j_tr.model.apply(j_state.params, j_batch, meta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SLICE_TOL)
    assert "flash_gat_forward_plain" not in calls
    if case == "reference_row_ptr":  # the weighted sum, once an iteration
        assert calls.count("sorted_segment_sum_csr_plain") == 2
    if case == "reference_no_row_ptr":
        assert "sorted_segment_sum_csr_plain" not in calls
    _check_loss_and_gradients(trainers)
    _check_adam_trajectory(trainers, noise_floor=5e-6)


def test_reference_softmax_merged_batch_equals_per_graph():
    """The reference mode's softmax runs per graph: 3 graphs merged in one
    batch predict what each graph predicts alone, in both packages."""
    desc = flagship_dict(mutate=lambda d: (to_attention(d), _softmax_mode("reference")(d)))
    t_ir = igt.parse_model_description(copy.deepcopy(desc), DIMS)
    j_ir = j_parse(copy.deepcopy(desc), DIMS)
    j_model = j_build(j_ir)
    j_params = j_model.init(jax.random.PRNGKey(0))
    model = igt.build(t_ir)
    model.load_params(igt.params_from_jax(j_params))
    rng, j_rng = np.random.default_rng(9), np.random.default_rng(9)
    t_samples = [igt.convert_sample(make_routenet_sample(rng, 32, 24, 6), igt.SampleSpec.from_ir(t_ir))
                 for _ in range(3)]
    j_samples = [j_convert(j_make_sample(j_rng, 32, 24, 6), JSampleSpec.from_ir(j_ir))
                 for _ in range(3)]

    def t_predict(samples):
        arrays, meta = igt.build_batch(samples, t_ir)
        with torch.no_grad():
            preds = model(to_device(arrays, "cpu"), meta).numpy()
        return preds[arrays["node_mask_path"] > 0]

    def j_predict(samples):
        arrays, meta = j_build_batch(samples, j_ir)
        return np.asarray(j_model.apply(j_params, arrays, meta))[arrays["node_mask_path"] > 0]

    merged = t_predict(t_samples)
    alone = np.concatenate([t_predict([s]) for s in t_samples])
    np.testing.assert_allclose(merged, alone, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(merged, j_predict(j_samples), **SLICE_TOL)
    np.testing.assert_allclose(
        alone, np.concatenate([j_predict([s]) for s in j_samples]), **SLICE_TOL)


# --------------------------------------------------------------------------
# every optimizer
# --------------------------------------------------------------------------

SCHEDULE = ("ExponentialDecay", {"initial_learning_rate": 0.01, "decay_steps": 3,
                                 "decay_rate": 0.5})

# tests/test_keras_training_parity.py's OPT_CASES, then the options it does
# not reach, and schedules where a kind keeps a learning-rate-scaled state
OPT_CASES = {
    "Adam": ({"learning_rate": 0.01}, None),
    "AdamW": ({"learning_rate": 0.01, "weight_decay": 0.004}, None),
    "SGD": ({"learning_rate": 0.01}, None),
    "SGD_momentum": ({"learning_rate": 0.01, "momentum": 0.9}, None),
    "SGD_nesterov": ({"learning_rate": 0.01, "momentum": 0.9, "nesterov": True}, None),
    "RMSprop": ({"learning_rate": 0.01}, None),
    "Adagrad": ({"learning_rate": 0.01}, None),
    "Adadelta": ({"learning_rate": 0.01}, None),
    "Adamax": ({"learning_rate": 0.01}, None),
    "Nadam": ({"learning_rate": 0.01}, None),
    "Adam_amsgrad": ({"learning_rate": 0.01, "amsgrad": True}, None),
    "Adam_clipvalue": ({"learning_rate": 0.01, "clipvalue": 0.5}, None),
    "Adam_clipnorm": ({"learning_rate": 0.01, "clipnorm": 1.0}, None),
    "SGD_globalclip": ({"learning_rate": 0.01, "global_clipnorm": 1.0}, None),
    "RMSprop_centered_momentum": ({"rho": 0.8, "centered": "True", "momentum": 0.9,
                                   "epsilon": 1e-6}, SCHEDULE),
    "RMSprop_momentum_schedule": ({"momentum": 0.5}, SCHEDULE),
    "Adagrad_initial_accumulator": ({"learning_rate": 0.05, "initial_accumulator_value": 0.5,
                                     "epsilon": 1e-5}, None),
    "Nadam_schedule": ({"beta_1": 0.85, "beta_2": 0.99}, SCHEDULE),
    "Adam_amsgrad_schedule": ({"amsgrad": "true", "clipnorm": 2.0}, SCHEDULE),
    "AdamW_schedule": ({"weight_decay": 0.1, "epsilon": 1e-6}, SCHEDULE),
    "Adadelta_rho": ({"learning_rate": 1.0, "rho": 0.9, "epsilon": 1e-6}, None),
    "Adamax_betas": ({"beta_1": 0.8, "beta_2": 0.95, "global_clipnorm": 1.0}, SCHEDULE),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_jax(case):
    """12 steps on a small tree (one leaf of zero gradients, as a
    BatchNormalization's moving statistics get) against the JAX package's
    optax transformation: every leaf within 1e-5 of its largest entry, and
    the state keeps every step's count."""
    kind = case.split("_")[0]
    params, sched = OPT_CASES[case]
    j_tx = j_opt.build_optimizer(JOptimizerSpec(
        kind=kind, params=params,
        schedule=None if sched is None else JScheduleSpec(kind=sched[0], params=sched[1])))
    t_tx = t_opt.build_optimizer(OptimizerSpec(
        kind=kind, params=params,
        schedule=None if sched is None else ScheduleSpec(kind=sched[0], params=sched[1])))
    rng = np.random.default_rng(3)
    p0 = {"a": {"kernel": rng.standard_normal((4, 3)).astype(np.float32)},
          "b": (rng.standard_normal(5).astype(np.float32),),
          "frozen": np.ones(3, np.float32)}
    j_params = jax.tree.map(jnp.asarray, p0)
    j_state = j_tx.init(j_params)
    t_params = igt.params_from_jax(p0)
    t_state = t_tx.init(t_params)
    for _ in range(12):
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
    assert t_state["count"] == 12
    frozen = t_params["frozen"].numpy()
    if kind == "AdamW":  # decoupled weight decay on every leaf
        assert (frozen < 1.0).all()
    else:
        np.testing.assert_array_equal(frozen, 1.0)


def _bn_readout(optimizer):
    def mutate(d):
        net = next(n for n in d["neural_networks"] if n["nn_name"] == "readout")
        net["nn_architecture"] = [
            {"type_layer": "Dense", "units": 16, "activation": "relu"},
            {"type_layer": "BatchNormalization"},
            {"type_layer": "Dense", "units": 1}]
        d["learning_options"]["optimizer"] = optimizer
    return mutate


@pytest.mark.parametrize("kind", ["AdamW", "Adam"])
def test_batch_norm_moving_statistics_under_training(kind, monkeypatch):
    """10 `train_step_fn` steps of a model with a BatchNormalization readout:
    the moving statistics get a zero gradient tensor in the port (not None)
    and, as in the JAX package, decay under AdamW's unmasked weight decay and
    stay where they are under Adam. Loss and the statistics at 1e-5 a step."""
    optimizer = {"type": kind, "learning_rate": 0.01}
    if kind == "AdamW":
        optimizer["weight_decay"] = 0.5
    desc = flagship_dict(mutate=_bn_readout(optimizer))
    j_ir, t_ir, j_arrays, t_arrays, meta = prepared_batches(desc, (1, False, ()), monkeypatch)
    j_tr = JTrainer(j_build(j_ir))
    t_tr = igt.Trainer(igt.build(t_ir), device="cpu")
    j_state = j_tr.init_state(jax.random.PRNGKey(0))
    t_state = t_tr.init_state(params=igt.params_from_jax(j_state.params))
    batch = to_device(t_arrays, "cpu")
    stats = [f"readout/op0/layers/1/{k}" for k in ("moving_mean", "moving_variance")]
    grads, _ = t_tr.grads_fn(meta)(t_state.params, batch)
    for k in stats:
        g = flatten_params(grads)[k]
        assert isinstance(g, torch.Tensor) and not g.any()
    j_step, t_step = j_tr.train_step_fn(meta), t_tr.train_step_fn(meta)
    params, opt_state = j_state.params, j_state.opt_state
    for i in range(10):
        params, opt_state, want = j_step(params, opt_state, j_arrays, jax.random.PRNGKey(1))
        t_state, got = t_step(t_state, batch)
        np.testing.assert_allclose(got["total"].item(), float(want["total"]), **SLICE_TOL)
        flat, want_flat = flatten_params(t_state.params), _jax_flat(params)
        for k in stats:
            np.testing.assert_allclose(flat[k].detach().numpy(), want_flat[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    variance = flatten_params(t_state.params)[stats[1]].detach()
    if kind == "AdamW":
        np.testing.assert_allclose(variance.numpy(), (1 - 0.01 * 0.5) ** 10, rtol=1e-5)
    else:
        assert torch.equal(variance, torch.ones_like(variance))


# --------------------------------------------------------------------------
# training mode: what draws and what does not
# --------------------------------------------------------------------------


def _dropout_readout(d):
    net = next(n for n in d["neural_networks"] if n["nn_name"] == "readout")
    net["nn_architecture"].insert(1, {"type_layer": "Dropout", "rate": 0.5})
    net["nn_architecture"].insert(2, {"type_layer": "GaussianNoise", "stddev": 0.1})


def test_message_network_dropout_is_the_identity_in_training(monkeypatch):
    """A Dropout in a message network does nothing in a training step, as in
    the JAX package (message and update networks get no rng): loss and every
    gradient leaf equal the JAX package's, and the step draws nothing from
    the trainer's generator."""
    def mutate(d):
        d["neural_networks"].append({"nn_name": "msg", "nn_type": "feed_forward",
                                     "nn_architecture": [
                                         {"type_layer": "Dense", "units": 8, "activation": "relu"},
                                         {"type_layer": "Dropout", "rate": 0.5},
                                         {"type_layer": "Dense", "units": 8}]})
        src = d["message_passing"]["stages"][1]["stage_mp"][0]["source_entities"][0]
        src["message"] = [{"type": "neural_network", "nn_name": "msg",
                           "input": ["hs_source", "hs_dest"]}]

    desc = flagship_dict(mutate=mutate)
    j_ir, t_ir, j_arrays, t_arrays, meta = prepared_batches(desc, (1, True, ()), monkeypatch)
    j_tr = JTrainer(j_build(j_ir))
    t_tr = igt.Trainer(igt.build(t_ir), device="cpu")
    j_state = j_tr.init_state(jax.random.PRNGKey(0))
    t_state = t_tr.init_state(params=igt.params_from_jax(j_state.params))
    batch = to_device(t_arrays, "cpu")
    before = t_tr.generator.get_state()
    _check_loss_and_gradients((j_tr, t_tr, j_state, t_state, j_arrays, batch, meta))
    assert torch.equal(t_tr.generator.get_state(), before)
    with torch.no_grad():
        trained = t_tr.model.apply(t_state.params, batch, meta, training=True,
                                   generator=t_tr.generator)
        served = t_tr.model.apply(t_state.params, batch, meta)
    assert torch.equal(trained, served)


def test_readout_draws_from_the_trainers_generator(monkeypatch):
    """A training step of a model with a dropout readout draws from the
    trainer's generator: `train(seed=)` seeds it, so two runs of one seed
    end equal and another seed elsewhere; evaluation and serving (training
    off) do not depend on any generator; a step of a model without a random
    layer draws nothing."""
    desc = flagship_dict(mutate=_dropout_readout)
    _, t_ir, _, t_arrays, meta = prepared_batches(desc, (1, False, ()), monkeypatch)
    batch = to_device(t_arrays, "cpu")
    tr = igt.Trainer(igt.build(t_ir), device="cpu")
    init = tr.model.init(torch.Generator().manual_seed(0))

    def run(seed):
        state = tr.init_state(params=init)
        tr.generator.manual_seed(seed)
        step = tr.train_step_fn(meta)
        for _ in range(2):
            state, m = step(state, batch)
        return flatten_params(state.params), float(m["total"])

    a, b, c = run(42), run(42), run(7)
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0]) and a[1] == b[1]
    assert a[1] != c[1]
    params = tr.init_state(params=init).params
    with torch.no_grad():
        outs = [tr.model.apply(params, batch, meta, training=False,
                               generator=None if s is None else torch.Generator().manual_seed(s))
                for s in (None, 1, 2)]
        drawn = tr.model.apply(params, batch, meta, training=True,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], drawn)
    preds, _ = tr.eval_step_fn(meta)(params, batch)
    assert torch.equal(preds, outs[0])
    with pytest.raises(ValueError, match="Dropout requires a generator"):
        tr.model.apply(params, batch, meta, training=True)

    plain = igt.Trainer(igt.build(igt.parse_model_description(flagship_dict(), DIMS)),
                        device="cpu")
    state = plain.init_state()
    before = plain.generator.get_state()
    plain.train_step_fn(meta)(state, batch)
    assert torch.equal(plain.generator.get_state(), before)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path runs only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_taking_layers_on_the_card_match_the_cpu(cuda_device, dtype):
    """The random layers' functions on the card against the CPU on the same
    input and mask or noise (elementwise: equal up to a rounding, the card
    fusing a * x + b into one)."""
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((4096, 32)).astype(np.float32)).to(dtype)
    keep = _t(rng.random((4096, 32)) > 0.2)
    noise = _t(rng.standard_normal((4096, 32)).astype(np.float32)).to(dtype)
    tol = (dict(atol=1e-6, rtol=2.5e-7) if dtype == torch.float32
           else dict(atol=1e-2, rtol=1e-2))
    for fn, arg, p in ((t_layers.dropout, keep, 0.2), (t_layers.alpha_dropout, keep, 0.2),
                       (t_layers.gaussian_noise, noise, 0.1)):
        got = fn(x.to(cuda_device), arg.to(cuda_device), p).cpu()
        torch.testing.assert_close(got, fn(x, arg, p), **tol)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    drawn = t_layers.draw_keep(g, x.to(cuda_device), 0.2)
    assert drawn.device.type == "cuda" and abs(float(drawn.float().mean()) - 0.8) < 0.01


@pytest.mark.cuda
def test_segment_softmax_on_the_card_matches_the_cpu_in_f64(cuda_device):
    rng = np.random.default_rng(12)
    e, n = 200_000, 3_000
    ids = _t(rng.integers(0, n, e).astype(np.int64))
    mask = _t((rng.random(e) > 0.1).astype(np.float32))
    scores = _t((4 * rng.standard_normal(e)).astype(np.float32))
    want = t_seg.segment_softmax(scores.double(), ids, n, mask)
    got = t_seg.segment_softmax(scores.to(cuda_device), ids.to(cuda_device), n,
                                mask.to(cuda_device))
    torch.testing.assert_close(got.cpu().double(), want, atol=1e-6, rtol=1e-5)
