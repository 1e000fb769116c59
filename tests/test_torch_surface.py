"""The rest of the JAX package's surface in the port, against the JAX
package on the CPU: slot-rate attention (the JAX package's default for
per-edge networks into attention and for message tables without an
incidence matrix), the exact-lowering switches of `model/builder.py`, the
kernel switches (`IGNNITION_TPU_PALLAS` / `set_pallas_mode`,
`IGNNITION_TPU_FLASH_ATTN`, `IGNNITION_TPU_FUSED_RNN` / `set_mode`),
iteration rematerialization (`IGNNITION_TPU_ITER_REMAT`) and the public
names.

The models are `tests/test_torch_message.py`'s: the flagship at hs=8 with 2
iterations, one parameter tree (JAX init, carried over by
`params_from_jax`) and the same seeded graphs through each package's
`build_batch`; the knobs that choose a lowering are patched alike in both
packages, the switches through their module attributes (never the
environment: both packages read it at import). f32 agrees at atol = rtol =
1e-4 (forward, loss, every gradient leaf, 10 Adam steps), bf16 at 3e-2;
rematerialized gradients lie within 1e-6 of each leaf's largest entry of
the plain step's. The destination-sharded cases run in one gloo world of 2
(`test_torch_distributed.spawn_world`).
"""

import copy
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
from ignnition_tpu.ops import segment as j_seg
from ignnition_tpu.ops.pallas import rnn_kernels as j_rk
from ignnition_tpu.training.trainer import Trainer as JTrainer
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.data.synthetic import make_routenet_sample
from ignnition_tpu_torch.model.builder import flatten_params
from ignnition_tpu_torch.ops import segment as t_seg
from ignnition_tpu_torch.ops import cuda as t_cuda
from ignnition_tpu_torch.ops.cuda import attention_kernels as t_ak
from ignnition_tpu_torch.ops.cuda import rnn_kernels as t_rk
from ignnition_tpu_torch.ops.cuda import segment_kernels as t_sk
from ignnition_tpu_torch.serving import export_program, kernel_ops
from ignnition_tpu_torch.training import capture

from bench import _mutate_mlp_message
from helpers import dense, routenet_description
from test_torch_distributed import spawn_world
from test_torch_edgeshard import ONE_GRAPH_PAD, Case, _raws, _real_rows
from test_torch_model import BF16_TOL, DIMS, F32_TOL, flagship_dict
from test_torch_train import _check_adam_trajectory, _check_loss_and_gradients, _jax_flat

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
STAGE2 = "adj_paths_links"
REMAT_TOL = 1e-6  # of each leaf's largest entry


def _attention(d):
    d["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"] = {"type": "attention"}


def _three_layer_messages(d):
    """A message network over [hs_source, hs_dest] on stage 2 whose last
    linear Dense layer the sum factors out (12 relu, 10 tanh, 8 linear)."""
    d["neural_networks"].append({"nn_name": "msg", "nn_type": "feed_forward",
                                 "nn_architecture": [dense(12, "relu"), dense(10, "tanh"),
                                                     dense(8, None)]})
    for se in d["message_passing"]["stages"][1]["stage_mp"][0]["source_entities"]:
        se["message"] = [{"type": "neural_network", "nn_name": "msg",
                          "input": ["hs_source", "hs_dest"]}]


# model -> (description, knobs): "cap0" past the dense-incidence cap; "slot"
# the slot cap (`IR.SLOT_PAD_CAP`) raised to 1e9 and "slot0" set to 0 (these
# small graphs lie past the cap of 3 unless it is raised); "win" slice sorts
# in windows of 50 slots
MODELS = {
    # the attention family past the dense cap: a message table without an
    # incidence matrix, slot-rate attention by default
    "attention_past_cap": (lambda: flagship_dict(mutate=_attention), ("cap0", "slot")),
    # the mlp_message family's 32-32 network into attention on stage 2
    "per_edge_32_32_attention": (
        lambda: flagship_dict(mutate=lambda d: (_mutate_mlp_message(d), _attention(d))),
        ("slot",)),
    "mlp_message": (lambda: flagship_dict(mutate=_mutate_mlp_message), ("slot",)),
    "mlp_message_windowed": (lambda: flagship_dict(mutate=_mutate_mlp_message),
                             ("slot", "win")),
    "factor_last_past_cap": (lambda: flagship_dict(mutate=_three_layer_messages), ("slot0",)),
    "flagship": (lambda: flagship_dict(), ()),
    # the attention family under the dense cap: dense attention, kernels D and E
    "attention_dense": (lambda: flagship_dict(mutate=_attention), ()),
}


def _batches(name, monkeypatch, n_graphs=1):
    """(JAX ir, port ir, JAX arrays, port arrays, meta) of a model, with its
    knobs patched in both packages, and the port's `_SLOT_ATTN` set to the
    JAX package's (on by default there, off in the port), so that both take
    one attention branch."""
    make_desc, knobs = MODELS[name]
    monkeypatch.setattr(t_builder, "_SLOT_ATTN", j_builder._SLOT_ATTN)
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
    irs = (j_parse(copy.deepcopy(desc), dict(DIMS)),
           igt.parse_model_description(copy.deepcopy(desc), dict(DIMS)))
    out = []
    for ir, spec_cls, convert, make, build, pad in (
        (irs[0], JSampleSpec, j_convert, j_make_sample, j_build_batch, j_graph.PaddingConfig),
        (irs[1], igt.SampleSpec, igt.convert_sample, make_routenet_sample, igt.build_batch,
         igt.PaddingConfig),
    ):
        rng = np.random.default_rng(0)
        spec = spec_cls.from_ir(ir)
        samples = [convert(make(rng, 32, 24, 6), spec) for _ in range(n_graphs)]
        out.append(build(samples, ir, pad(mode="multiple", multiple=64, min_size=64)))
    (j_arrays, meta), (t_arrays, _) = out
    assert sorted(j_arrays) == sorted(t_arrays)
    return irs[0], irs[1], j_arrays, t_arrays, meta


def _switch(monkeypatch, name, value):
    """One exact-lowering switch set alike in both packages."""
    for builder in (j_builder, t_builder):
        monkeypatch.setattr(builder, name, value)


def _trainers(name, monkeypatch, n_graphs=1):
    j_ir_, t_ir_, j_arrays, t_arrays, meta = _batches(name, monkeypatch, n_graphs)
    j_trainer = JTrainer(j_build(j_ir_), compute_dtype=None)
    t_trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
    j_state = j_trainer.init_state(jax.random.PRNGKey(0))
    t_state = t_trainer.init_state(params=igt.params_from_jax(j_state.params))
    return j_trainer, t_trainer, j_state, t_state, j_arrays, to_device(t_arrays, "cpu"), meta


def _forwards(name, monkeypatch, compute_dtype=None, n_graphs=1):
    """The port's predictions and the JAX package's, from one tree."""
    j_ir_, t_ir_, j_arrays, t_arrays, meta = _batches(name, monkeypatch, n_graphs)
    j_params = j_build(j_ir_).init(jax.random.PRNGKey(0))
    model = igt.build(t_ir_)
    model.load_params(igt.params_from_jax(j_params))
    got = model(to_device(t_arrays, "cpu"), meta, compute_dtype=compute_dtype)
    want = j_build(j_ir_).apply(j_params, j_arrays, meta, compute_dtype=(
        None if compute_dtype is None else jnp.bfloat16))
    return got.numpy(), np.asarray(want)


def _spy_methods(monkeypatch, names):
    """Count each package's calls of the builder methods `names`, and how
    many of them returned something: {(package, name): [calls, results]}."""
    seen = {}
    for tag, builder in (("jax", j_builder), ("port", t_builder)):
        for name in names:
            real = getattr(builder.GnnModel, name)
            seen[(tag, name)] = [0, 0]

            def spy(self, *a, _real=real, _key=(tag, name), **kw):
                out = _real(self, *a, **kw)
                seen[_key][0] += 1
                seen[_key][1] += out is not None
                return out

            monkeypatch.setattr(builder.GnnModel, name, spy)
    return seen


# --------------------------------------------------------------------------
# slot-rate attention against the JAX package's default path
# --------------------------------------------------------------------------

SLOT_ATTENTION = ["attention_past_cap", "per_edge_32_32_attention"]


@pytest.mark.parametrize("name", SLOT_ATTENTION)
@pytest.mark.parametrize("slot_attn", [True, False])
def test_attention_branch_is_the_jax_packages(name, slot_attn, monkeypatch):
    """With `_SLOT_ATTN` on (the JAX package's default) both packages
    aggregate stage 2 by `_slot_attention` at every iteration, the per-edge form never; with it
    off both take the per-edge form (`_attention`). The forward agrees at
    f32 either way."""
    _switch(monkeypatch, "_SLOT_ATTN", slot_attn)
    seen = _spy_methods(monkeypatch, ("_slot_attention", "_attention"))
    got, want = _forwards(name, monkeypatch)
    np.testing.assert_allclose(got, want, **F32_TOL)
    iterations = 2
    for tag in ("jax", "port"):
        if slot_attn:
            assert seen[(tag, "_slot_attention")] == [iterations, iterations], tag
            assert seen[(tag, "_attention")][0] == 0, tag
        else:
            assert seen[(tag, "_slot_attention")][0] == 0, tag
            assert seen[(tag, "_attention")][0] == iterations, tag


def test_slot_attention_two_graphs_and_bf16(monkeypatch):
    """Two graphs in one batch (destinations of several in-degrees, padding
    rows without messages: zero rows), f32; and the bf16 forward."""
    got, want = _forwards("attention_past_cap", monkeypatch, n_graphs=2)
    np.testing.assert_allclose(got, want, **F32_TOL)
    got, want = _forwards("per_edge_32_32_attention", monkeypatch, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("name", SLOT_ATTENTION)
def test_slot_attention_loss_and_gradients_match_jax(name, monkeypatch):
    """Every gradient leaf at the slice's limits; no NaN reaches a gradient
    from the masked slots or the destinations without messages."""
    got = _check_loss_and_gradients(_trainers(name, monkeypatch))
    assert all(np.isfinite(v.numpy()).all() for v in got.values())
    assert any(k.startswith("aggregation/s1/m0/attn_kernel") for k in got)


def _f32_unresolved(t_ir_, j_params, batch, meta):
    """The elements whose f32 gradient at `j_params` lies further than 1%
    of the f64 gradient from it (the port's plain path, f32 and f64): there
    f32 does not resolve the gradient, in either package."""
    grads = []
    for dtype in (None, torch.float64):
        trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=dtype, device="cpu")
        state = trainer.init_state(params=igt.params_from_jax(j_params))
        g, _ = trainer.grads_fn(meta)(state.params, batch)
        grads.append({k: v.double().numpy() for k, v in flatten_params(g).items()})
    return {k: np.abs(grads[0][k] - w) > 0.01 * np.abs(w) for k, w in grads[1].items()}


@pytest.mark.parametrize("name", SLOT_ATTENTION)
def test_slot_attention_adam_trajectory_matches_jax(name, monkeypatch):
    """Ten Adam steps by `test_torch_train._check_adam_trajectory`'s rule.
    The attention leaves' gradients are of order 1e-6 to 4e-5 here, and the
    two packages' f32 noise on them up to ~1e-8 (`kernel2`'s whole gradient
    is noise, ~1e-11: a per-destination shift leaves a softmax unchanged):
    elements under 1e-7 count as noise, as in
    `test_torch_train.test_attention_adam_trajectory_matches_jax`.

    The 32-32 network: f32 does not resolve every element's gradient along
    the trajectory, in either package. At the JAX package's parameters
    after its first step one element of the readout's middle kernel has the
    gradient 1.846e-4 in f64 and 3.253e-4 in f32 (the port's and the JAX
    package's alike), which Adam carries into a 0.11 lr gap; the per-edge
    form (`_SLOT_ATTN` off in both) shows the same. So each step first
    finds the elements that f32 misses by more than 1% of their f64
    gradient at the JAX package's parameters, and from that step on holds
    them as the rule holds noise, within 2 lr a step; they must stay few:
    497 of the 71,228 firm elements over the ten steps."""
    trainers = _trainers(name, monkeypatch)
    if name != "per_edge_32_32_attention":
        _check_adam_trajectory(trainers, noise_floor=1e-7)
        return
    j_tr, t_tr, j_state, t_state, j_batch, t_batch, meta = trainers
    j_step, t_step = j_tr.train_step_fn(meta), t_tr.train_step_fn(meta)
    params, opt_state, rng = j_state.params, j_state.opt_state, jax.random.PRNGKey(1)
    _, g0 = jax.value_and_grad(j_tr._loss, has_aux=True)(params, j_batch, meta, rng)
    firm = {k: np.abs(g) >= max(1e-3 * np.abs(g).max(), 1e-7) for k, g in _jax_flat(g0).items()}
    loose = {k: np.zeros_like(m) for k, m in firm.items()}
    first = None
    for i in range(10):
        for k, m in _f32_unresolved(t_tr.model.ir, params, t_batch, meta).items():
            loose[k] |= m
        params, opt_state, want = j_step(params, opt_state, j_batch, rng)
        t_state, got = t_step(t_state, t_batch)
        for k in ("loss", "reg", "total"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=f"step {i} {k}",
                                       **F32_TOL)
        first = got["total"].item() if first is None else first
        want_flat = _jax_flat(params)
        for k, v in flatten_params(t_state.params).items():
            v, held = v.detach().numpy(), firm[k] & ~loose[k]
            np.testing.assert_allclose(v[held], want_flat[k][held], err_msg=f"step {i} {k}",
                                       **F32_TOL)
            assert np.abs(v - want_flat[k]).max() <= 2 * 1e-3 * (i + 1), f"step {i} {k}"
    assert got["total"].item() < first
    n_loose = sum(int((firm[k] & loose[k]).sum()) for k in firm)
    assert 0 < n_loose <= 0.01 * sum(int(m.sum()) for m in firm.values()), n_loose


# --------------------------------------------------------------------------
# the exact-lowering switches, each off in both packages
# --------------------------------------------------------------------------

# switch -> (model, the port's function that the switch's other
# branch calls, the one its default branch calls)
SWITCHES = {
    "_SLICE_MLP": ("mlp_message", ("nn.rnn", "masked_update_from_edges"), None),
    "_SLOT_SUM": ("mlp_message", ("ops.segment", "segment_sum"), None),
    "_SLOT_ATTN": ("attention_past_cap", None, None),
    "_SPLIT_FIRST": ("mlp_message", None, ("model.builder", "_split_first_kernels")),
    "_FACTOR_LAST": ("factor_last_past_cap", None, ("nn.mlp", "last_dense")),
}


def _count_calls(monkeypatch, where):
    import importlib

    module = importlib.import_module(f"ignnition_tpu_torch.{where[0]}")
    real, calls = getattr(module, where[1]), [0]

    def spy(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(module, where[1], spy)
    return calls


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switch_off_matches_jax(switch, monkeypatch):
    """The switch off in both packages: the port takes the other branch
    (the function that only it calls runs; the function that only the
    default branch calls does not) and its forward, loss and every gradient
    leaf agree with the JAX package's."""
    name, off_only, on_only = SWITCHES[switch]
    _switch(monkeypatch, switch, False)
    spies = [(_count_calls(monkeypatch, w), want) for w, want in ((off_only, True),
                                                                  (on_only, False)) if w]
    got, want = _forwards(name, monkeypatch)
    np.testing.assert_allclose(got, want, **F32_TOL)
    for calls, called in spies:
        assert (calls[0] > 0) == called
    _check_loss_and_gradients(_trainers(name, monkeypatch))


LOWERINGS = ("_SLICE_MLP", "_SLOT_SUM", "_SPLIT_FIRST", "_FACTOR_LAST", "_HALO_OVERLAP")


def test_switches_have_the_jax_names_and_defaults():
    """Each exact-lowering switch and `_ITER_REMAT` exists in the port with
    the JAX package's name and default (no variable set here), but for
    `_SLOT_ATTN`: off in the port, where the per-edge form is the faster
    (README). A captured step is bound to the two that a user sets from the
    environment."""
    assert t_builder.SWITCHES == ("_SLOT_ATTN", "_ITER_REMAT")
    for name in LOWERINGS + ("_ITER_REMAT",):
        assert getattr(t_builder, name) == getattr(j_builder, name), name
    assert t_builder._ITER_REMAT == "never"
    assert (t_builder._SLOT_ATTN, j_builder._SLOT_ATTN) == (False, True)


# --------------------------------------------------------------------------
# the kernel switches
# --------------------------------------------------------------------------


def _mode(monkeypatch, switch, mode):
    """One kernel switch of the port's table (`ops.cuda`) set for a test,
    past the setter's check."""
    monkeypatch.setitem(t_cuda._MODES, switch, mode)


class _PortOps(TorchDispatchMode):
    """The port's kernel operators called under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "ignnition_tpu_torch":
            self.seen.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _wrapper_calls():
    """wrapper -> (module, its plain version's name, its switch, arguments
    made from a seed)."""
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=gen)
    row_ptr = torch.tensor([0, 3, 3, 7, 10], dtype=torch.int32)
    windows = torch.tensor([0, 2, 4, 5, 6, 8, 10], dtype=torch.int32)
    ids = torch.tensor([0, 0, 1, 1, 1, 2, 2, 3, 3, 3])
    m = (torch.rand(1, 3, 5, generator=gen) > 0.4).to(torch.int8)
    ssrc, sdst, x = rnd(1, 5), rnd(1, 3), rnd(1, 5, 4)
    stab = t_seg._flash_stab(ssrc, sdst)
    out, den = t_ak.flash_gat_forward_plain(ssrc, sdst, x, m, stab)
    ct = rnd(1, 3, 4)
    srow = (ct * out).sum(dim=2)
    params = {"kernel": rnd(3, 6), "recurrent_kernel": rnd(2, 6), "bias": rnd(2, 6)}
    pallas, flash, rnn = "pallas", "flash-attn", "fused-rnn"
    return {
        "sorted_segment_sum_csr": (t_sk, "sorted_segment_sum_csr_plain", pallas,
                                   (rnd(10, 4), row_ptr)),
        "sorted_segment_sum_csr_windows": (t_sk, "sorted_segment_sum_csr_windows_plain",
                                           pallas, (rnd(10, 4), windows, 3)),
        "sorted_segment_sum_ids": (t_sk, "sorted_segment_sum_ids_plain", pallas,
                                   (rnd(10, 4), ids, 4)),
        "masked_gru_scan": (t_rk, "masked_gru_scan_plain", rnn,
                            (rnd(4, 5, 3), torch.tensor([4, 0, 2, 3, 1]), rnd(5, 2), params)),
        "flash_gat_forward": (t_ak, "flash_gat_forward_plain", flash, (ssrc, sdst, x, m, stab)),
        "flash_gat_backward": (t_ak, "flash_gat_backward_plain", flash,
                               (ssrc, sdst, x, m, stab, den, ct, srow)),
    }


WRAPPERS = sorted(_wrapper_calls())


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_never_calls_the_plain_version_past_the_operator(wrapper, monkeypatch):
    """Under 'never' a wrapper returns its plain version's result and calls
    no operator; under 'auto' a CPU tensor goes through the operator, whose
    CPU body is the same plain version."""
    module, plain, switch, args = _wrapper_calls()[wrapper]
    want = getattr(module, plain)(*args)
    for mode, operators in (("auto", 1), ("never", 0)):
        _mode(monkeypatch, switch, mode)
        with _PortOps() as ops:
            got = getattr(module, wrapper)(*args)
        assert len(ops.seen) == operators, (mode, ops.seen)
        for g, w in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
            torch.testing.assert_close(g, w, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_always_raises_on_the_cpu(wrapper, monkeypatch):
    module, _, switch, args = _wrapper_calls()[wrapper]
    _mode(monkeypatch, switch, "always")
    with pytest.raises(RuntimeError, match="'always'"):
        getattr(module, wrapper)(*args)


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_an_invalid_mode_raises(wrapper, monkeypatch):
    module, _, switch, args = _wrapper_calls()[wrapper]
    _mode(monkeypatch, switch, "sometimes")
    with pytest.raises(ValueError, match="invalid .* mode 'sometimes'"):
        getattr(module, wrapper)(*args)


def test_setters_and_defaults(monkeypatch):
    """`set_pallas_mode` and `rnn_kernels.set_mode` take the JAX values and
    raise its ValueError otherwise, in the one table of `ops.cuda`; the
    defaults are 'auto' (the JAX package's too, but for the fused scan's
    'never'); D and E follow 'never' in either switch, then 'always' in
    either."""
    assert t_cuda.modes() == ("auto",) * 3
    assert (j_seg._PALLAS_MODE, j_seg._FLASH_ATTN_MODE, j_rk._MODE) == ("auto", "auto", "never")
    for setter, switch in ((t_seg.set_pallas_mode, "pallas"), (t_rk.set_mode, "fused-rnn"),
                           (lambda m: t_cuda.set_mode("flash-attn", m), "flash-attn")):
        _mode(monkeypatch, switch, "auto")
        for mode in ("never", "always", "auto"):
            setter(mode)
            assert t_cuda._MODES[switch] == mode
        with pytest.raises(ValueError, match="invalid"):
            setter("sometimes")
        assert t_cuda._MODES[switch] == "auto"
    for pallas, flash, want in (("auto", "auto", "auto"), ("never", "always", "never"),
                                ("always", "never", "never"), ("always", "auto", "always"),
                                ("auto", "always", "always")):
        _mode(monkeypatch, "pallas", pallas)
        _mode(monkeypatch, "flash-attn", flash)
        assert t_cuda.mode("flash-attn") == want


def test_a_step_under_never_runs_no_operator(monkeypatch):
    """A training step with every switch at 'never': no kernel operator
    runs, forward or backward, and the gradients are the 'auto' step's (the
    same plain versions, differentiated by autograd where the operators'
    Functions hold the hand-written backwards)."""
    _, t_ir_, _, t_arrays, meta = _batches("mlp_message", monkeypatch)
    trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = to_device(t_arrays, "cpu")
    with _PortOps() as ops:
        want, _ = trainer.grads_fn(meta)(state.params, batch)
    assert ops.seen
    for switch in t_cuda.VARIABLES:
        _mode(monkeypatch, switch, "never")
    with _PortOps() as ops:
        got, _ = trainer.grads_fn(meta)(state.params, batch)
    assert ops.seen == []
    for k, w in flatten_params(want).items():
        g = flatten_params(got)[k]
        assert (g - w).abs().max() <= 1e-6 * max(w.abs().max(), 1e-30), k


class _HostReads(TorchDispatchMode):
    """The ops called under it that read a tensor's value back to the host
    (what a CUDA graph cannot hold), and the port's kernel operators."""

    READS = ("_local_scalar_dense", "nonzero", "repeat_interleave")

    def __init__(self):
        super().__init__()
        self.reads, self.operators = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if func.namespace == "ignnition_tpu_torch":
            self.operators.append(name)
        elif name in self.READS:
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


# switch at 'never' -> (model whose step reaches its kernels, whether its
# plain versions read back to the host)
NEVER_ALONE = {"pallas": ("mlp_message", True), "fused-rnn": ("flagship", False),
               "flash-attn": ("attention_dense", False)}


@pytest.mark.parametrize("switch", sorted(NEVER_ALONE))
def test_only_the_pallas_switch_reads_back_to_the_host(switch, monkeypatch):
    """A training step with one switch at 'never' runs its kernels' plain
    versions past the operators. Only the pallas switch's (kernel A's plain
    sum) reads a value back to the host, so only under it does a step on the
    card run eagerly and say why; under the fused-rnn or flash-attn switch
    alone it still captures. The step under 'auto' reads nothing back
    outside the operators."""
    name, reads = NEVER_ALONE[switch]
    _, t_ir_, _, t_arrays, meta = _batches(name, monkeypatch)
    trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = to_device(t_arrays, "cpu")
    with _HostReads() as auto:
        trainer.grads_fn(meta)(state.params, batch)
    kernels = {"pallas": {"csr_segment_sum", "csr_segment_sum_windows", "segment_sum_ids"},
               "fused-rnn": {"masked_gru_scan", "masked_gru_scan_backward"},
               "flash-attn": {"flash_gat_forward", "flash_gat_backward"}}[switch]
    assert auto.reads == [] and kernels & set(auto.operators), auto.operators
    _mode(monkeypatch, switch, "never")
    with _HostReads() as never:
        trainer.grads_fn(meta)(state.params, batch)
    assert not kernels & set(never.operators), never.operators
    assert bool(never.reads) == reads, never.reads
    step = capture.Graphs("cuda").step(lambda bound, inputs: inputs["x"], "key", "a step")
    if reads:
        assert "IGNNITION_TPU_PALLAS" in step.why_eager and "host" in step.why_eager
    else:
        assert step.why_eager is None


@pytest.mark.cuda
@pytest.mark.parametrize("switch", ["fused-rnn", "flash-attn"])
def test_one_switch_at_never_captures_on_the_card(switch, monkeypatch):
    """On the card, the fused-rnn or the flash-attn switch alone at 'never':
    four steps through the captured step (a warm-up, a capture, two
    replays) equal four eager steps from the same state, bitwise, and no
    call launches the switch's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ignnition_tpu_torch.ops.cuda import launch_counts

    dev = torch.device("cuda", torch.cuda.current_device())
    _, t_ir_, _, t_arrays, meta = _batches(NEVER_ALONE[switch][0], monkeypatch)
    _mode(monkeypatch, switch, "never")
    trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device=dev)
    batch = to_device(t_arrays, dev)
    eager_state = trainer.init_state(torch.Generator().manual_seed(0))
    state = trainer.init_state(torch.Generator().manual_seed(0))
    step, before, ran = trainer.train_step_fn(meta), launch_counts(), []
    for i in range(4):
        with capture.eager():
            eager_state, want = step(eager_state, batch)
        state, got = step(state, batch)
        ran.append(trainer.graphs.captured[("train", meta, None)].last)
        assert float(got["total"]) == float(want["total"]), i
    assert ran == ["warm-up", "capture", "replay", "replay"]
    for k, v in flatten_params(state.params).items():
        assert torch.equal(v, flatten_params(eager_state.params)[k]), k
    kernels = {"fused-rnn": ("masked_gru_scan", "masked_gru_scan_bwd"),
               "flash-attn": ("flash_gat_fwd", "flash_gat_bwd")}[switch]
    after = launch_counts()
    assert all(after[k] == before[k] for k in kernels), (before, after)


class _FakeGraph:
    def replay(self):
        pass


def test_a_graph_is_bound_to_the_switches(monkeypatch):
    """A graph captured under some switches replays under them only: a step
    under the pallas switch's 'never' runs eagerly and keeps the graph, back
    under the same switches it replays; under others (the fused-rnn
    switch's 'never', which captures, 'always', a lowering switch of the
    builder) the graph is dropped and the key starts again (a warm-up). The
    CUDA parts are stood in for."""
    graphs = capture.Graphs("cuda")
    step = graphs.step(lambda bound, inputs: inputs["x"] + bound["w"], "key", "a step")

    def fake_capture(self, bound, inputs):
        self._static, self._graph = dict(inputs), _FakeGraph()
        self._outputs = self.fn(bound, inputs)

    monkeypatch.setattr(capture.CapturedStep, "_warm_up", lambda self, b, i: self.fn(b, i))
    monkeypatch.setattr(capture.CapturedStep, "_capture", fake_capture)
    monkeypatch.setattr(capture.CapturedStep, "_fill", lambda self, inputs: None)
    bound, ran = {"w": torch.ones(2)}, []
    for switch, mode in (("pallas", "auto"), ("pallas", "auto"), ("pallas", "auto"),
                         ("pallas", "never"), ("pallas", "auto"), ("fused-rnn", "never"),
                         ("fused-rnn", "never"), ("fused-rnn", "never"), ("fused-rnn", "auto"),
                         ("pallas", "always"), ("pallas", "always"), ("pallas", "always")):
        _mode(monkeypatch, switch, mode)
        step(bound, {"x": torch.zeros(2)})
        ran.append(step.last)
    assert ran == ["warm-up", "capture", "replay", "eager", "replay",
                   "warm-up", "capture", "replay", "warm-up",
                   "warm-up", "capture", "replay"]
    # a lowering switch of the builder likewise
    monkeypatch.setattr(t_builder, "_SLOT_ATTN", not t_builder._SLOT_ATTN)
    step(bound, {"x": torch.zeros(2)})
    assert step.last == "warm-up"


def test_export_records_what_the_switches_pick(monkeypatch):
    """`torch.export` of a forward over the dense incidence records kernel B
    under 'auto' and the plain scan under 'never'; past the dense cap kernel
    A's plain sum reads a row pointer, which the export refuses."""
    _, t_ir_, _, t_arrays, meta = _batches("flagship", monkeypatch)
    model = igt.build(t_ir_)
    params = model.init(torch.Generator().manual_seed(0))
    batch = to_device({k: v for k, v in t_arrays.items() if not k.startswith("label")}, "cpu")
    assert kernel_ops(export_program(model, params, meta, batch)) == ["masked_gru_scan"] * 2
    _mode(monkeypatch, "fused-rnn", "never")
    _mode(monkeypatch, "pallas", "never")
    assert kernel_ops(export_program(model, params, meta, batch)) == []
    monkeypatch.setattr(t_graph, "_DENSE_INC_MAX_ENTRIES", 0)
    arrays, meta = igt.build_batch(
        [igt.convert_sample(make_routenet_sample(np.random.default_rng(0), 32, 24, 6),
                            igt.SampleSpec.from_ir(t_ir_))], t_ir_,
        igt.PaddingConfig(mode="multiple", multiple=64, min_size=64))
    batch = to_device({k: v for k, v in arrays.items() if not k.startswith("label")}, "cpu")
    with pytest.raises(Exception, match="data-dependent"):
        export_program(model, params, meta, batch)


# --------------------------------------------------------------------------
# iteration rematerialization
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["flagship", "attention_past_cap", "mlp_message_windowed"])
def test_remat_gradients_match_the_plain_step(name, monkeypatch):
    """`_ITER_REMAT = "always"`: each iteration runs under the checkpoint
    (once an iteration, in a step that records gradients, none in a
    forward), and every gradient leaf lies within 1e-6 of its largest entry
    of the plain step's: the dense sum's cached upcast, the windowed slice
    sort's whole permutation, kernel B's and A's Functions all recompute."""
    _, t_ir_, _, t_arrays, meta = _batches(name, monkeypatch)
    trainer = igt.Trainer(igt.build(t_ir_), compute_dtype=None, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    batch = to_device(t_arrays, "cpu")
    want, want_m = trainer.grads_fn(meta)(state.params, batch)
    calls = _count_calls(monkeypatch, ("model.builder", "checkpoint"))
    monkeypatch.setattr(t_builder, "_ITER_REMAT", "always")
    got, got_m = trainer.grads_fn(meta)(state.params, batch)
    assert calls[0] == t_ir_.num_iterations
    torch.testing.assert_close(got_m["total"], want_m["total"], atol=0.0, rtol=1e-6)
    for k, w in flatten_params(want).items():
        g = flatten_params(got)[k]
        assert (g - w).abs().max() <= REMAT_TOL * w.abs().max(), k
    with torch.no_grad():
        trainer.model.apply(state.params, batch, meta)
    assert calls[0] == t_ir_.num_iterations


# --------------------------------------------------------------------------
# destination sharding: remat and the halo overlap switch in a gloo world
# --------------------------------------------------------------------------


def test_dest_shard_remat_and_halo_overlap_switch(tmp_path):
    """At 1x2 over one graph whose partition has a halo: each rank's
    gradients with `_ITER_REMAT = "always"` within 1e-6 of each leaf's
    largest entry of the plain step's (the recompute sends the halo
    exchanges again, on both ranks in the same order), and with
    `_HALO_OVERLAP` off (extend-then-gather) as well; the forward with the
    overlap off against the JAX forward on the real rows."""
    flag = routenet_description(num_iterations=2, hs=8)
    grads = Case("grads_1x2", "es_grads", (1, 2), flag, [_raws(7, 1, (40, 30, 5))],
                 pad=ONE_GRAPH_PAD)
    fwd = Case("fwd_1x2_no_overlap", "es_apply", (1, 2), flag, [_raws(5, 2)])
    assert grads.halo_rows() > 0 and fwd.halo_rows() > 0
    jobs = [grads.job(settings={"plain": {}, "remat": {"_ITER_REMAT": "always"},
                                "no_overlap": {"_HALO_OVERLAP": False}}),
            fwd.job(builder={"_HALO_OVERLAP": False})]
    ranks = spawn_world(2, jobs, str(tmp_path / "world"))
    for r in range(2):
        got = ranks[r]["grads_1x2"]
        for setting in ("remat", "no_overlap"):
            for k, w in got["plain"].items():
                scale = np.abs(w).max()
                assert scale > 0, k
                assert np.abs(got[setting][k] - w).max() <= REMAT_TOL * scale, (setting, k)
    preds = ranks[0]["fwd_1x2_no_overlap"][0]
    np.testing.assert_array_equal(ranks[1]["fwd_1x2_no_overlap"][0], preds)
    mask = _real_rows(fwd)
    np.testing.assert_allclose(preds[:mask.size][mask], fwd.j_forward()[mask],
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# public names
# --------------------------------------------------------------------------

# the JAX package's module -> its names the port does not export, with why:
# `parallel.replicated` is a JAX NamedSharding; `parallel.replicate` (the
# broadcast of a tree from the mesh's first rank) is the port's counterpart
EXCEPTED = {"parallel": {"replicated"}}
PUBLIC = ["", "data", "frontend", "model", "nn", "ops", "parallel", "parallel.locality",
          "training", "utils"]


def test_every_module_with_public_names_is_held():
    """Each module of the JAX package that lists `__all__` is in `PUBLIC`."""
    found = set()
    for path in (REPO / "ignnition_tpu").rglob("*.py"):
        if "__all__" in path.read_text():
            rel = path.relative_to(REPO / "ignnition_tpu").with_suffix("")
            parts = [p for p in rel.parts if p != "__init__"]
            found.add(".".join(parts))
    assert found == set(PUBLIC)


@pytest.mark.parametrize("module", PUBLIC)
def test_public_names_match_the_jax_package(module):
    """Every name of the JAX module's `__all__` is in the port module's and
    resolves there (the port may export more: `Trainer`, `ServingModel`,
    ...), but for the excepted ones."""
    import importlib

    suffix = f".{module}" if module else ""
    jax_mod = importlib.import_module("ignnition_tpu" + suffix)
    port_mod = importlib.import_module("ignnition_tpu_torch" + suffix)
    want = set(jax_mod.__all__) - EXCEPTED.get(module, set())
    assert not want - set(port_mod.__all__), sorted(want - set(port_mod.__all__))
    for name in want:
        assert getattr(port_mod, name) is not None, name
    if module == "parallel":
        assert "replicate" in port_mod.__all__ and callable(port_mod.replicate)
