"""The port's training slice against the JAX package, on the CPU.

Inputs come from seeded numpy and go through both packages:
  * each hand-written backward of `ops/segment.py` against `jax.grad` of its
    JAX counterpart, on the companion arrays of a real `build_batch`
    (the windowed slice sort with `_SLICE_SORT_CHUNK` patched small in both);
  * every loss and learning-rate schedule against the JAX function;
  * the optimizers against optax over a few steps;
  * the flagship slice at hs=8 with 2 iterations: loss, regularization,
    every gradient leaf (atol = rtol = 1e-4) and a 10-step Adam trajectory
    of loss and parameters against the JAX `Trainer.train_step_fn` from the
    same weights, on the dense, CSR and sliced stage-2 branches;
  * the same for the attention family (stage 2 aggregating by attention) on
    its dense, block-diagonal and per-edge branches, the three attention
    leaves named.
On the CPU the kernel wrappers run their plain versions; the kernels
themselves are held to those on a CUDA device (tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ignnition_tpu.data.graph as j_graph
import ignnition_tpu_torch as igt
import ignnition_tpu_torch.data.graph as t_graph
from ignnition_tpu.frontend.ir import OptimizerSpec as JOptimizerSpec
from ignnition_tpu.frontend.ir import ScheduleSpec as JScheduleSpec
from ignnition_tpu.model import build as j_build
from ignnition_tpu.nn import rnn as j_rnn
from ignnition_tpu.ops import segment as j_seg
from ignnition_tpu.training import losses as j_losses
from ignnition_tpu.training import optimizers as j_opt
from ignnition_tpu.training.trainer import Trainer as JTrainer
from ignnition_tpu_torch.batch import to_device
from ignnition_tpu_torch.frontend.ir import OptimizerSpec, ScheduleSpec
from ignnition_tpu_torch.model.builder import flatten_params
from ignnition_tpu_torch.nn import rnn as t_rnn
from ignnition_tpu_torch.ops import segment as t_seg
from ignnition_tpu_torch.ops.cuda import segment_kernels as t_sk
from ignnition_tpu_torch.training import losses as t_losses
from ignnition_tpu_torch.training import optimizers as t_opt

from test_torch_model import (
    ATTENTION_BRANCHES, BRANCHES, QSIZE_BRANCHES, STAGE1_VARIANTS, UNMAPPED, _batches,
    flagship_dict, prepared_batches, qsize_dict, sequence_variant, to_attention,
)

torch.set_num_threads(1)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
SLICE_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _jax_flat(tree):
    return {
        "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(tree)
    }


# --------------------------------------------------------------------------
# the hand-written backwards of ops/segment.py
# --------------------------------------------------------------------------


def _csr_batch(monkeypatch, chunk=None):
    """One flagship batch past the dense-incidence cap, built by each package
    (so every CSR companion array is there), as (jax arrays, port tensors)."""
    for g in (j_graph, t_graph):
        monkeypatch.setattr(g, "_DENSE_INC_MAX_ENTRIES", 0)
        if chunk is not None:
            monkeypatch.setattr(g, "_SLICE_SORT_CHUNK", chunk)
    _, _, j_arrays, t_arrays, meta = _batches(flagship_dict(), 1)
    return j_arrays, to_device(t_arrays, "cpu"), meta


@pytest.mark.parametrize("chunk", [None, 50], ids=["one_window", "windowed"])
def test_gather_state_slices_backward_matches_jax(monkeypatch, chunk):
    j, t, meta = _csr_batch(monkeypatch, chunk)
    a = "adj_links_paths"
    n_src = meta.nodes("link")
    windows = (j[f"slice_sort_row_ptr_{a}"].shape[0] - 1) // n_src
    assert (windows > 1) == (chunk is not None)
    rng = np.random.default_rng(0)
    states = rng.standard_normal((n_src, 8)).astype(np.float32)
    ct = rng.standard_normal(j[f"slice_src_{a}"].shape + (8,)).astype(np.float32)
    keys = ("slice_src", "slice_sort_perm", "slice_sort_ids", "slice_sort_row_ptr")

    want = jax.grad(
        lambda s: jnp.sum(j_seg.gather_state_slices(s, *(j[f"{k}_{a}"] for k in keys)) * ct)
    )(jnp.asarray(states))
    x = _t(states).requires_grad_(True)
    out = t_seg.gather_state_slices(x, *(t[f"{k}_{a}"] for k in keys))
    (got,) = torch.autograd.grad(out, x, _t(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # the hand-written transpose equals autograd's scatter-add
    x2 = _t(states).requires_grad_(True)
    (auto,) = torch.autograd.grad(
        t_seg.gather_state_slices(x2, t[f"slice_src_{a}"]), x2, _t(ct)
    )
    np.testing.assert_allclose(got.numpy(), auto.numpy(), **F32_TOL)


@pytest.mark.parametrize("chunk", [23, 50, 97, 200])
def test_windowed_sum_plain_matches_per_window_loop_and_jax(monkeypatch, chunk):
    """Kernel A's windowed entry (its plain version here): one sum over the
    row pointers of every window equals a sum per window with local indices,
    and the JAX package's windowed `gather_state_slices` gradient."""
    j, t, meta = _csr_batch(monkeypatch, chunk)
    a = "adj_links_paths"
    n_src = meta.nodes("link")
    rp, perm = t[f"slice_sort_row_ptr_{a}"], t[f"slice_sort_perm_{a}"]
    windows = (rp.shape[0] - 1) // n_src
    assert windows > 1
    rng = np.random.default_rng(chunk)
    ct = rng.standard_normal(tuple(t[f"slice_src_{a}"].shape) + (8,)).astype(np.float32)
    flat = _t(ct).reshape(-1, 8)
    n_slots = flat.shape[0]
    w = -(-n_slots // windows)

    whole = t_seg._whole_sort_perm(perm, windows)
    assert t_seg._whole_sort_perm(perm, windows) is whole  # made once per tensor
    np.testing.assert_array_equal(
        whole.numpy(), perm.numpy() + (np.arange(n_slots) // w) * w)
    before = t_sk.launch_count
    got = t_sk.sorted_segment_sum_csr_windows(flat[whole], rp, n_src)
    assert got.dtype == torch.float32 and t_sk.launch_count == before

    loop = torch.zeros_like(got)
    for c in range(windows):
        lo, hi = c * w, min((c + 1) * w, n_slots)
        loop += t_sk.sorted_segment_sum_csr(
            flat[lo:hi][perm[lo:hi]], rp[c * n_src : (c + 1) * n_src + 1] - lo)
    np.testing.assert_allclose(got.numpy(), loop.numpy(), **F32_TOL)

    keys = ("slice_src", "slice_sort_perm", "slice_sort_ids", "slice_sort_row_ptr")
    want = jax.grad(
        lambda s: jnp.sum(j_seg.gather_state_slices(s, *(j[f"{k}_{a}"] for k in keys)) * ct)
    )(jnp.zeros((n_src, 8), jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_whole_sort_perm_follows_its_tensor():
    """The whole permutation is kept on the local one and made anew when
    that tensor changes in place or the windows do."""
    perm = torch.tensor([1, 0, 2, 0, 1, 2, 0], dtype=torch.int32)
    first = t_seg._whole_sort_perm(perm, 3)  # windows of 3, 3 and 1 slots
    assert first.dtype == torch.int64 and first.tolist() == [1, 0, 2, 3, 4, 5, 6]
    assert t_seg._whole_sort_perm(perm, 3) is first
    assert t_seg._whole_sort_perm(perm, 2).tolist() == [1, 0, 2, 0, 5, 6, 4]
    perm[0], perm[1] = 0, 1
    assert t_seg._whole_sort_perm(perm, 3).tolist() == [0, 1, 2, 3, 4, 5, 6]


def test_gather_state_slices_backward_keeps_state_dtype(monkeypatch):
    _, t, meta = _csr_batch(monkeypatch)
    a = "adj_links_paths"
    x = torch.zeros((meta.nodes("link"), 8), dtype=torch.bfloat16, requires_grad=True)
    out = t_seg.gather_state_slices(
        x, t[f"slice_src_{a}"], t[f"slice_sort_perm_{a}"], t[f"slice_sort_ids_{a}"],
        t[f"slice_sort_row_ptr_{a}"],
    )
    (g,) = torch.autograd.grad(out, x, torch.ones_like(out))
    assert t[f"slice_sort_row_ptr_{a}"].dtype == torch.int32  # kernel A's type
    assert g.dtype == torch.bfloat16  # kernel A sums in f32; cast back


def _edge_case(j, a, rng, width=8):
    """Messages of one adjacency (zero on padding edges, as the model makes
    them) and the edge mask, from seeded numpy."""
    emask = j[f"edge_mask_{a}"]
    messages = rng.standard_normal((emask.shape[0], width)).astype(np.float32)
    return messages, emask


def test_gather_time_slices_matches_jax(monkeypatch):
    """Forward and backward (one flat gather) against the JAX custom VJP,
    with the edge-mask multiply upstream that annihilates what the backward
    credits to padding edges."""
    j, t, meta = _csr_batch(monkeypatch)
    a = "adj_links_paths"
    L = meta.maxlen(a)
    messages, emask = _edge_case(j, a, np.random.default_rng(5))
    args_j = (j[f"row_ptr_{a}"][:-1], j[f"seq_{a}"], j[f"dst_{a}"])
    want = j_rnn.gather_time_slices(jnp.asarray(messages) * emask[:, None], *args_j, L)
    ct = np.random.default_rng(6).standard_normal(want.shape).astype(np.float32)
    want_g = jax.grad(lambda m: jnp.sum(
        j_rnn.gather_time_slices(m * emask[:, None], *args_j, L) * ct))(jnp.asarray(messages))
    x = _t(messages).requires_grad_(True)
    out = t_rnn.gather_time_slices(
        x * t[f"edge_mask_{a}"][:, None], t[f"row_ptr_{a}"][:-1], t[f"seq_{a}"],
        t[f"dst_{a}"], L,
    )
    (got_g,) = torch.autograd.grad(out, x, _t(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **F32_TOL)
    assert np.abs(np.asarray(want_g)[emask == 0]).max() == 0.0


def test_scatter_to_sequences_and_segment_count_match_jax(monkeypatch):
    j, t, meta = _csr_batch(monkeypatch)
    a = "adj_links_paths"
    n, L = meta.nodes("path"), meta.maxlen(a)
    messages, emask = _edge_case(j, a, np.random.default_rng(7))
    messages = messages * emask[:, None]
    want = j_seg.scatter_to_sequences(jnp.asarray(messages), j[f"dst_{a}"], j[f"seq_{a}"], n, L)
    ct = np.random.default_rng(8).standard_normal(want.shape).astype(np.float32)
    want_g = jax.grad(lambda m: jnp.sum(j_seg.scatter_to_sequences(
        m, j[f"dst_{a}"], j[f"seq_{a}"], n, L) * ct))(jnp.asarray(messages))
    x = _t(messages).requires_grad_(True)
    out = t_seg.scatter_to_sequences(x, t[f"dst_{a}"], t[f"seq_{a}"], n, L)
    (got_g,) = torch.autograd.grad(out, x, _t(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **F32_TOL)
    count = t_seg.segment_count(t[f"dst_{a}"], n, t[f"edge_mask_{a}"])
    want_count = j_seg.segment_count(j[f"dst_{a}"], n, j[f"edge_mask_{a}"])
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    np.testing.assert_array_equal(count.numpy(), j[f"lens_{a}"])


@pytest.mark.parametrize("chunk", [None, 50], ids=["one_window", "windowed"])
def test_interleave_slice_gather_backward_matches_jax(monkeypatch, chunk):
    """The Q-size interleave's combined slice map over the stacked link and
    node tables: `gather_state_slices`' backward (kernel A's plain version
    over `ilv_sort_*`, several windows when the chunk is small) against
    `jax.grad`. Its windows count the combined table's rows."""
    entry = (2, False, ()) + (() if chunk is None else (chunk,))
    j, t, meta = prepared_batches(qsize_dict(), entry, monkeypatch)[2:]
    t = to_device(t, "cpu")
    tag = "path_s0m0"
    rows = meta.nodes("link") + meta.nodes("node")
    windows = (j[f"ilv_sort_row_ptr_{tag}"].shape[0] - 1) // rows
    assert (windows > 1) == (chunk is not None)
    keys = ("ilv_slice", "ilv_sort_perm", "ilv_sort_ids", "ilv_sort_row_ptr")
    rng = np.random.default_rng(9)
    states = rng.standard_normal((rows, 8)).astype(np.float32)
    ct = rng.standard_normal(j[f"ilv_slice_{tag}"].shape + (8,)).astype(np.float32)
    want = jax.grad(
        lambda s: jnp.sum(j_seg.gather_state_slices(s, *(j[f"{k}_{tag}"] for k in keys)) * ct)
    )(jnp.asarray(states))
    x = _t(states).requires_grad_(True)
    out = t_seg.gather_state_slices(x, *(t[f"{k}_{tag}"] for k in keys))
    (got,) = torch.autograd.grad(out, x, _t(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("fn", ["direct_segment_sum", "direct_segment_sum_sliced"])
def test_direct_segment_sum_backward_matches_jax(monkeypatch, fn):
    j, t, meta = _csr_batch(monkeypatch)
    a = "adj_paths_links"
    n_src, n_dst = meta.nodes("path"), meta.nodes("link")
    rng = np.random.default_rng(1)
    states = rng.standard_normal((n_src, 8)).astype(np.float32)
    ct = rng.standard_normal((n_dst, 8)).astype(np.float32)
    common = ("src", "dst", "edge_mask", "row_ptr")
    if fn == "direct_segment_sum":
        extra = ("dst_in_src_order", "emask_src_order", "src_sorted", "src_row_ptr")
        t_extra = ("dst_in_src_order", "src_row_ptr")
    else:
        extra = t_extra = ("bwd_slice_dst", "out_lens")

    def j_loss(s):
        args = [j[f"{k}_{a}"] for k in common + extra]
        return jnp.sum(getattr(j_seg, fn)(s, *args, n_dst, n_src) * ct)

    want = jax.grad(j_loss)(jnp.asarray(states))
    x = _t(states).requires_grad_(True)
    out = getattr(t_seg, fn)(
        x, t[f"src_{a}"], t[f"row_ptr_{a}"], n_dst, *(t[f"{k}_{a}"] for k in t_extra)
    )
    (got,) = torch.autograd.grad(out, x, _t(ct))
    real = j[f"node_mask_path"] > 0  # padding sources get no real edge
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], **F32_TOL)
    # and equals autograd through the gather and the CSR sum
    x2 = _t(states).requires_grad_(True)
    (auto,) = torch.autograd.grad(
        getattr(t_seg, fn)(x2, t[f"src_{a}"], t[f"row_ptr_{a}"], n_dst), x2, _t(ct)
    )
    np.testing.assert_allclose(got.numpy(), auto.numpy(), **F32_TOL)


# --------------------------------------------------------------------------
# losses, schedules, optimizers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(t_losses.LOSSES))
def test_loss_and_its_gradient_match_jax(name):
    assert sorted(t_losses.LOSSES) == sorted(j_losses.LOSSES)
    rng = np.random.default_rng(2)
    n = 40
    mask = (rng.random(n) < 0.8).astype(np.float32)
    if name in ("BinaryCrossentropy", "KLDivergence"):
        labels = rng.random(n).astype(np.float32)
        preds = rng.uniform(0.05, 0.95, n).astype(np.float32)
    elif name in ("Hinge", "SquaredHinge"):
        labels = rng.integers(0, 2, n).astype(np.float32)
        preds = rng.standard_normal(n).astype(np.float32)
    else:
        labels = rng.uniform(0.1, 2.0, n).astype(np.float32)
        preds = rng.uniform(0.1, 2.0, n).astype(np.float32)
        preds[mask == 0] = -3.0  # padding rows hold anything
    j_fn, t_fn = j_losses.get_loss(name), t_losses.get_loss(name)
    want, want_g = jax.value_and_grad(lambda p: j_fn(labels, p, mask))(jnp.asarray(preds))
    p = _t(preds).requires_grad_(True)
    got = t_fn(_t(labels), p, _t(mask))
    (got_g,) = torch.autograd.grad(got, p)
    np.testing.assert_allclose(got.item(), float(want), **F32_TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **F32_TOL)
    assert t_losses.loss_reduction(t_fn) == j_losses.loss_reduction(j_fn)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="unknown loss 'Nope'"):
        t_losses.get_loss("Nope")


SCHEDULES = {
    "ExponentialDecay": {"initial_learning_rate": 0.001, "decay_steps": 7, "decay_rate": 0.6},
    "ExponentialDecay_staircase": {"initial_learning_rate": 0.01, "decay_steps": 4,
                                   "decay_rate": 0.5, "staircase": "True"},
    "InverseTimeDecay": {"initial_learning_rate": 0.1, "decay_steps": 5, "decay_rate": 0.7},
    "InverseTimeDecay_staircase": {"initial_learning_rate": 0.1, "decay_steps": 5,
                                   "decay_rate": 0.7, "staircase": True},
    "PolynomialDecay": {"initial_learning_rate": 0.1, "decay_steps": 12, "power": 2.0},
    "PiecewiseConstantDecay": {"boundaries": [3, 9], "values": [0.1, 0.01, 0.001]},
    "CosineDecay": {"initial_learning_rate": 0.1, "decay_steps": 15, "alpha": 0.1},
    "CosineDecayRestarts": {"initial_learning_rate": 0.1, "first_decay_steps": 4,
                            "t_mul": 2.0, "m_mul": 0.9, "alpha": 0.05},
    "CosineDecayRestarts_tmul1": {"initial_learning_rate": 0.1, "first_decay_steps": 5,
                                  "t_mul": 1.0},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    kind = name.split("_")[0]
    want_fn = j_opt.build_schedule(JScheduleSpec(kind=kind, params=SCHEDULES[name]))
    got_fn = t_opt.build_schedule(ScheduleSpec(kind=kind, params=SCHEDULES[name]))
    for step in list(range(0, 22)) + [100]:
        # the JAX schedules compute in float32
        np.testing.assert_allclose(
            got_fn(step), float(want_fn(jnp.asarray(step))), rtol=2e-6, atol=1e-12,
            err_msg=f"step {step}",
        )


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown learning-rate schedule"):
        t_opt.build_schedule(ScheduleSpec(kind="Nope", params={}))


OPTIMIZERS = {
    "adam_schedule": ("Adam", {}, ("ExponentialDecay", SCHEDULES["ExponentialDecay"])),
    "adam_betas_clipvalue": ("Adam", {"learning_rate": 0.01, "beta_1": 0.8, "beta_2": 0.99,
                                      "epsilon": 1e-6, "clipvalue": 0.5}, None),
    "adam_global_clipnorm": ("Adam", {"learning_rate": 0.01, "global_clipnorm": 1.0}, None),
    "sgd": ("SGD", {"learning_rate": 0.05}, None),
    "sgd_momentum_clipnorm": ("SGD", {"learning_rate": 0.05, "momentum": 0.9,
                                      "clipnorm": 1.0}, None),
    "sgd_nesterov": ("SGD", {"learning_rate": 0.05, "momentum": 0.8, "nesterov": "true"}, None),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trajectory_matches_optax(name):
    import optax

    kind, params, sched = OPTIMIZERS[name]
    j_tx = j_opt.build_optimizer(JOptimizerSpec(
        kind=kind, params=params,
        schedule=None if sched is None else JScheduleSpec(kind=sched[0], params=sched[1])))
    t_tx = t_opt.build_optimizer(OptimizerSpec(
        kind=kind, params=params,
        schedule=None if sched is None else ScheduleSpec(kind=sched[0], params=sched[1])))
    rng = np.random.default_rng(3)
    p0 = {"a": {"kernel": rng.standard_normal((4, 3)).astype(np.float32)},
          "b": (rng.standard_normal(5).astype(np.float32),)}
    j_params = jax.tree.map(jnp.asarray, p0)
    j_state = j_tx.init(j_params)
    t_params = igt.params_from_jax(p0)
    t_state = t_tx.init(t_params)
    for _ in range(6):
        g = {"a": {"kernel": rng.standard_normal((4, 3)).astype(np.float32)},
             "b": (3.0 * rng.standard_normal(5).astype(np.float32),)}
        updates, j_state = j_tx.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_tx.step(t_params, igt.params_from_jax(g), t_state)
        want = _jax_flat(j_params)
        for k, v in flatten_params(t_params).items():
            np.testing.assert_allclose(v.numpy(), want[k], atol=1e-6, rtol=1e-6, err_msg=k)
    assert t_state["count"] == 6


def test_optimizer_options_raise_as_in_jax():
    spec = lambda kind, **p: OptimizerSpec(kind=kind, params=p, schedule=None)
    with pytest.raises(ValueError, match="unsupported Adam option"):
        t_opt.build_optimizer(spec("Adam", momentum=0.9))
    with pytest.raises(ValueError, match="at most one of clipvalue"):
        t_opt.build_optimizer(spec("SGD", clipvalue=1.0, clipnorm=1.0))
    with pytest.raises(ValueError, match="unknown optimizer 'Nope'"):
        t_opt.build_optimizer(spec("Nope"))
    with pytest.raises(ValueError, match="unsupported RMSprop option"):
        t_opt.build_optimizer(spec("RMSprop", beta_1=0.9))
    with pytest.raises(ValueError, match="unsupported Nadam option"):
        t_opt.build_optimizer(spec("Nadam", amsgrad=True))
    # every kind and option of the JAX package builds
    for kind, opts in t_opt._KNOWN_OPT_KW.items():
        t_opt.build_optimizer(spec(kind, **{k: True if k in ("amsgrad", "nesterov", "centered")
                                            else 0.5 for k in opts}))


# --------------------------------------------------------------------------
# the slice as a whole: loss, reg, gradients, Adam trajectory
# --------------------------------------------------------------------------

TRAIN_BRANCHES = ["dense", "csr_direct", "csr_sliced"]


def _trainers(branch, monkeypatch, compute_dtype=None, attention=False, desc=None,
              branches=None):
    if branches is None:
        branches = ATTENTION_BRANCHES if attention else BRANCHES
    if desc is None:
        desc = flagship_dict(mutate=to_attention if attention else None)
    j_ir, t_ir, j_arrays, t_arrays, meta = prepared_batches(
        desc, branches[branch], monkeypatch
    )
    j_trainer = JTrainer(
        j_build(j_ir), compute_dtype=None if compute_dtype is None else jnp.bfloat16
    )
    t_trainer = igt.Trainer(igt.build(t_ir), compute_dtype=compute_dtype, device="cpu")
    j_state = j_trainer.init_state(jax.random.PRNGKey(0))
    t_state = t_trainer.init_state(params=igt.params_from_jax(j_state.params))
    return j_trainer, t_trainer, j_state, t_state, j_arrays, to_device(t_arrays, "cpu"), meta


def _check_loss_and_gradients(trainers):
    j_tr, t_tr, j_state, t_state, j_batch, t_batch, meta = trainers
    rng = jax.random.PRNGKey(1)
    (want_total, (want_loss, want_reg)), want_g = jax.value_and_grad(
        j_tr._loss, has_aux=True
    )(j_state.params, j_batch, meta, rng)
    got_g, got = t_tr.grads_fn(meta)(t_state.params, t_batch)
    np.testing.assert_allclose(got["loss"].item(), float(want_loss), **SLICE_TOL)
    np.testing.assert_allclose(got["reg"].item(), float(want_reg), **SLICE_TOL)
    np.testing.assert_allclose(got["total"].item(), float(want_total), **SLICE_TOL)
    want_flat = _jax_flat(want_g)
    got_flat = flatten_params(got_g)
    assert sorted(got_flat) == sorted(want_flat)
    for k, v in got_flat.items():
        assert v.dtype == torch.float32
        assert np.abs(want_flat[k]).max() > 0, k
        np.testing.assert_allclose(v.numpy(), want_flat[k], err_msg=k, **SLICE_TOL)
    return got_flat


@pytest.mark.parametrize("branch", TRAIN_BRANCHES)
def test_flagship_loss_and_gradients_match_jax(branch, monkeypatch):
    _check_loss_and_gradients(_trainers(branch, monkeypatch))


ATTENTION_LEAVES = [f"aggregation/s1/m0/{k}" for k in ("kernel1", "kernel2", "attn_kernel")]


@pytest.mark.parametrize("branch", sorted(ATTENTION_BRANCHES))
def test_attention_loss_and_gradients_match_jax(branch, monkeypatch):
    """At these small random weights the attention is near uniform and its
    leaves' gradients are of order 1e-5, below the slice's absolute limit,
    so they are held relative to each leaf's largest entry as well: 5e-3
    (both packages carry f32 noise of ~3e-8 on them). `kernel2` reaches the
    loss only where a row's pre-activations change sign (a per-destination
    shift leaves a softmax unchanged): its gradient is noise in both."""
    trainers = _trainers(branch, monkeypatch, attention=True)
    got = _check_loss_and_gradients(trainers)
    assert [k for k in got if k.startswith("aggregation")] == ATTENTION_LEAVES
    j_tr, _, j_state, _, j_batch, _, meta = trainers
    _, want_g = jax.value_and_grad(j_tr._loss, has_aux=True)(
        j_state.params, j_batch, meta, jax.random.PRNGKey(1)
    )
    want = _jax_flat(want_g)
    for k in ATTENTION_LEAVES:
        top = np.abs(want[k]).max()
        if k.endswith("kernel2"):
            assert top < 1e-6 and np.abs(got[k].numpy()).max() < 1e-6
        else:
            assert top > 1e-5
            assert np.abs(got[k].numpy() - want[k]).max() <= 5e-3 * top, k


def _check_adam_trajectory(trainers, noise_floor=0.0, lr=0.001):
    """Ten Adam steps from the same weights: loss, reg and total at every step,
    and the parameters after every step.

    Adam divides by sqrt(v) + 1e-7, so an element whose gradient is at the
    f32 rounding noise of the two implementations (|g| < ~1e-6: the columns
    fed by zero-padded state dimensions) takes a step of either sign: those
    elements are held to the most they can have moved (2 * lr per step), and
    every element whose first gradient is above 1e-3 of its leaf's largest
    (and above `noise_floor`, for leaves whose whole gradient is small) to
    atol = rtol = 1e-4. `lr`: the model's largest learning rate (the
    flagship's initial 0.001 by default)."""
    j_tr, t_tr, j_state, t_state, j_batch, t_batch, meta = trainers
    j_step, t_step = j_tr.train_step_fn(meta), t_tr.train_step_fn(meta)
    params, opt_state = j_state.params, j_state.opt_state
    rng = jax.random.PRNGKey(1)
    (_, _), g0 = jax.value_and_grad(j_tr._loss, has_aux=True)(params, j_batch, meta, rng)
    firm = {
        k: np.abs(g) >= max(1e-3 * np.abs(g).max(), noise_floor)
        for k, g in _jax_flat(g0).items()
    }
    # (an attention pass's `kernel2` gradient is noise as a whole)
    assert all(m.any() for k, m in firm.items() if not k.endswith("kernel2"))
    first = None
    for i in range(10):
        params, opt_state, want = j_step(params, opt_state, j_batch, rng)
        t_state, got = t_step(t_state, t_batch)
        for k in ("loss", "reg", "total"):
            np.testing.assert_allclose(
                got[k].item(), float(want[k]), err_msg=f"step {i} {k}", **SLICE_TOL
            )
        first = got["total"].item() if first is None else first
        want_flat = _jax_flat(params)
        for k, v in flatten_params(t_state.params).items():
            v = v.detach().numpy()
            np.testing.assert_allclose(
                v[firm[k]], want_flat[k][firm[k]], err_msg=f"step {i} {k}", **SLICE_TOL
            )
            assert np.abs(v - want_flat[k]).max() <= 2 * lr * (i + 1), f"step {i} {k}"
    assert t_state.step == 10 and t_state.opt_state["count"] == 10
    assert got["total"].item() < first


@pytest.mark.parametrize("branch", TRAIN_BRANCHES)
def test_flagship_adam_trajectory_matches_jax(branch, monkeypatch):
    _check_adam_trajectory(_trainers(branch, monkeypatch))


@pytest.mark.parametrize("branch", sorted(ATTENTION_BRANCHES))
def test_attention_adam_trajectory_matches_jax(branch, monkeypatch):
    """The attention leaves' gradients are of order 1e-5 here with f32 noise
    of ~3e-8: elements under 5e-6 count as noise."""
    _check_adam_trajectory(_trainers(branch, monkeypatch, attention=True), noise_floor=5e-6)


# Q-size on each of its branches, stage 1 of Q-size by concat and by
# multi-source ordered, and the flagship's ordered update without its slice
# map (tests/test_torch_model.py names each)
SEQUENCE_SLICES = sorted(QSIZE_BRANCHES) + sorted(STAGE1_VARIANTS) + sorted(UNMAPPED)


def _sequence_trainers(name, monkeypatch, compute_dtype=None):
    if name in QSIZE_BRANCHES:
        return _trainers(name, monkeypatch, compute_dtype, desc=qsize_dict(),
                         branches=QSIZE_BRANCHES)
    if name in STAGE1_VARIANTS:
        desc, entry = sequence_variant(name)
        return _trainers(name, monkeypatch, compute_dtype, desc=desc, branches={name: entry})
    return _trainers(name, monkeypatch, compute_dtype, branches=UNMAPPED)


@pytest.mark.parametrize("name", SEQUENCE_SLICES)
def test_sequence_slices_loss_and_gradients_match_jax(name, monkeypatch):
    _check_loss_and_gradients(_sequence_trainers(name, monkeypatch))


@pytest.mark.parametrize("name", SEQUENCE_SLICES)
def test_sequence_slices_adam_trajectory_matches_jax(name, monkeypatch):
    _check_adam_trajectory(_sequence_trainers(name, monkeypatch))


def test_qsize_bf16_step_and_serving_match_jax(monkeypatch):
    """Q-size in bf16 over f32 masters: the loss to bf16 precision (as the
    flagship's bf16 step), f32 gradients; then `ServingModel.predict_samples`
    on the same graph against the JAX forward, trimmed to the real paths."""
    j_tr, t_tr, j_state, t_state, j_batch, t_batch, meta = _sequence_trainers(
        "fast", monkeypatch, torch.bfloat16
    )
    (_, (want_loss, want_reg)), _ = jax.value_and_grad(j_tr._loss, has_aux=True)(
        j_state.params, j_batch, meta, jax.random.PRNGKey(1)
    )
    got_g, got = t_tr.grads_fn(meta)(t_state.params, t_batch)
    np.testing.assert_allclose(got["loss"].item(), float(want_loss), atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got["reg"].item(), float(want_reg), **SLICE_TOL)
    for k, v in flatten_params(got_g).items():
        assert v.dtype == torch.float32 and torch.isfinite(v).all(), k

    from ignnition_tpu_torch.data.synthetic import make_routenet_sample

    sample = igt.convert_sample(
        make_routenet_sample(np.random.default_rng(0), 32, 24, 6, with_nodes=True),
        igt.SampleSpec.from_ir(t_tr.ir),
    )
    server = igt.ServingModel(
        igt.build(t_tr.ir), t_state.params, meta, t_tr.ir, compute_dtype=None, device="cpu"
    )
    got_preds = server.predict_samples([sample], denormalize=False)
    arrays = server.build_batch([sample])
    want = np.asarray(j_tr.model.apply(j_state.params, arrays, meta))
    want = want[arrays["node_mask_path"] > 0]
    assert got_preds.shape == (24,)
    np.testing.assert_allclose(got_preds, want, **SLICE_TOL)


def test_attention_serving_matches_jax(monkeypatch):
    """`ServingModel` needs nothing new for the attention model."""
    j_tr, t_tr, j_state, t_state, j_batch, t_batch, meta = _trainers(
        "dense", monkeypatch, attention=True
    )
    want = np.asarray(j_tr.model.apply(j_state.params, j_batch, meta))
    server = igt.ServingModel(
        igt.build(t_tr.ir), t_state.params, meta, t_tr.ir, compute_dtype=None, device="cpu"
    )
    inputs = {k: v for k, v in t_batch.items() if k not in ("label", "label_mask")}
    np.testing.assert_allclose(server.forward_device(inputs).numpy(), want, **SLICE_TOL)


def test_flagship_bf16_step_matches_jax(monkeypatch):
    """bf16 compute over f32 masters: the gradients arrive in f32 and the
    loss agrees to bf16 precision (the two packages round at other places:
    the port's scan carries h in f32, the JAX CPU scan in bf16)."""
    j_tr, t_tr, j_state, t_state, j_batch, t_batch, meta = _trainers(
        "csr_sliced", monkeypatch, torch.bfloat16
    )
    (_, (want_loss, want_reg)), _ = jax.value_and_grad(j_tr._loss, has_aux=True)(
        j_state.params, j_batch, meta, jax.random.PRNGKey(1)
    )
    got_g, got = t_tr.grads_fn(meta)(t_state.params, t_batch)
    np.testing.assert_allclose(got["loss"].item(), float(want_loss), atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got["reg"].item(), float(want_reg), **SLICE_TOL)
    for k, v in flatten_params(got_g).items():
        assert v.dtype == torch.float32 and torch.isfinite(v).all(), k


def test_eval_step_and_serving_record_no_graph(monkeypatch):
    j_tr, t_tr, j_state, t_state, j_batch, t_batch, meta = _trainers("dense", monkeypatch)
    want_preds, want_loss = j_tr.eval_step_fn(meta)(j_state.params, j_batch)
    preds, loss = t_tr.eval_step_fn(meta)(t_state.params, t_batch)
    assert not preds.requires_grad and not loss.requires_grad
    np.testing.assert_allclose(preds.numpy(), np.asarray(want_preds), **SLICE_TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), **SLICE_TOL)
    server = igt.ServingModel(
        igt.build(t_tr.ir), t_state.params, meta, t_tr.ir, compute_dtype=None, device="cpu"
    )
    inputs = {k: v for k, v in t_batch.items() if k not in ("label", "label_mask")}
    out = server.forward_device(inputs)
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), preds.numpy(), **F32_TOL)
    assert all(v.requires_grad for v in flatten_params(t_state.params).values())


def test_train_step_updates_state_in_place(monkeypatch):
    _, t_tr, _, t_state, _, t_batch, meta = _trainers("dense", monkeypatch)
    leaves = flatten_params(t_state.params)
    before = {k: v.detach().clone() for k, v in leaves.items()}
    same, _ = t_tr.train_step_fn(meta)(t_state, t_batch)
    assert same is t_state
    for k, v in flatten_params(t_state.params).items():
        assert v is leaves[k] and v.requires_grad and v.is_leaf
        assert not torch.equal(v.detach(), before[k]), k
