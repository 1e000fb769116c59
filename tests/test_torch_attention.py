"""The port's attention primitives against the JAX package, on the CPU.

Inputs come from seeded numpy and go through both packages:
  * the plain versions of kernels D and E (flash-GAT forward and backward)
    against the Pallas kernels they replace, run in interpret mode as
    tests/test_flash_attention.py runs them: f32, atol = rtol = 1e-5 forward
    (the same sums in another order), rtol 2e-4 / atol 2e-5 backward, the
    limits of that file; the blocks form and the score-outlier case too;
  * `_flash_masked_softmax_matmul` (kernels D and E under autograd) and the
    matrix-materializing `_dense_masked_softmax_matmul` /
    `_blocks_masked_softmax_matmul`, values and gradients, against
    `jax.grad` of the JAX `_dense_masked_softmax_matmul`;
  * `dense_attention_aggregate`, `sorted_softmax_aggregate`,
    `sorted_segment_softmax` and `gather_by_dst` against JAX;
  * the id-keyed segment sum's plain version against `jax.ops.segment_sum`.
On the CPU each kernel wrapper runs its plain version; the kernel-vs-plain
cases need a CUDA device (marker `cuda`) and skip here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignnition_tpu.ops import segment as j_seg
from ignnition_tpu.ops.pallas.attention_kernels import (
    flash_gat_backward as j_flash_bwd,
    flash_gat_forward as j_flash_fwd,
    pick_tiles,
)
from ignnition_tpu_torch.ops import segment as t_seg
from ignnition_tpu_torch.ops.cuda import attention_kernels as t_ak
from ignnition_tpu_torch.ops.cuda import segment_kernels as t_sk

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-5)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _case(n_dst, n_src, d=16, seed=0, density=0.05):
    """Scores, messages, a multiplicity matrix (up to 3, row 0 empty) and a
    cotangent, as numpy f32."""
    rng = np.random.default_rng(seed)
    m = (rng.random((n_dst, n_src)) < density).astype(np.float32)
    m *= rng.integers(1, 4, (n_dst, n_src))
    m[0] = 0.0  # an isolated destination: out must be exactly 0
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(n_src), f(n_dst), f(n_src, d), m, f(n_dst, d)


def _pallas_pair(ssrc, sdst, x, m, ct):
    """The TPU kernels in interpret mode: (out, den, dtab_plus, d_sdst, stab)."""
    ssrc, sdst, x, ct = (jnp.asarray(a) for a in (ssrc, sdst, x, ct))
    mj = jnp.asarray(m, jnp.bfloat16)
    td, ts = pick_tiles(*m.shape)
    stab = j_seg._flash_stab(ssrc, sdst)
    out, den = j_flash_fwd(ssrc, sdst, x, mj, stab, td=td, ts=ts, interpret=True)
    srow = jnp.sum(ct * out.astype(jnp.float32), axis=1, keepdims=True)
    dtab_plus, d_sdst = j_flash_bwd(
        ssrc, sdst, x, mj, stab, den, ct, srow, td=td, ts=ts, interpret=True
    )
    return tuple(np.asarray(a) for a in (out, den, dtab_plus, d_sdst, stab))


def _port_pair(ssrc, sdst, x, m, ct, m_dtype=torch.int8):
    """The port's wrappers on CPU tensors (G = 1): the plain versions."""
    s1, s2, xx, cc = _t(ssrc)[None], _t(sdst)[None], _t(x)[None], _t(ct)[None]
    mm = _t(m, m_dtype)[None]
    before = (t_ak.fwd_launch_count, t_ak.bwd_launch_count)
    stab = t_seg._flash_stab(s1, s2)
    out, den = t_ak.flash_gat_forward(s1, s2, xx, mm, stab)
    srow = (cc * out.float()).sum(dim=2)
    dtab_plus, d_sdst = t_ak.flash_gat_backward(s1, s2, xx, mm, stab, den, cc, srow)
    # CPU tensors never reach the kernels
    assert (t_ak.fwd_launch_count, t_ak.bwd_launch_count) == before
    return tuple(a[0].numpy() for a in (out, den, dtab_plus, d_sdst, stab))


@pytest.mark.parametrize("m_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("shape", [(64, 256), (40, 384), (8, 128)])
def test_flash_plain_matches_pallas_kernels_f32(shape, m_dtype):
    case = _case(*shape, seed=3)
    w_out, w_den, w_dtab, w_dsdst, w_stab = _pallas_pair(*case)
    out, den, dtab, dsdst, stab = _port_pair(*case, m_dtype=m_dtype)
    np.testing.assert_allclose(stab, w_stab, **FWD_TOL)
    np.testing.assert_allclose(out, w_out, **FWD_TOL)
    np.testing.assert_allclose(den, w_den[:, 0], **FWD_TOL)
    np.testing.assert_array_equal(out[0], 0.0)  # the isolated destination
    assert den[1:].min() > 0.0
    np.testing.assert_allclose(dtab, w_dtab, **BWD_TOL)
    np.testing.assert_allclose(dsdst, w_dsdst[:, 0], **BWD_TOL)


def test_flash_plain_score_outliers_do_not_underflow_rows():
    """The case of tests/test_flash_attention.py: a +60-nat sdst outlier on
    one row and a +60-nat ssrc outlier outside another row's support. The
    per-row bound keeps every row exact against the per-row-max dense path."""
    rng = np.random.default_rng(11)
    n_dst, n_src, d = 16, 128, 8
    m = np.zeros((n_dst, n_src), np.float32)
    m[0, 1:9] = 1.0
    m[1, 0] = 1.0
    for i in range(2, n_dst):
        m[i, rng.integers(1, n_src, 6)] = 1.0
    ssrc = rng.standard_normal(n_src).astype(np.float32)
    ssrc[0] = 60.0
    sdst = rng.standard_normal(n_dst).astype(np.float32)
    sdst[1] = 60.0
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    ct = np.zeros((n_dst, d), np.float32)
    want = j_seg._dense_masked_softmax_matmul(
        jnp.asarray(ssrc), jnp.asarray(sdst), jnp.asarray(x), jnp.asarray(m, jnp.bfloat16)
    )
    out, den, *_ = _port_pair(ssrc, sdst, x, m, ct)
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-4, atol=1e-5)
    assert den.min() > 0.0  # no row underflowed to zero support
    w_out, w_den, *_ = _pallas_pair(ssrc, sdst, x, m, ct)
    np.testing.assert_allclose(out, w_out, **FWD_TOL)


def _jax_dense_grads(ssrc, sdst, x, m, ct):
    mj = jnp.asarray(m, jnp.bfloat16)

    def loss(a, b, c):
        return jnp.sum(j_seg._dense_masked_softmax_matmul(a, b, c, mj) * ct)

    args = (jnp.asarray(ssrc), jnp.asarray(sdst), jnp.asarray(x))
    out = j_seg._dense_masked_softmax_matmul(*args, mj)
    return np.asarray(out), [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize(
    "fn", ["_flash_masked_softmax_matmul", "_dense_masked_softmax_matmul"]
)
@pytest.mark.parametrize("shape", [(64, 256), (40, 384), (33, 100)])
def test_masked_softmax_matmul_values_and_gradients_match_jax(shape, fn):
    """(33, 100): a shape the TPU tiles refuse (n_dst not by 8, n_src not by
    128); the port's functions take any."""
    ssrc, sdst, x, m, ct = _case(*shape, seed=5)
    want, want_g = _jax_dense_grads(ssrc, sdst, x, m, ct)
    leaves = [_t(a).requires_grad_(True) for a in (ssrc, sdst, x)]
    out = getattr(t_seg, fn)(*leaves, _t(m, torch.int8))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, **FWD_TOL)
    got_g = torch.autograd.grad(out, leaves, _t(ct))
    for name, g, w in zip(("d_ssrc", "d_sdst", "d_table"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize(
    "fn", ["_flash_masked_softmax_matmul", "_blocks_masked_softmax_matmul"]
)
def test_blocks_masked_softmax_matmul_matches_jax(fn):
    rng = np.random.default_rng(7)
    g, bd, bs, d = 3, 16, 128, 8
    m = (rng.random((g, bd, bs)) < 0.08).astype(np.float32)
    m *= rng.integers(1, 3, (g, bd, bs))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ssrc, sdst, x, ct = f(g * bs), f(g * bd), f(g * bs, d), f(g * bd, d)
    mj = jnp.asarray(m, jnp.bfloat16)

    def loss(*a):
        return jnp.sum(j_seg._blocks_masked_softmax_matmul(*a, mj) * ct)

    args = (jnp.asarray(ssrc), jnp.asarray(sdst), jnp.asarray(x))
    want = j_seg._blocks_masked_softmax_matmul(*args, mj)
    want_g = jax.grad(loss, argnums=(0, 1, 2))(*args)
    leaves = [_t(a).requires_grad_(True) for a in (ssrc, sdst, x)]
    out = getattr(t_seg, fn)(*leaves, _t(m, torch.int8))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD_TOL)
    got_g = torch.autograd.grad(out, leaves, _t(ct))
    for g_, w in zip(got_g, want_g):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), **BWD_TOL)


def test_flash_blocks_plain_matches_pallas_per_graph():
    """The graph axis of the port's kernels against the TPU kernels run graph
    by graph (Pallas vmaps them)."""
    g, bd, bs, d = 2, 16, 128, 8
    cases = [_case(bd, bs, d, seed=20 + i, density=0.1) for i in range(g)]
    stack = lambda i, dtype=None: _t(np.stack([c[i] for c in cases]), dtype)
    s1, s2, xx, mm, cc = stack(0), stack(1), stack(2), stack(3, torch.int8), stack(4)
    stab = t_seg._flash_stab(s1, s2)
    out, den = t_ak.flash_gat_forward(s1, s2, xx, mm, stab)
    srow = (cc * out).sum(dim=2)
    dtab, dsdst = t_ak.flash_gat_backward(s1, s2, xx, mm, stab, den, cc, srow)
    for i, case in enumerate(cases):
        w_out, w_den, w_dtab, w_dsdst, _ = _pallas_pair(*case)
        np.testing.assert_allclose(out[i].numpy(), w_out, **FWD_TOL)
        np.testing.assert_allclose(den[i].numpy(), w_den[:, 0], **FWD_TOL)
        np.testing.assert_allclose(dtab[i].numpy(), w_dtab, **BWD_TOL)
        np.testing.assert_allclose(dsdst[i].numpy(), w_dsdst[:, 0], **BWD_TOL)


def test_flash_rounds_to_the_message_dtype():
    """bf16 messages: out comes back bf16, den and the gradients' sums f32,
    and the backward hands each input its own dtype."""
    ssrc, sdst, x, m, ct = _case(40, 384, seed=9)
    leaves = [_t(ssrc).requires_grad_(True), _t(sdst).requires_grad_(True),
              _t(x, torch.bfloat16).requires_grad_(True)]
    out = t_seg._flash_masked_softmax_matmul(*leaves, _t(m, torch.int8))
    assert out.dtype == torch.bfloat16
    g = torch.autograd.grad(out, leaves, _t(ct, torch.bfloat16))
    assert [t.dtype for t in g] == [torch.float32, torch.float32, torch.bfloat16]
    want, _ = _jax_dense_grads(ssrc, sdst, np.asarray(_t(x, torch.bfloat16).float()), m, ct)
    # one bf16 rounding of z and one of out, |out| < 4
    np.testing.assert_allclose(out.detach().float().numpy(), want, atol=4e-2, rtol=0)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "materialized"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_attention_aggregate_matches_jax(dtype, flash):
    rng = np.random.default_rng(13)
    n_dst, n_src, d, dd = 24, 200, 8, 6
    m = (rng.random((n_dst, n_src)) < 0.06) * rng.integers(1, 4, (n_dst, n_src))
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    table, h, k1, k2, a = f(n_src, d), f(n_dst, dd), f(d, d), f(dd, d), f(2 * d, 1)
    jd = jnp.dtype(dtype)
    want = j_seg.dense_attention_aggregate(
        *(jnp.asarray(v).astype(jd) for v in (table, h)), jnp.asarray(m, jnp.int8),
        *(jnp.asarray(v).astype(jd) for v in (k1, k2, a)),
    )
    td = getattr(torch, dtype)
    args = (_t(table, td), _t(h, td), _t(m.astype(np.int8)), _t(k1, td), _t(k2, td), _t(a, td))
    if flash:
        got = t_seg.dense_attention_aggregate(*args)
    else:  # the same scores through the matrix-materializing reference
        ssrc, sdst = t_seg._attention_scores(args[0], args[1], *args[3:])
        assert ssrc.dtype == sdst.dtype == torch.float32
        got = t_seg._dense_masked_softmax_matmul(ssrc, sdst, args[0], args[2])
    assert got.dtype == td
    tol = FWD_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)  # bf16 ulps at |out| < 2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------------------
# per-edge attention over a sorted edge list
# --------------------------------------------------------------------------


def _edge_case(seed, e=400, n=30, d=8, pad=16):
    """Destination-sorted edges, some destinations empty, `pad` padding edges
    at the end (id n - 1, mask 0)."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(n, size=n - 5, replace=False))
    dst = np.sort(rng.choice(live, size=e - pad))
    row_ptr = np.searchsorted(dst, np.arange(n + 1)).astype(np.int32)
    dst = np.concatenate([dst, np.full(pad, n - 1)]).astype(np.int32)
    mask = np.concatenate([np.ones(e - pad), np.zeros(pad)]).astype(np.float32)
    msgs = rng.standard_normal((e, d)).astype(np.float32) * mask[:, None]
    scores = rng.standard_normal(e).astype(np.float32)
    scores[-pad:] = 200.0  # padding scores far above the real max must not matter
    return msgs, scores, dst, mask, row_ptr, rng.standard_normal((n, d)).astype(np.float32)


def test_sorted_softmax_aggregate_matches_jax():
    msgs, scores, dst, mask, row_ptr, ct = _edge_case(0)
    n = ct.shape[0]

    def j_loss(mm, ss):
        return jnp.sum(j_seg.sorted_softmax_aggregate(mm, ss, dst, n, mask, row_ptr) * ct)

    want = j_seg.sorted_softmax_aggregate(jnp.asarray(msgs), jnp.asarray(scores), dst, n,
                                          mask, row_ptr)
    want_g = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(msgs), jnp.asarray(scores))
    leaves = [_t(msgs).requires_grad_(True), _t(scores).requires_grad_(True)]
    before = t_sk.launch_count
    out = t_seg.sorted_softmax_aggregate(*leaves, _t(dst).long(), n, _t(mask), _t(row_ptr))
    assert out.dtype == torch.float32 and t_sk.launch_count == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD_TOL)
    assert not out.detach().numpy()[np.diff(row_ptr) == 0].any()  # empty rows are zero
    got_g = torch.autograd.grad(out, leaves, _t(ct))
    real = mask > 0
    np.testing.assert_allclose(got_g[0].numpy()[real], np.asarray(want_g[0])[real], **FWD_TOL)
    np.testing.assert_allclose(got_g[1].numpy(), np.asarray(want_g[1]), **FWD_TOL)
    assert not got_g[1].numpy()[~real].any()


def test_sorted_segment_softmax_matches_jax():
    _, scores, dst, mask, row_ptr, _ = _edge_case(1)
    n = row_ptr.shape[0] - 1
    want = j_seg.sorted_segment_softmax(jnp.asarray(scores), dst, n, mask, row_ptr)
    got = t_seg.sorted_segment_softmax(_t(scores), _t(dst).long(), n, _t(mask), _t(row_ptr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    sums = np.zeros(n, np.float32)
    np.add.at(sums, dst, got.numpy())
    np.testing.assert_allclose(sums[np.diff(row_ptr) > 0], 1.0, atol=1e-5)


@pytest.mark.parametrize("width", [None, 8], ids=["vector", "width8"])
def test_gather_by_dst_matches_jax(width):
    _, _, dst, mask, row_ptr, _ = _edge_case(2)
    n, e = row_ptr.shape[0] - 1, dst.shape[0]
    rng = np.random.default_rng(3)
    shape = (n,) if width is None else (n, width)
    values = rng.standard_normal(shape).astype(np.float32)
    # padding edges carry no cotangent (the callers' masks see to that)
    ct = rng.standard_normal((e,) + shape[1:]).astype(np.float32)
    ct = ct * (mask if width is None else mask[:, None])
    want_g = jax.grad(
        lambda v: jnp.sum(j_seg.gather_by_dst(v, dst, row_ptr) * ct)
    )(jnp.asarray(values))
    v = _t(values).requires_grad_(True)
    out = t_seg.gather_by_dst(v, _t(dst).long(), _t(row_ptr))
    np.testing.assert_array_equal(out.detach().numpy(), values[dst])
    (got_g,) = torch.autograd.grad(out, v, _t(ct))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **FWD_TOL)
    # the hand-written transpose equals autograd's scatter-add
    v2 = _t(values).requires_grad_(True)
    (auto,) = torch.autograd.grad(v2[_t(dst).long()], v2, _t(ct))
    np.testing.assert_allclose(got_g.numpy(), auto.numpy(), **FWD_TOL)


# --------------------------------------------------------------------------
# the id-keyed segment sum
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [20, 32])
def test_segment_sum_ids_plain_matches_jax_segment_sum(d, dtype):
    """Every edge whose id is below num_segments is summed, padding included
    (the TPU function's contract), into f32."""
    msgs, _, dst, mask, row_ptr, _ = _edge_case(4, d=d)
    msgs = np.random.default_rng(5).standard_normal(msgs.shape).astype(np.float32)
    n = row_ptr.shape[0] - 1
    jd = jnp.asarray(msgs).astype(jnp.dtype(dtype))
    want = jax.ops.segment_sum(jd.astype(jnp.float32), dst, n, indices_are_sorted=True)
    x = _t(msgs, getattr(torch, dtype)).requires_grad_(True)
    before = (t_sk.launch_count, t_sk.ids_launch_count)
    got = t_sk.sorted_segment_sum_ids(x, _t(dst).long(), n)
    assert got.dtype == torch.float32
    assert (t_sk.launch_count, t_sk.ids_launch_count) == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    # the padding edges (id n - 1) count, unlike under kernel A's row pointers
    csr = t_sk.sorted_segment_sum_csr(x.detach(), _t(row_ptr))
    assert not np.allclose(got.detach().numpy()[n - 1], csr.numpy()[n - 1])
    np.testing.assert_allclose(got.detach().numpy()[: n - 1], csr.numpy()[: n - 1], **FWD_TOL)
    ct = np.random.default_rng(6).standard_normal((n, d)).astype(np.float32)
    (g,) = torch.autograd.grad(got, x, _t(ct))
    assert g.dtype == x.dtype
    np.testing.assert_allclose(g.float().numpy(), _t(ct[dst], x.dtype).float().numpy())
    # the row pointers the kernel route takes from the ids
    rp = t_sk._ids_row_ptr(_t(dst).long(), n)
    assert rp.dtype == torch.int32 and rp[-1] == dst.shape[0]
    np.testing.assert_array_equal(rp.numpy()[:-1], row_ptr[:-1])


def test_segment_sum_dispatch():
    """Sorted ids go to the id-keyed sum (f32) without row pointers and, as in
    the TPU function, with them where the width does not divide 128;
    unsorted ids keep the input dtype."""
    msgs, _, dst, mask, row_ptr, _ = _edge_case(7, d=20)
    n = row_ptr.shape[0] - 1
    x = _t(msgs, torch.bfloat16)  # padding rows are zero
    ids = _t(dst).long()
    want = t_sk.sorted_segment_sum_ids_plain(x, ids, n)
    for out in (t_seg.segment_sum(x, ids, n, indices_are_sorted=True),
                t_seg.segment_sum(x, ids, n, row_ptr=_t(row_ptr))):
        assert out.dtype == torch.float32
        assert torch.equal(out, want)
    assert t_seg.segment_sum(x, ids, n).dtype == torch.bfloat16
    x16 = _t(msgs[:, :16])
    np.testing.assert_allclose(
        t_seg.segment_sum(x16, ids, n, row_ptr=_t(row_ptr)).numpy(),
        t_sk.sorted_segment_sum_csr_plain(x16, _t(row_ptr)).numpy(),
    )


# --------------------------------------------------------------------------
# kernels against their plain versions, on a CUDA device
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())


def _cuda_inputs(dev, g, bd, bs, d, dtype, m_dtype, seed):
    cases = [_case(bd, bs, d, seed=seed + i, density=0.03) for i in range(g)]
    stack = lambda i, dt=None: _t(np.stack([c[i] for c in cases]), dt).to(dev)
    return stack(0), stack(1), stack(2, dtype), stack(3, m_dtype), stack(4, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 1e-4, 2.0**-7)])
@pytest.mark.parametrize("shape", [(1, 256, 2048, 32), (3, 37, 1000, 48), (1, 64, 4100, 96)])
def test_flash_forward_kernel_matches_plain_on_cuda(cuda_device, shape, dtype, atol, rtol,
                                                    m_dtype):
    s1, s2, x, m, _ = _cuda_inputs(cuda_device, *shape, dtype, m_dtype, seed=30)
    stab = t_seg._flash_stab(s1, s2)
    before = t_ak.fwd_launch_count
    out, den = t_ak.flash_gat_forward(s1, s2, x, m, stab)
    torch.cuda.synchronize()
    assert t_ak.fwd_launch_count == before + 1
    w_out, w_den = t_ak.flash_gat_forward_plain(s1, s2, x, m, stab)
    assert out.dtype == dtype and den.dtype == torch.float32
    # f32: sums in another order; bf16: the rounding of out may flip by one
    # ulp, at most 2**-7 of the value
    torch.testing.assert_close(out.float(), w_out.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(den, w_den, atol=1e-5, rtol=1e-5)
    assert not out[:, 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("m_dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 256, 2048, 32), (3, 37, 1000, 48), (1, 64, 4100, 96)])
def test_flash_backward_kernel_matches_plain_on_cuda(cuda_device, shape, dtype, m_dtype):
    s1, s2, x, m, ct = _cuda_inputs(cuda_device, *shape, dtype, m_dtype, seed=40)
    stab = t_seg._flash_stab(s1, s2)
    out, den = t_ak.flash_gat_forward_plain(s1, s2, x, m, stab)
    srow = (ct.float() * out.float()).sum(dim=2)
    before = t_ak.bwd_launch_count
    got = t_ak.flash_gat_backward(s1, s2, x, m, stab, den, ct, srow)
    torch.cuda.synchronize()
    assert t_ak.bwd_launch_count == before + 1
    again = t_ak.flash_gat_backward(s1, s2, x, m, stab, den, ct, srow)
    want = t_ak.flash_gat_backward_plain(s1, s2, x, m, stab, den, ct, srow)
    for name, g_, a_, w in zip(("dtab_plus", "d_sdst"), got, again, want):
        assert torch.equal(g_, a_), name  # no atomics: bitwise repeatable
        # the same products (operands rounded alike), f32 sums in another order
        torch.testing.assert_close(g_, w, atol=1e-4, rtol=1e-4, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [20, 32, 48])
def test_segment_sum_ids_kernel_matches_plain_on_cuda(cuda_device, d, dtype):
    msgs, _, dst, _, _, _ = _edge_case(50, e=4096, n=100, d=d, pad=50)
    x = _t(msgs, dtype).to(cuda_device)
    ids = _t(dst).long().to(cuda_device)
    before = (t_sk.launch_count, t_sk.ids_launch_count)
    got = t_sk.sorted_segment_sum_ids(x, ids, 100)
    torch.cuda.synchronize()
    assert (t_sk.launch_count, t_sk.ids_launch_count) == (before[0] + 1, before[1] + 1)
    want = t_sk.sorted_segment_sum_ids_plain(x, ids, 100)
    # f32 sums of ~40 rows in another order
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
