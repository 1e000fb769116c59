"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, so these
hold the plain versions (the kernels' references) to the JAX functions
they replace, with inputs made by seeded numpy. f32 cases use
atol = rtol = 1e-5: the same sums in another order. Kernel C's reference
(the gradients of kernel B's plain version) is held to `jax.grad` through
the Pallas kernel's own backward in interpret mode. The kernel-vs-plain
cases need a CUDA device (marker `cuda`) and skip here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignnition_tpu.frontend.ir import RNNSpec
from ignnition_tpu.nn import mlp as j_mlp
from ignnition_tpu.nn import rnn as j_rnn
from ignnition_tpu.ops import segment as j_seg
from ignnition_tpu.ops.pallas import rnn_kernels as j_rk
from ignnition_tpu_torch.nn import rnn as t_rnn
from ignnition_tpu_torch.ops import segment as t_seg
from ignnition_tpu_torch.ops.cuda import rnn_kernels as t_rk
from ignnition_tpu_torch.ops.cuda import segment_kernels as t_sk

torch.set_num_threads(1)

F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32),
        **tol,
    )


# --------------------------------------------------------------------------
# kernel A: CSR segment sum
# --------------------------------------------------------------------------


def _csr_case(seed, e=600, n=40, d=16, pad=24):
    """Sorted ids over e - pad real edges, some segments empty, `pad`
    padding edges past row_ptr[-1] holding garbage."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(n, size=n - 7, replace=False))
    ids = np.sort(rng.choice(live, size=e - pad))
    row_ptr = np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)
    data = rng.standard_normal((e, d)).astype(np.float32)
    seg_ids = np.concatenate([ids, np.full(pad, n - 1)]).astype(np.int32)
    emask = np.concatenate([np.ones(e - pad), np.zeros(pad)]).astype(np.float32)
    return data, row_ptr, seg_ids, emask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,d", [(0, 16), (1, 32), (2, 40)])
def test_csr_sum_plain_matches_masked_segment_sum(dtype, seed, d):
    data, row_ptr, seg_ids, emask = _csr_case(seed, d=d)
    jd = jnp.asarray(data).astype(jnp.dtype(dtype))
    # the JAX package's CPU path: mask padding, then a sorted segment sum
    want = jax.ops.segment_sum(
        jd.astype(jnp.float32) * emask[:, None], seg_ids, row_ptr.shape[0] - 1,
        indices_are_sorted=True,
    )
    before = t_sk.launch_count
    got = t_sk.sorted_segment_sum_csr(_t(data, getattr(torch, dtype)), _t(row_ptr))
    assert got.dtype == torch.float32  # the TPU kernel's contract
    assert t_sk.launch_count == before  # CPU tensors never reach the kernel
    _close(got, want, **F32_TOL)
    assert not got[np.diff(row_ptr) == 0].any()  # empty rows are zero


def test_segment_sum_dtype_contract():
    data, row_ptr, seg_ids, emask = _csr_case(3)
    x = _t(data * emask[:, None], torch.bfloat16)
    with_rp = t_seg.segment_sum(x, _t(seg_ids).long(), 40, row_ptr=_t(row_ptr))
    without = t_seg.segment_sum(x, _t(seg_ids).long(), 40)
    assert with_rp.dtype == torch.float32
    assert without.dtype == torch.bfloat16
    want = j_seg.segment_sum(
        jnp.asarray(data * emask[:, None]), seg_ids, 40, indices_are_sorted=True,
        row_ptr=row_ptr,
    )
    _close(t_seg.segment_sum(_t(data * emask[:, None]), _t(seg_ids).long(), 40,
                             row_ptr=_t(row_ptr)), want, **F32_TOL)


@pytest.mark.parametrize("fn", ["direct_segment_sum", "direct_segment_sum_sliced"])
def test_direct_segment_sum_matches_jax(fn):
    rng = np.random.default_rng(4)
    n_src, n_dst, e, pad = 30, 20, 200, 16
    dst = np.sort(rng.integers(0, n_dst, e - pad))
    src = rng.integers(0, n_src, e - pad)
    dst_p = np.concatenate([dst, np.full(pad, n_dst - 1)]).astype(np.int32)
    src_p = np.concatenate([src, np.full(pad, n_src - 1)]).astype(np.int32)
    emask = np.concatenate([np.ones(e - pad), np.zeros(pad)]).astype(np.float32)
    row_ptr = np.searchsorted(dst, np.arange(n_dst + 1)).astype(np.int32)
    states = rng.standard_normal((n_src, 8)).astype(np.float32)
    want = j_seg._dss_impl(
        jnp.asarray(states), src_p, dst_p, emask, row_ptr, n_dst
    )
    got = getattr(t_seg, fn)(_t(states), _t(src_p).long(), _t(row_ptr), n_dst)
    _close(got, want, **F32_TOL)


def test_dense_and_block_sums_match_jax():
    rng = np.random.default_rng(5)
    g, bd, bs, d = 3, 5, 7, 4
    blocks = rng.integers(0, 3, (g, bd, bs)).astype(np.int8)
    states = rng.standard_normal((g * bs + 2, d)).astype(np.float32)
    want = j_seg.direct_segment_sum_blocks(jnp.asarray(states), blocks, g * bd + 4)
    got = t_seg.direct_segment_sum_blocks(_t(states), _t(blocks).float(), g * bd + 4)
    _close(got, want, **F32_TOL)
    dense = rng.integers(0, 3, (11, g * bs + 2)).astype(np.int8)
    want = j_seg.direct_segment_sum_dense(jnp.asarray(states), dense)
    got = t_seg.direct_segment_sum_dense(_t(states), _t(dense).float())
    _close(got, want, **F32_TOL)


# --------------------------------------------------------------------------
# kernel B: masked GRU scan
# --------------------------------------------------------------------------


def _gru_case(seed, L=5, n=256, d=8, u=8):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((L, n, d)).astype(np.float32)
    h0 = rng.standard_normal((n, u)).astype(np.float32)
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    lens[:2] = (0, L)  # both ends of the mask
    params = {
        "kernel": (0.5 * rng.standard_normal((d, 3 * u))).astype(np.float32),
        "recurrent_kernel": (0.5 * rng.standard_normal((u, 3 * u))).astype(np.float32),
        "bias": (0.1 * rng.standard_normal((2, 3 * u))).astype(np.float32),
    }
    return xs, lens, h0, params


@pytest.fixture
def pallas_interpret():
    """Run the JAX package's Pallas GRU kernel (interpret mode on the CPU),
    as tests/test_rnn_kernel.py does."""
    j_rk.set_mode("always")
    yield
    j_rk.set_mode("never")


@pytest.mark.parametrize("shape", [(5, 256, 8, 8), (3, 512, 16, 8), (8, 256, 32, 32)])
def test_gru_scan_plain_matches_pallas_kernel_f32(pallas_interpret, shape):
    L, n, d, u = shape
    xs, lens, h0, p = _gru_case(0, L, n, d, u)
    want = j_rk.masked_gru_scan(jnp.asarray(xs), lens, jnp.asarray(h0), p)
    before = t_rk.launch_count
    got = t_rk.masked_gru_scan(_t(xs), _t(lens), _t(h0), {k: _t(v) for k, v in p.items()})
    assert got.dtype == torch.float32
    assert t_rk.launch_count == before  # CPU tensors never reach the kernel
    _close(got, want, **F32_TOL)


def test_gru_scan_plain_matches_pallas_kernel_bf16(pallas_interpret):
    """bf16: both carry h in f32 and round operands to bf16; the output is
    bf16, so the tolerance is two bf16 ulps at |h| <= 2 (2 * 2**-7)."""
    xs, lens, h0, p = _gru_case(1)
    bf = jnp.bfloat16
    want = j_rk.masked_gru_scan(
        jnp.asarray(xs).astype(bf), lens, jnp.asarray(h0).astype(bf),
        {k: jnp.asarray(v).astype(bf) for k, v in p.items()},
    )
    got = t_rk.masked_gru_scan(
        _t(xs, torch.bfloat16), _t(lens), _t(h0, torch.bfloat16),
        {k: _t(v, torch.bfloat16) for k, v in p.items()},
    )
    assert got.dtype == torch.bfloat16
    _close(got, want, atol=1.6e-2, rtol=0)


# --------------------------------------------------------------------------
# kernel C: masked GRU scan, backward
# --------------------------------------------------------------------------

GRAD_NAMES = ("d_xs", "d_h0", "d_kernel", "d_recurrent_kernel", "d_bias")


def _pallas_scan_grads(xs, lens, h0, p, ct, dtype):
    """jax.grad through the Pallas kernel pair (its custom backward is the
    TPU kernel that kernel C replaces)."""
    cast = lambda a: jnp.asarray(a).astype(dtype)

    def loss(xs_, h0_, p_):
        out = j_rk.masked_gru_scan(xs_, lens, h0_, p_)
        return jnp.sum(out.astype(jnp.float32) * ct)

    g = jax.grad(loss, argnums=(0, 1, 2))(
        cast(xs), cast(h0), {k: cast(v) for k, v in p.items()}
    )
    return g[0], g[1], g[2]["kernel"], g[2]["recurrent_kernel"], g[2]["bias"]


def _port_scan_grads(xs, lens, h0, p, ct, dtype):
    """Autograd through the port's `masked_gru_scan` (its plain version on
    the CPU) and the explicit reference `masked_gru_scan_bwd_plain`."""
    args = (_t(xs, dtype), _t(lens), _t(h0, dtype), {k: _t(v, dtype) for k, v in p.items()})
    leaves = [args[0].requires_grad_(True), args[2].requires_grad_(True)]
    params = {k: v.requires_grad_(True) for k, v in args[3].items()}
    leaves += [params["kernel"], params["recurrent_kernel"], params["bias"]]
    before = t_rk.bwd_launch_count
    out = t_rk.masked_gru_scan(leaves[0], args[1], leaves[1], params)
    auto = torch.autograd.grad(out, leaves, _t(ct, dtype))
    assert t_rk.bwd_launch_count == before  # CPU tensors never reach the kernel
    plain = t_rk.masked_gru_scan_bwd_plain(*args, _t(ct, dtype))
    for a, b in zip(auto, plain):
        assert a.dtype == b.dtype == dtype
        assert torch.equal(a, b)
    return plain


@pytest.mark.parametrize("shape", [(5, 256, 8, 8), (3, 512, 16, 8), (8, 256, 32, 32)])
def test_gru_scan_bwd_plain_matches_pallas_kernel_f32(pallas_interpret, shape):
    L, n, d, u = shape
    xs, lens, h0, p = _gru_case(10, L, n, d, u)  # rows 0 and 1: lengths 0 and L
    ct = np.random.default_rng(11).standard_normal((n, u)).astype(np.float32)
    want = _pallas_scan_grads(xs, lens, h0, p, ct, jnp.float32)
    got = _port_scan_grads(xs, lens, h0, p, ct, torch.float32)
    for name, g, w in zip(GRAD_NAMES, got, want):
        w = np.asarray(w)
        # the weight gradients sum L * n products in another order: their
        # absolute limit scales with the leaf's largest entry
        scale = 1.0 if name in ("d_xs", "d_h0") else max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, atol=1e-5 * scale, rtol=1e-5)
    # a zero-length row passes its cotangent through and gives no d_xs
    assert lens[0] == 0
    np.testing.assert_array_equal(got[1][0].numpy(), ct[0])
    assert not got[0][:, 0].any()
    assert not got[0][int(lens[5]):, 5].any()  # steps past a row's length


def test_gru_scan_bwd_plain_matches_pallas_kernel_bf16(pallas_interpret):
    """bf16: both round the operands of every product to bf16 and sum in f32,
    but autograd rounds the carry's gradient to bf16 at each step where the
    TPU kernel keeps it in f32. d_xs and d_h0 (|values| < 4): a few bf16 ulps,
    atol 6e-2. The weight gradients sum 256 rows x 5 steps: 3e-2 of the
    leaf's largest entry."""
    xs, lens, h0, p = _gru_case(12)
    ct = np.random.default_rng(13).standard_normal(h0.shape).astype(np.float32)
    want = _pallas_scan_grads(xs, lens, h0, p, ct, jnp.bfloat16)
    got = _port_scan_grads(xs, lens, h0, p, ct, torch.bfloat16)
    for name, g, w in zip(GRAD_NAMES, got, want):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        tol = 6e-2 if name in ("d_xs", "d_h0") else 3e-2 * np.abs(w).max()
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_masked_update_stacked_matches_lax_scan(cell):
    xs, lens, h0, p = _gru_case(2)
    spec = RNNSpec(name="t", cell_type=cell)
    if cell == "LSTM":
        rng = np.random.default_rng(3)
        p = {
            "kernel": (0.5 * rng.standard_normal((8, 32))).astype(np.float32),
            "recurrent_kernel": (0.5 * rng.standard_normal((8, 32))).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(32)).astype(np.float32),
        }
    want = j_rnn.masked_update_stacked(spec, p, jnp.asarray(xs), lens, jnp.asarray(h0))
    got = t_rnn.masked_update_stacked(
        spec, {k: _t(v) for k, v in p.items()}, _t(xs), _t(lens), _t(h0)
    )
    _close(got, want, **F32_TOL)


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_cell_step_matches_jax(cell):
    rng = np.random.default_rng(6)
    spec = RNNSpec(name="t", cell_type=cell)
    g = 3 if cell == "GRU" else 4
    p = {
        "kernel": rng.standard_normal((8, g * 8)).astype(np.float32),
        "recurrent_kernel": rng.standard_normal((8, g * 8)).astype(np.float32),
        "bias": rng.standard_normal((2, 24) if cell == "GRU" else (32,)).astype(np.float32),
    }
    x = rng.standard_normal((10, 8)).astype(np.float32)
    h = rng.standard_normal((10, 8)).astype(np.float32)
    want = j_rnn.cell_step(spec, p, jnp.asarray(x), jnp.asarray(h))
    got = t_rnn.cell_step(spec, {k: _t(v) for k, v in p.items()}, _t(x), _t(h))
    _close(got, want, **F32_TOL)


def test_readout_mlp_matches_jax():
    from __graft_entry__ import _flagship
    from ignnition_tpu_torch.nn import mlp as t_mlp

    spec = _flagship(2, 8).readout[0].mlp
    rng = np.random.default_rng(7)
    p = {"layers": tuple(
        {"kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
         "bias": rng.standard_normal(b).astype(np.float32)}
        for a, b in ((8, 256), (256, 256), (256, 1))
    )}
    x = rng.standard_normal((12, 8)).astype(np.float32)
    want = j_mlp.apply(spec, p, jnp.asarray(x))
    got = t_mlp.apply(
        spec, {"layers": tuple({k: _t(v) for k, v in l.items()} for l in p["layers"])}, _t(x)
    )
    _close(got, want, atol=1e-4, rtol=1e-4)  # two 256-wide f32 sums


# --------------------------------------------------------------------------
# kernels against their plain versions, on a CUDA device
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_kernel_matches_plain_on_cuda(cuda_device, dtype):
    data, row_ptr, _, _ = _csr_case(8, e=4096, n=100, d=32, pad=50)
    x = _t(data).to(cuda_device, dtype)
    rp = _t(row_ptr).to(cuda_device)
    before = t_sk.launch_count
    got = t_sk.sorted_segment_sum_csr(x, rp)
    torch.cuda.synchronize()
    assert t_sk.launch_count == before + 1
    want = t_sk.sorted_segment_sum_csr_plain(x, rp)
    # f32 sums of ~40 rows in another order
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_gru_kernel_matches_plain_on_cuda(cuda_device, dtype, tol):
    xs, lens, h0, p = _gru_case(9, L=8, n=1024, d=32, u=32)
    args = (
        _t(xs).to(cuda_device, dtype), _t(lens).to(cuda_device),
        _t(h0).to(cuda_device, dtype),
        {k: _t(v).to(cuda_device, dtype) for k, v in p.items()},
    )
    before = t_rk.launch_count
    got = t_rk.masked_gru_scan(*args)
    torch.cuda.synchronize()
    assert t_rk.launch_count == before + 1
    # bf16: a 1-ulp flip of the rounded carry propagates through later steps
    torch.testing.assert_close(
        got.float(), t_rk.masked_gru_scan_plain(*args).float(), atol=tol, rtol=tol
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_gru_bwd_kernel_matches_plain_on_cuda(cuda_device, dtype, tol):
    xs, lens, h0, p = _gru_case(14, L=8, n=1024, d=32, u=32)
    ct = np.random.default_rng(15).standard_normal(h0.shape).astype(np.float32)
    args = (
        _t(xs).to(cuda_device, dtype), _t(lens).to(cuda_device),
        _t(h0).to(cuda_device, dtype),
        {k: _t(v).to(cuda_device, dtype) for k, v in p.items()},
    )
    ct = _t(ct).to(cuda_device, dtype)
    leaves = [args[0].requires_grad_(True), args[2].requires_grad_(True)]
    params = {k: v.requires_grad_(True) for k, v in args[3].items()}
    leaves += [params["kernel"], params["recurrent_kernel"], params["bias"]]
    before = t_rk.bwd_launch_count
    got = torch.autograd.grad(t_rk.masked_gru_scan(leaves[0], args[1], leaves[1], params),
                              leaves, ct)
    torch.cuda.synchronize()
    assert t_rk.bwd_launch_count == before + 1
    want = t_rk.masked_gru_scan_bwd_plain(*args, ct)
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert g.dtype == w.dtype == dtype
        g, w = g.float(), w.float()
        if name in ("d_xs", "d_h0"):
            # per-row values: absolute for those of order 1, and two ulps of
            # the working type for the larger ones (bf16: 2**-6 relative)
            rtol = 2.0**-6 if dtype == torch.bfloat16 else 1e-5
            assert bool(((g - w).abs() <= tol + rtol * w.abs()).all()), name
        else:
            # weight gradients sum 8,192 row-steps: relative to the leaf's
            # largest entry
            assert float((g - w).abs().max()) <= tol * float(w.abs().max()), name
