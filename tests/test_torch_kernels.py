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


def _ids_case(seed, e=700, n=50, d=8, pad=30):
    """Sorted ids over e - pad edges with some segments empty, then `pad`
    padding edges whose id is n (outside [0, n): they must not count)."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(n, size=n - 9, replace=False))
    ids = np.concatenate([np.sort(rng.choice(live, size=e - pad)), np.full(pad, n)])
    return rng.standard_normal((e, d)).astype(np.float32), ids, live


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("seed,d", [(10, 8), (11, 20), (12, 48)])
def test_ids_sum_plain_matches_jax_sorted_segment_sum(seed, d, id_dtype):
    """The id-keyed sum's plain version against the JAX package's sorted
    segment sum as it runs on the CPU (its reference for
    `sorted_segment_sum_pallas`: the sorted XLA sum; the Pallas body lowers
    for the TPU only): ids of either width, padding ids equal to
    num_segments, empty segments; and the gather backward."""
    data, ids, live = _ids_case(seed, d=d)
    n = 50
    want = j_seg.segment_sum(
        jnp.asarray(data), jnp.asarray(ids, jnp.int32), n, indices_are_sorted=True)
    x = _t(data).requires_grad_(True)
    t_ids = _t(ids).to(id_dtype)
    before = t_sk.ids_launch_count
    got = t_sk.sorted_segment_sum_ids(x, t_ids, n)
    assert got.dtype == torch.float32 and t_sk.ids_launch_count == before
    _close(got.detach(), want, **F32_TOL)
    empty = np.setdiff1d(np.arange(n), live)
    assert empty.size and not got.detach().numpy()[empty].any()
    # the row pointers that the kernel's search finds per row
    rp = t_sk._ids_row_ptr(t_ids, n)
    np.testing.assert_array_equal(rp.numpy(), np.searchsorted(ids, np.arange(n + 1)))
    _close(t_sk.sorted_segment_sum_csr(x.detach(), rp), want, **F32_TOL)
    ct = np.random.default_rng(seed + 100).standard_normal((n, d)).astype(np.float32)
    want_g = jax.grad(lambda v: jnp.sum(j_seg.segment_sum(
        v, jnp.asarray(ids, jnp.int32), n, indices_are_sorted=True) * ct))(jnp.asarray(data))
    (g,) = torch.autograd.grad(got, x, _t(ct))
    _close(g, want_g, **F32_TOL)


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


@pytest.mark.parametrize(
    "dtype,units,instance",
    [
        (torch.bfloat16, 1, "mma_bf16_u32"),
        (torch.bfloat16, 32, "mma_bf16_u32"),
        (torch.bfloat16, 48, "mma_bf16_u64"),
        (torch.bfloat16, 64, "mma_bf16_u64"),
        (torch.bfloat16, 65, "mma_bf16_u128"),
        (torch.bfloat16, 128, "mma_bf16_u128"),
        (torch.float32, 32, "cuda_cores_f32_u32"),
        (torch.float32, 48, "cuda_cores_f32_u64"),
        (torch.float32, 128, "cuda_cores_f32_u128"),
    ],
)
def test_gru_forward_instance_rule(dtype, units, instance):
    """bf16 runs kernel B on tensor cores, f32 on the CUDA cores (TF32 would
    not hold the TPU kernel's Precision.HIGHEST), in chunks of 32 units."""
    assert t_rk.forward_instance(dtype, units) == instance


@pytest.mark.parametrize("dtype,units", [(torch.bfloat16, 129), (torch.float32, 0),
                                         (torch.float16, 32)])
def test_gru_forward_instance_rule_refuses(dtype, units):
    with pytest.raises(ValueError):
        t_rk.forward_instance(dtype, units)


@pytest.mark.parametrize(
    "kernel_name,instance",
    [
        ("void (anonymous namespace)::masked_gru_scan_mma_kernel<1, true>(__nv_bfloat16 const*, "
         "int const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
         "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int)", "mma_bf16_u32"),
        ("void (anonymous namespace)::masked_gru_scan_mma_kernel<4, false>(...)",
         "mma_bf16_u128"),
        ("void (anonymous namespace)::masked_gru_scan_kernel<float, 2>(float const*, "
         "int const*, float const*, float const*, float const*, float const*, float*, int, "
         "int, int, int)", "cuda_cores_f32_u64"),
    ],
)
def test_gru_profiled_instance_reads_the_kernel_name(kernel_name, instance):
    """The profiler's (demangled) name of the kernel that ran, in the rule's
    terms: the first template argument counts chunks of 32 units."""
    assert t_rk.profiled_instance(kernel_name) == instance


def test_gru_profiled_instance_refuses_another_kernel():
    with pytest.raises(ValueError):
        t_rk.profiled_instance("void (anonymous namespace)::gru_bwd_sweep_kernel<float, 1>(...)")


@pytest.mark.parametrize(
    "dtype,units,instance",
    [
        (torch.bfloat16, 1, "mma_bf16_u32"),
        (torch.bfloat16, 32, "mma_bf16_u32"),
        (torch.bfloat16, 33, "cuda_cores_bf16_u64"),
        (torch.bfloat16, 64, "cuda_cores_bf16_u64"),
        (torch.bfloat16, 128, "cuda_cores_bf16_u128"),
        (torch.float32, 32, "cuda_cores_f32_u32"),
        (torch.float32, 128, "cuda_cores_f32_u128"),
    ],
)
def test_gru_backward_instance_rule(dtype, units, instance):
    """Kernel C's sweep runs on tensor cores in bf16 at u <= 32, on the CUDA
    cores otherwise, in chunks of 32 units."""
    assert t_rk.backward_instance(dtype, units) == instance


@pytest.mark.parametrize("dtype,units", [(torch.bfloat16, 129), (torch.bfloat16, 0),
                                         (torch.float16, 32)])
def test_gru_backward_instance_rule_refuses(dtype, units):
    with pytest.raises(ValueError):
        t_rk.backward_instance(dtype, units)


@pytest.mark.parametrize(
    "kernel_name,instance",
    [
        ("void (anonymous namespace)::gru_bwd_sweep_mma_kernel<1, true>(__nv_bfloat16 const*, "
         "int const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
         "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, __nv_bfloat16*, "
         "__nv_bfloat16*, float4*, float*, int, int, int, int)", "mma_bf16_u32"),
        ("void (anonymous namespace)::gru_bwd_sweep_mma_kernel<1, false>(...)", "mma_bf16_u32"),
        ("void (anonymous namespace)::gru_bwd_sweep_kernel<__nv_bfloat16, 2>(...)",
         "cuda_cores_bf16_u64"),
        ("void (anonymous namespace)::gru_bwd_sweep_kernel<__nv_bfloat16, 4>(...)",
         "cuda_cores_bf16_u128"),
        ("void (anonymous namespace)::gru_bwd_sweep_kernel<float, 1>(float const*, int const*, "
         "...)", "cuda_cores_f32_u32"),
    ],
)
def test_gru_profiled_backward_instance_reads_the_kernel_name(kernel_name, instance):
    """The profiler's (demangled) name of C's sweep in the rule's terms."""
    assert t_rk.profiled_backward_instance(kernel_name) == instance


def test_gru_profiled_backward_instance_refuses_kernel_b():
    with pytest.raises(ValueError):
        t_rk.profiled_backward_instance(
            "void (anonymous namespace)::masked_gru_scan_mma_kernel<1, true>(...)")


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


# (L, n, d, u) of kernel C's cases; lengths drawn from 0..L with 0 and L present
GRU_BWD_CUDA_CASES = {
    "n1024": (8, 1024, 32, 32),
    "n1000": (8, 1000, 32, 32),
    "n1000_d20": (8, 1000, 20, 32),
    "u48": (8, 1000, 20, 48),
}



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GRU_BWD_CUDA_CASES))
def test_gru_scan_bwd_kernel_plain_matches_pallas_kernel(pallas_interpret, case, dtype):
    """`masked_gru_scan_bwd_kernel_plain` (kernel C's reference on the card)
    against jax.grad through the Pallas backward, the TPU kernel, at the
    shapes of the `cuda` cases with n cut to 256 (250 where the case is not
    a multiple of 16; padded with length-0 rows to the Pallas tile of 256).
    Both round the same operands at the same places and sum in f32, so they
    differ only by the order of those sums: f32 atol = rtol = 1e-5 (the
    weight gradients' atol scaled by the leaf's largest entry); bf16 one ulp
    of the bf16 result (2**-8 relative) plus 1e-3, where an f32 sum in
    another order flips the rounding of an operand, far inside the card's
    3e-2."""
    L, n, d, u = GRU_BWD_CUDA_CASES[case]
    n = 256 if n % 16 == 0 else 250
    xs, lens, h0, p = _gru_case(14, L=L, n=n, d=d, u=u)
    ct = np.random.default_rng(15).standard_normal(h0.shape).astype(np.float32)
    t_dtype, j_dtype = getattr(torch, dtype), getattr(jnp, dtype)
    ct = _t(ct, t_dtype).float().numpy()  # the cotangent in the working type
    got = t_rk.masked_gru_scan_bwd_kernel_plain(
        _t(xs, t_dtype), _t(lens), _t(h0, t_dtype), {k: _t(v, t_dtype) for k, v in p.items()},
        _t(ct, t_dtype))
    pad = -n % 256
    want = _pallas_scan_grads(
        np.pad(xs, ((0, 0), (0, pad), (0, 0))), np.pad(lens, (0, pad)),
        np.pad(h0, ((0, pad), (0, 0))), p, np.pad(ct, ((0, pad), (0, 0))), j_dtype)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    want[0], want[1] = want[0][:, :n], want[1][:n]
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert g.dtype == t_dtype, name
        g = g.float().numpy()
        scale = max(1.0, np.abs(w).max())
        if dtype == "float32":
            np.testing.assert_allclose(g, w, err_msg=name, atol=1e-5 * scale, rtol=1e-5)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, atol=1e-3 * scale, rtol=2.0**-7)


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


def _device_kernels(fn):
    """Names of the device kernels that torch.profiler saw one call of `fn`
    launch. A profile that recorded no device activity at all (the profiler
    has come back empty-handed now and then) is taken again, up to 3 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


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


def _skewed_case(seed, e=40_000, n=300, d=32):
    """One row holds a quarter of the edges, the rest are short; 500 padding
    edges past row_ptr[-1] with id n. Small integers: f32 sums are exact in
    any order, so a long row is held as tightly as a short one."""
    rng = np.random.default_rng(seed)
    real = np.sort(np.concatenate([
        np.full(e // 4, n // 3), rng.integers(0, n, size=e - 500 - e // 4)]))
    ids = np.concatenate([real, np.full(500, n)]).astype(np.int32)
    row_ptr = np.searchsorted(real, np.arange(n + 1)).astype(np.int32)
    return rng.integers(-4, 5, size=(e, d)).astype(np.float32), row_ptr, ids


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 20, 32, 48, 256])
def test_segment_kernels_skewed_and_bitwise_repeatable_on_cuda(cuda_device, d, dtype):
    data, row_ptr, ids = _skewed_case(60 + d, d=d)
    n = row_ptr.shape[0] - 1
    x = _t(data).to(cuda_device, dtype)
    rp, t_ids = _t(row_ptr).to(cuda_device), _t(ids).to(cuda_device)
    before = (t_sk.launch_count, t_sk.ids_launch_count)
    by_rp = [t_sk.sorted_segment_sum_csr(x, rp) for _ in range(2)]
    by_ids = [t_sk.sorted_segment_sum_ids(x, i, n) for i in (t_ids, t_ids, t_ids.long())]
    torch.cuda.synchronize()
    assert (t_sk.launch_count, t_sk.ids_launch_count) == (before[0] + 2, before[1] + 3)
    want = t_sk.sorted_segment_sum_csr_plain(x, rp)
    for got in by_rp + by_ids:
        assert got.dtype == torch.float32
        assert torch.equal(got, by_rp[0])  # no atomics: bitwise repeatable; exact sums
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("windows", [1, 3, 8])
def test_windowed_csr_kernel_matches_plain_on_cuda(cuda_device, windows, dtype):
    """Row pointers of `windows` windows over one edge list, some rows of a
    window empty; one launch whatever the number of windows."""
    rng = np.random.default_rng(70 + windows)
    e, n, d = 6_000, 90, 32
    cuts = np.linspace(0, e, windows + 1).astype(np.int64)
    ptrs = [np.searchsorted(np.sort(rng.integers(0, n, size=hi - lo)), np.arange(n)) + lo
            for lo, hi in zip(cuts[:-1], cuts[1:])]
    row_ptr = np.concatenate(ptrs + [[e]]).astype(np.int32)
    x = _t(rng.standard_normal((e, d)).astype(np.float32)).to(cuda_device, dtype)
    rp = _t(row_ptr).to(cuda_device)
    before = (t_sk.launch_count, t_sk.windows_launch_count)
    got = t_sk.sorted_segment_sum_csr_windows(x, rp, n)
    again = t_sk.sorted_segment_sum_csr_windows(x, rp, n)
    torch.cuda.synchronize()
    assert t_sk.launch_count == before[0] + 2
    assert t_sk.windows_launch_count == before[1] + (2 if windows > 1 else 0)
    assert got.dtype == torch.float32 and torch.equal(got, again)
    want = t_sk.sorted_segment_sum_csr_windows_plain(x, rp, n)
    # f32 sums of ~70 rows in another order
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


# (L, n, d, u, lens): "random" draws 0..L with both ends present, "none"
# masks every row
GRU_CUDA_CASES = {
    "flagship": (8, 16384, 32, 32, "random"),
    "n1000": (8, 1000, 32, 32, "random"),
    "d20": (8, 1000, 20, 32, "random"),
    "d48": (8, 1000, 48, 32, "random"),
    "u48": (8, 1000, 20, 48, "random"),
    "u64": (8, 1000, 32, 64, "random"),
    "u128": (8, 1000, 32, 128, "random"),
    "L1": (1, 1000, 32, 32, "random"),
    "all_masked": (8, 1000, 32, 32, "none"),
}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,tol,case",
    [(torch.float32, 1e-5, "n1000"), (torch.float32, 1e-5, "u48")]
    + [(torch.bfloat16, 3e-2, c) for c in GRU_CUDA_CASES],
)
def test_gru_kernel_matches_plain_on_cuda(cuda_device, dtype, tol, case):
    """Kernel B's instance for (dtype, u), as the profiler names the kernel
    that ran, is the rule's; it agrees with the plain version, each call
    twice and compared bitwise."""

    L, n, d, u, lens_kind = GRU_CUDA_CASES[case]
    xs, lens, h0, p = _gru_case(9, L=L, n=n, d=d, u=u)
    if lens_kind == "none":
        lens[:] = 0
    args = (
        _t(xs).to(cuda_device, dtype), _t(lens).to(cuda_device),
        _t(h0).to(cuda_device, dtype),
        {k: _t(v).to(cuda_device, dtype) for k, v in p.items()},
    )
    ran = {t_rk.profiled_instance(name) for name in _device_kernels(
        lambda: t_rk.masked_gru_scan(*args)) if "masked_gru_scan" in name}
    assert ran == {t_rk.forward_instance(dtype, u)}
    before = t_rk.launch_count
    got = t_rk.masked_gru_scan(*args)
    again = t_rk.masked_gru_scan(*args)
    torch.cuda.synchronize()
    assert t_rk.launch_count == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = t_rk.masked_gru_scan_plain(*args)
    if lens_kind == "none":
        assert torch.equal(got, want)  # every row carries h0 through exactly
    # bf16: a 1-ulp flip of the rounded carry propagates through later steps
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,tol,case",
    [(torch.float32, 1e-4, "n1024"), (torch.float32, 1e-4, "n1000_d20")]
    + [(torch.bfloat16, 3e-2, c) for c in GRU_BWD_CUDA_CASES],
)
def test_gru_bwd_kernel_matches_plain_on_cuda(cuda_device, dtype, tol, case):
    """Kernel C's sweep instance for (dtype, u), as the profiler names the
    kernel that ran, is the rule's; its gradients agree with its plain
    version (bf16: `masked_gru_scan_bwd_kernel_plain`, the TPU kernel's
    rounding; f32: autograd through the plain scan), and two identical calls
    are bitwise equal."""

    L, n, d, u = GRU_BWD_CUDA_CASES[case]
    xs, lens, h0, p = _gru_case(14, L=L, n=n, d=d, u=u)
    ct = np.random.default_rng(15).standard_normal(h0.shape).astype(np.float32)
    args = (
        _t(xs).to(cuda_device, dtype), _t(lens).to(cuda_device),
        _t(h0).to(cuda_device, dtype),
        {k: _t(v).to(cuda_device, dtype) for k, v in p.items()},
    )
    ct = _t(ct).to(cuda_device, dtype)
    leaves = [args[0].clone().requires_grad_(True), args[2].clone().requires_grad_(True)]
    params = {k: v.clone().requires_grad_(True) for k, v in args[3].items()}
    leaves += [params["kernel"], params["recurrent_kernel"], params["bias"]]

    def grads():
        return torch.autograd.grad(
            t_rk.masked_gru_scan(leaves[0], args[1], leaves[1], params), leaves, ct)

    ran = {t_rk.profiled_backward_instance(name) for name in _device_kernels(grads)
           if "gru_bwd_sweep" in name}
    assert ran == {t_rk.backward_instance(dtype, u)}
    before = t_rk.bwd_launch_count
    got, again = grads(), grads()
    torch.cuda.synchronize()
    assert t_rk.bwd_launch_count == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # bf16: the reference that rounds where the TPU kernel and C round (the
    # gate gradients before each product); autograd through the plain scan
    # rounds the h-path product instead. f32: the two are one function.
    reference = (t_rk.masked_gru_scan_bwd_kernel_plain if dtype == torch.bfloat16
                 else t_rk.masked_gru_scan_bwd_plain)
    want = reference(*args, ct)
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert g.dtype == w.dtype == dtype
        g, w = g.float(), w.float()
        if name in ("d_xs", "d_h0"):
            # per-row values: absolute for those of order 1, and two ulps of
            # the working type for the larger ones (bf16: 2**-6 relative)
            rtol = 2.0**-6 if dtype == torch.bfloat16 else 1e-5
            assert bool(((g - w).abs() <= tol + rtol * w.abs()).all()), name
        else:
            # weight gradients sum L * n row-steps: relative to the leaf's
            # largest entry
            assert float((g - w).abs().max()) <= tol * float(w.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRU_BWD_CUDA_CASES))
def test_gru_bwd_kernel_matches_pallas_kernel_on_cuda(cuda_device, pallas_interpret, case):
    """Kernel C in bf16 against the TPU kernel it replaces (the Pallas
    backward in interpret mode on the CPU, rows padded with length-0 rows to a
    multiple of 1,024), at the limits of the plain-version test: C follows the
    TPU kernel's rounding (gate gradients rounded before each product), where
    autograd through the plain version rounds the products instead."""
    L, n, d, u = GRU_BWD_CUDA_CASES[case]
    xs, lens, h0, p = _gru_case(14, L=L, n=n, d=d, u=u)
    ct = np.random.default_rng(15).standard_normal(h0.shape).astype(np.float32)
    bf16 = torch.bfloat16
    args = (
        _t(xs).to(cuda_device, bf16), _t(lens).to(cuda_device), _t(h0).to(cuda_device, bf16),
        *(_t(p[k]).to(cuda_device, bf16) for k in ("kernel", "recurrent_kernel", "bias")),
        _t(ct).to(cuda_device, bf16),
    )
    got = t_rk._launch_backward(*args)
    pad = -n % 1024
    ct_bf16 = _t(ct, bf16).float().numpy()
    want = _pallas_scan_grads(
        np.pad(xs, ((0, 0), (0, pad), (0, 0))), np.pad(lens, (0, pad)),
        np.pad(h0, ((0, pad), (0, 0))), p, np.pad(ct_bf16, ((0, pad), (0, 0))), jnp.bfloat16)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]
    want[0], want[1] = want[0][:, :n], want[1][:n]
    for name, g, w in zip(GRAD_NAMES, got, want):
        g, w = g.float().cpu().numpy(), w
        if name in ("d_xs", "d_h0"):
            assert bool((np.abs(g - w) <= 3e-2 + 2.0**-6 * np.abs(w)).all()), name
        else:
            assert float(np.abs(g - w).max()) <= 3e-2 * float(np.abs(w).max()), name
