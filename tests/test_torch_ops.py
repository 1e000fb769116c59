"""The port's kernels as operators (`torch.ops.ignnition_tpu_torch.*`):
`torch.library.opcheck` over each one's CPU body (the plain version) at
small shapes: the schema and aliasing, and the fake against the real
outputs. The operators register no backward (the public entries
differentiate, through autograd Functions around them), so no input asks
for a gradient there; the public entries' backwards of A, the id-keyed sum
and B are held to the plain versions'. The `cuda` cases run opcheck over the
CUDA bodies (the kernels) and skip without a CUDA device."""

import numpy as np
import pytest
import torch

from ignnition_tpu_torch.ops.cuda import attention_kernels as ak  # noqa: F401 (registers)
from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk  # noqa: F401 (registers)
from ignnition_tpu_torch.ops.cuda import segment_kernels as sk  # noqa: F401 (registers)

OPS = torch.ops.ignnition_tpu_torch
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32, device="cpu", grad=False):
    t = torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)
    return t.requires_grad_(grad)


def csr_args(dtype, device, grad=True, windows=1):
    """Data [40, 8] over 6 segments a window, the last 3 edges padding."""
    rng = _rng(0)
    n = 6
    counts = rng.integers(0, 4, size=n * windows)
    ptr = np.concatenate([[1], 1 + np.cumsum(counts)])
    e = int(ptr[-1]) + 3
    row_ptr = torch.from_numpy(ptr.astype(np.int32)).to(device)
    return (_t(rng.normal(size=(e, 8)), dtype, device, grad), row_ptr, n)


def ids_args(dtype, device, grad=True):
    """Data [30, 20] (a width off 128) by sorted ids, some out of range."""
    rng = _rng(1)
    ids = np.sort(rng.integers(-1, 6, size=30))
    return (_t(rng.normal(size=(30, 20)), dtype, device, grad),
            torch.from_numpy(ids).to(device), 5)


def gru_args(dtype, device, grad=True):
    rng = _rng(2)
    L, n, d, u = 4, 40, 8, 8
    lens = torch.from_numpy(rng.integers(0, L + 1, size=n).astype(np.int32)).to(device)
    return (_t(rng.normal(size=(L, n, d)), dtype, device, grad), lens,
            _t(rng.normal(size=(n, u)), dtype, device, grad),
            _t(rng.normal(size=(d, 3 * u)) * 0.3, dtype, device, grad),
            _t(rng.normal(size=(u, 3 * u)) * 0.3, dtype, device, grad),
            _t(rng.normal(size=(2, 3 * u)) * 0.1, dtype, device, grad))


def gru_bwd_args(dtype, device, steps=4):
    args = tuple(a.detach() for a in gru_args(dtype, device, grad=False))
    return (args[0][:steps],) + args[1:] + (_t(_rng(3).normal(size=(40, 8)), dtype, device),)


def _gat(dtype, device, m_dtype=torch.int8):
    rng = _rng(4)
    g, bd, bs, d = 2, 5, 7, 8
    ssrc = _t(rng.normal(size=(g, bs)), torch.float32, device)
    sdst = _t(rng.normal(size=(g, bd)), torch.float32, device)
    x = _t(rng.normal(size=(g, bs, d)), dtype, device)
    m = torch.from_numpy((rng.random((g, bd, bs)) < 0.4).astype(np.int8)).to(device, m_dtype)
    pre = torch.nn.functional.leaky_relu(sdst + ssrc.amax(dim=1, keepdim=True), 0.2)
    return ssrc, sdst, x, m, pre


def gat_fwd_args(dtype, device):
    return _gat(dtype, device)


def gat_bwd_args(dtype, device):
    ssrc, sdst, x, m, stab = _gat(dtype, device)
    out, den = ak.flash_gat_forward_plain(ssrc.cpu(), sdst.cpu(), x.cpu(), m.cpu(), stab.cpu())
    ct = _t(_rng(5).normal(size=out.shape), dtype, device)
    srow = (ct.float() * out.to(device).float()).sum(dim=2)
    return ssrc, sdst, x, m, stab, den.to(device), ct, srow


# operator -> argument maker (dtype, device), no input asking for a gradient
CASES = {
    "csr_segment_sum": lambda dt, dev: csr_args(dt, dev, grad=False),
    "csr_segment_sum_windows": lambda dt, dev: csr_args(dt, dev, grad=False, windows=3),
    "segment_sum_ids": lambda dt, dev: ids_args(dt, dev, grad=False),
    "masked_gru_scan": lambda dt, dev: gru_args(dt, dev, grad=False),
    "masked_gru_scan_backward": gru_bwd_args,
    # no step: h0's cotangent comes back as a new tensor
    "masked_gru_scan_backward_no_step": lambda dt, dev: gru_bwd_args(dt, dev, steps=0),
    "flash_gat_forward": gat_fwd_args,
    "flash_gat_backward": gat_bwd_args,
}


def _op(name):
    return getattr(OPS, name.replace("_no_step", "")).default


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck_cpu(name, dtype):
    torch.library.opcheck(_op(name), CASES[name](DTYPES[dtype], "cpu"))


# operator -> (argument maker with gradients, its public entry)
ENTRIES = {
    "csr_segment_sum": (csr_args, lambda d, rp, n: sk.sorted_segment_sum_csr(d, rp)),
    "segment_sum_ids": (ids_args, sk.sorted_segment_sum_ids),
    "masked_gru_scan": (gru_args, lambda xs, lens, h0, wx, wh, b: rk.masked_gru_scan(
        xs, lens, h0, {"kernel": wx, "recurrent_kernel": wh, "bias": b})),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_registered_backward_is_the_plain_versions(name):
    """The backward of A's and the id-keyed sum's public entries gives what
    autograd gives through their plain versions; B's on the CPU is autograd
    through the plain scan itself (`masked_gru_scan_bwd_plain`), exactly."""
    make, entry = ENTRIES[name]
    args = make(torch.float32, "cpu")
    leaves = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
    out = entry(*args)
    ct = torch.from_numpy(_rng(6).normal(size=tuple(out.shape)).astype(np.float32))
    got = torch.autograd.grad(out, leaves, ct)
    plain_args = [a.detach().requires_grad_(a.requires_grad) if isinstance(a, torch.Tensor)
                  else a for a in args]
    plain_leaves = [a for a in plain_args if isinstance(a, torch.Tensor) and a.requires_grad]
    if name == "masked_gru_scan":
        xs, lens, h0, wx, wh, b = plain_args
        plain = rk.masked_gru_scan_plain(
            xs, lens, h0, {"kernel": wx, "recurrent_kernel": wh, "bias": b})
    else:
        plain_fn = {"csr_segment_sum": lambda d, rp, n: sk.sorted_segment_sum_csr_plain(d, rp),
                    "segment_sum_ids": sk.sorted_segment_sum_ids_plain}[name]
        plain = plain_fn(*plain_args)
    want = torch.autograd.grad(plain, plain_leaves, ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_entries_without_gradients_call_the_operators(monkeypatch):
    """Where no gradient is asked (serving, `torch.no_grad`, the windowed sum
    that detaches its data), a public entry calls its operator and nothing
    around it, and its output asks for no gradient."""
    calls = []
    for cls in (sk._CsrSegmentSum, sk._IdsSegmentSum, rk._MaskedGruScan):
        monkeypatch.setattr(cls, "apply", lambda *a: calls.append(a))
    data, row_ptr, n = csr_args(torch.float32, "cpu", windows=3)
    assert not sk.sorted_segment_sum_csr_windows(data, row_ptr, n).requires_grad
    with torch.no_grad():
        for name, (make, entry) in ENTRIES.items():
            assert not entry(*make(torch.float32, "cpu")).requires_grad, name
    assert calls == []


def test_fakes_give_shapes_without_building(monkeypatch):
    """A fake gives each operator's output shapes and dtypes, as its CPU body
    does, and builds nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ignnition_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "library", lambda: pytest.fail("a fake built the library"))
    for name, make in CASES.items():
        args = make(torch.bfloat16, "cpu")
        real = _op(name)(*args)
        with FakeTensorMode() as mode:
            out = _op(name)(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                              for a in args))
        outs = out if isinstance(out, tuple) else (out,)
        reals = real if isinstance(real, tuple) else (real,)
        assert [(o.shape, o.dtype) for o in outs] == [(r.shape, r.dtype) for r in reals], name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck_cuda(cuda_device, name, dtype):
    torch.library.opcheck(_op(name), CASES[name](DTYPES[dtype], cuda_device))
