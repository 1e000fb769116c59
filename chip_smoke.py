#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ignnition_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure (the exit code is then non-zero):
  1. print the card's name and power limit, build the port's CUDA kernels
     from the checkout's sources and print the build time;
  2. hold each kernel (A: CSR segment sum and the id-keyed sum over it,
     B: masked GRU scan, C: its backward, D and E: flash-GAT attention
     forward and backward) against its plain PyTorch version on the card at
     the main paths' shapes, in bf16 and f32 (D and E also with a bf16
     incidence matrix, over 4 graph blocks and at a ragged shape; E twice,
     compared bitwise); time kernel, plain version and, where there is one,
     one PyTorch library call of the same function (a yardstick only, never
     on the port's path) with CUDA events; work out each kernel's bound on
     this card from the bytes and operations of this run's inputs;
  3. serve the flagship RouteNet (hs=32, 8 message-passing iterations,
     256-256-1 selu readout, random weights from a seed, bf16 compute)
     through `ServingModel.predict_samples`: three requests at the flagship
     size (2,048 links, 16,384 paths of length 8) and one at 4x that
     (8,192 links, 65,536 paths). Check that the predictions are finite and
     of the right shape, that kernels A and B ran on that path (launch
     counts), and that the kernel path agrees with the plain path (the same
     model on the CPU) in f32 and in bf16; then time the requests;
  4. train it through `Trainer` (bf16 compute over f32 masters, MSE + L2,
     Adam with ExponentialDecay): 5 steps on one batch at the flagship size
     and 2 at 4x. Check that every loss is finite and the last below the
     first, that the step-0 gradients of the kernel path agree leaf by leaf
     with the plain path (the same model and batch on the CPU, f32), that
     kernels A, B and C all ran in every step (launch counts), and the
     evaluation step; then time the step (median of 20, CUDA events), print
     edge-messages per second and profile one step by kernel;
  5. the attention family (stage 2 aggregating by attention): serve three
     requests at the flagship size (dense attention over the int8 incidence
     matrix: kernel D 8 times per forward) and train 3 steps (D 8 and E 7
     times per step: the last iteration's link states reach no prediction;
     a falling L2 term, step-0 gradients against the plain
     path leaf by leaf in f32), one request at 4x (per-edge attention:
     kernel A 16 times per forward) and one of a small model at hs=48 (the
     id-keyed sum 8 times per forward), each against the plain path, and the
     small model's step-0 gradients (the per-edge backward through kernel A).

The line before the last is one JSON object describing the kernels; the
last line is `{"ok": true, "device": {...}}`. Needs one CUDA device and
nvcc; it never continues on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(n_links=2048, n_paths=16384, path_len=8)
FLAGSHIP_X4 = dict(n_links=8192, n_paths=65536, path_len=8)
N_FLAGSHIP_REQUESTS = 3
TRAIN_STEPS = {"flagship": 5, "flagship_x4": 2}
ATTENTION_TRAIN_STEPS = 3
# under the data layer's floor of 16,384 edges for a dense incidence matrix,
# so the model takes per-edge attention
SMALL_PER_EDGE = dict(n_links=256, n_paths=2000, path_len=8)
ITERATIONS = 8
HS = 32


def flagship_description(num_iterations: int = ITERATIONS, hs: int = HS) -> dict:
    """The flagship RouteNet description, copied from `_flagship` in
    `__graft_entry__.py` (that module imports the JAX package)."""
    return {
        "entities": [
            {"name": "link", "hidden_state_dimension": hs,
             "features": [{"name": "link_capacity"}]},
            {"name": "path", "hidden_state_dimension": hs,
             "features": [{"name": "traffic"}]},
        ],
        "message_passing": {
            "num_iterations": num_iterations,
            "stages": [
                {
                    "stage_name": "stage1",
                    "stage_mp": [{
                        "destination_entity": "path",
                        "source_entities": [{
                            "name": "link",
                            "adj_vector": "adj_links_paths",
                            "message": [{"type": "direct_assignation"}],
                        }],
                        "aggregation": {"type": "ordered"},
                        "update": {"type": "recurrent_neural_network", "nn_name": "gru"},
                    }],
                },
                {
                    "stage_name": "stage2",
                    "stage_mp": [{
                        "destination_entity": "link",
                        "source_entities": [{
                            "name": "path",
                            "adj_vector": "adj_paths_links",
                            "message": [{"type": "direct_assignation"}],
                        }],
                        "aggregation": {"type": "sum"},
                        "update": {"type": "recurrent_neural_network", "nn_name": "gru"},
                    }],
                },
            ],
        },
        "readout": [{
            "type": "predict",
            "input": ["path"],
            "label": "delay",
            "label_normalization": "log",
            "nn_name": "readout",
        }],
        "neural_networks": [
            {
                "nn_name": "readout",
                "nn_type": "feed_forward",
                "nn_architecture": [
                    {"type_layer": "Dense", "units": 256, "activation": "selu",
                     "kernel_regularizer": 0.1},
                    {"type_layer": "Dense", "units": 256, "activation": "selu",
                     "kernel_regularizer": 0.1},
                    {"type_layer": "Dense", "units": 1, "activation": "None",
                     "kernel_regularizer": 0.01},
                ],
            },
            {"nn_name": "gru", "nn_type": "recurrent_neural_network",
             "recurrent_type": "GRU"},
        ],
        "learning_options": {
            "loss": "MeanSquaredError",
            "optimizer": {
                "type": "Adam",
                "schedule": {
                    "type": "ExponentialDecay",
                    "initial_learning_rate": 0.001,
                    "decay_steps": 80000,
                    "decay_rate": 0.6,
                },
            },
        },
    }


def attention_description(num_iterations: int = ITERATIONS, hs: int = HS) -> dict:
    """The flagship with stage 2 aggregating by attention (`_mutate_attention`
    in `bench.py`)."""
    desc = flagship_description(num_iterations, hs)
    desc["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"] = {"type": "attention"}
    return desc


FEATURE_DIMS = {"link_capacity": 1, "traffic": 1}


def make_sample(rng, n_links, n_paths, path_len):
    """One random RouteNet graph built straight as arrays, as
    `bench.build_case.one_sample` builds it (`bench.py`)."""
    from ignnition_tpu_torch.data.dataset import AdjacencyArrays, GraphSample

    links = rng.integers(0, n_links, size=(n_paths, path_len))
    src_lp = links.reshape(-1).astype(np.int32)
    dst_lp = np.repeat(np.arange(n_paths, dtype=np.int32), path_len)
    seq_lp = np.tile(np.arange(path_len, dtype=np.int32), n_paths)
    order = np.argsort(src_lp, kind="stable")
    src_pl = dst_lp[order].copy()
    dst_pl = src_lp[order].copy()
    counts = np.bincount(dst_pl, minlength=n_links)
    seq_pl = (
        np.concatenate([np.arange(c, dtype=np.int32) for c in counts])
        if counts.sum()
        else np.zeros(0, np.int32)
    )
    return GraphSample(
        num_nodes={"link": n_links, "path": n_paths},
        features={
            "link_capacity": rng.uniform(20, 40, (n_links, 1)).astype(np.float32),
            "traffic": rng.uniform(0.2, 0.8, (n_paths, 1)).astype(np.float32),
        },
        adjacencies={
            "adj_links_paths": AdjacencyArrays(src_lp, dst_lp, seq_lp),
            "adj_paths_links": AdjacencyArrays(src_pl, dst_pl, seq_pl),
        },
        label=rng.uniform(0.1, 1.0, n_paths).astype(np.float32),
    )


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): device
# memory 3.35 TB/s; 989 TFLOP/s bf16 in the tensor cores; 67 TFLOP/s f32
# outside them. A bound is the larger of bytes / memory rate and operations
# / peak rate of the operands' type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound(n_bytes: float, n_ops: float, dtype) -> tuple:
    """(bound_ms, "bytes" | "operations") for a call that must move
    `n_bytes` and do `n_ops` floating-point operations on `dtype` operands."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def forward_ms(server, batch, runs: int = 20, warmup: int = 3) -> list:
    """Milliseconds of each of `runs` forwards on a device-resident batch,
    from CUDA events, after `warmup` untimed forwards."""
    out = []
    for i in range(warmup + runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        server.forward_device(batch)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            out.append(start.elapsed_time(end))
    return out


def device_time_by_kernel(fn, runs: int = 5) -> tuple:
    """({kernel name: device ms per call of `fn`}, kernels launched per call)
    from torch.profiler's CUDA activity over `runs` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    per_name, count = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / runs
            count += 1
    return per_name, count / runs


def yardstick_diff(name: str, lib: torch.Tensor, ref: torch.Tensor) -> None:
    """Print how far a library call's result lies from the port's: the call
    is timed as a yardstick and is not the port's code, so only its shape and
    finiteness are held (it must compute the same function, not round alike)."""
    lib = lib.detach().to("cpu", torch.float32)
    ref = ref.detach().to("cpu", torch.float32)
    if lib.shape != ref.shape or not torch.isfinite(lib).all():
        raise AssertionError(f"{name}: shape {tuple(lib.shape)} or non-finite values")
    print(f"    {name}: max abs difference from the port {float((lib - ref).abs().max()):.3e}"
          f" (max |value| {float(ref.abs().max()):.3e})")


def print_profile(what: str, fn, wall_ms: float) -> dict:
    """Profile `fn` by kernel, print the ten largest, and return the busy
    time, launches per call and idle share of `wall_ms` (empty when the
    profiler saw no device activity)."""
    per_kernel, n_kernels = device_time_by_kernel(fn)
    busy = sum(per_kernel.values())
    if busy == 0.0:
        print(f"[profile] {what}: the profiler saw no device activity; "
              "device busy share not measured")
        return {}
    print(f"[profile] {what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"({busy / wall_ms:.1%}), {n_kernels:.0f} kernel launches per call "
          f"(torch.profiler, 5 calls)")
    for kname, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {ms:8.4f} ms {ms / busy:6.1%}  {kname[:90]}")
    return dict(device_busy_ms=busy, kernels_per_call=n_kernels,
                device_idle_share=max(0.0, 1.0 - busy / wall_ms))


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float,
            why: str) -> float:
    """Print the max abs/rel error and raise unless |got - want| <=
    atol + rtol * |want| holds everywhere."""
    got = got.detach().to("cpu", torch.float32)
    want = want.detach().to("cpu", torch.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / want.abs().clamp_min(1e-6)).max()) if err.numel() else 0.0
    ok = bool((err <= atol + rtol * want.abs()).all())
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"tol atol={atol:g} rtol={rtol:g} ({why}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its reference beyond the tolerance")
    return max_abs


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def check_segment_sum(dev, rng, what: str, e: int, n: int, gathered: bool,
                      d: int = HS) -> dict:
    """Kernel A on [e, d] rows into n segments. `gathered`: the rows come
    through a row gather by a permutation first, as `_gss_bwd` feeds it."""
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    e_real = e - 1_000  # the tail is padding, past row_ptr[-1]
    live = np.sort(rng.choice(n, size=n - n // 20, replace=False))  # 5% rows empty
    ids = np.sort(rng.choice(live, size=e_real))
    row_ptr = np.searchsorted(ids, np.arange(n + 1)).astype(np.int32)
    rp = torch.from_numpy(row_ptr).to(dev)
    offsets = rp.to(torch.int64)
    perm = torch.from_numpy(rng.permutation(e)).to(dev)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        data = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(dev, dtype)
        if gathered:
            data = data[perm]
        got = sk.sorted_segment_sum_csr(data, rp)
        want = sk.sorted_segment_sum_csr_plain(data, rp)
        torch.cuda.synchronize()
        if got.dtype != torch.float32:
            raise AssertionError(f"kernel A returned {got.dtype}, the contract is f32")
        err = compare(
            f"kernel A csr_segment_sum ({what}) [{e}x{d}] -> [{n}x{d}] {str(dtype)[6:]}",
            got, want, atol=1e-4, rtol=1e-5,
            why=f"f32 sums of ~{e // n} rows in another order (plain uses atomics)",
        )
        ms = cuda_ms(lambda: sk.sorted_segment_sum_csr(data, rp))
        plain_ms = cuda_ms(lambda: sk.sorted_segment_sum_csr_plain(data, rp))
        # the library's segmented reduction over the same real rows (output
        # in the data's type)
        real = data[:e_real]
        lib = torch.segment_reduce(real, "sum", offsets=offsets, axis=0)
        yardstick_diff(f"library torch.segment_reduce {str(dtype)[6:]} (sums in the "
                       f"data's type)", lib, want)
        library_ms = cuda_ms(lambda: torch.segment_reduce(real, "sum", offsets=offsets, axis=0))
        n_bytes = e_real * d * data.element_size() + (n + 1) * 4 + n * d * 4
        bound_ms, bound_by = bound(n_bytes, e_real * d, torch.float32)  # f32 adds
        print(f"    time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.segment_reduce {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({n_bytes / ms / 1e6:.1f} GB/s moved by the kernel)")
        out[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
    return out


def _gru_inputs(dev, rng, L, n, d, u):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    lens_np = rng.integers(0, L + 1, size=n).astype(np.int32)
    lens_np[:2] = (0, L)
    lens = torch.from_numpy(lens_np).to(dev)
    p32 = {"kernel": 0.2 * f(d, 3 * u), "recurrent_kernel": 0.2 * f(u, 3 * u),
           "bias": 0.1 * f(2, 3 * u)}
    return f(L, n, d), lens, torch.full_like(lens, L), 0.5 * f(n, u), p32, f(n, u)


def _library_gru(params, d, u, dtype, dev) -> torch.nn.GRU:
    """`torch.nn.GRU` (cuDNN's reset-after GRU) holding the Keras params: the
    gate columns go from Keras's z, r, h to PyTorch's r, z, n."""
    gru = torch.nn.GRU(d, u, num_layers=1, bias=True).to(dev, dtype)
    order = lambda w: torch.cat([w[..., u:2 * u], w[..., :u], w[..., 2 * u:]], dim=-1)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(order(params["kernel"]).T)
        gru.weight_hh_l0.copy_(order(params["recurrent_kernel"]).T)
        gru.bias_ih_l0.copy_(order(params["bias"][0]))
        gru.bias_hh_l0.copy_(order(params["bias"][1]))
    gru.flatten_parameters()
    return gru


def _gru_bytes(L, n, d, u, es):
    """Bytes of the scan's inputs (xs, lens, h0, weights) and of one [n, u]
    state in the working type."""
    return L * n * d * es + n * 4 + n * u * es + (d + u + 2) * 3 * u * es, n * u * es


def check_gru_scan(dev, rng) -> dict:
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk

    L, n, d, u = FLAGSHIP["path_len"], FLAGSHIP["n_paths"], HS, HS
    xs32, lens, full, h032, p32, _ = _gru_inputs(dev, rng, L, n, d, u)
    tols = {
        torch.float32: (1e-5, 1e-5, "f32 dot products of 32 terms in another order"),
        torch.bfloat16: (3e-2, 0.0, "a 1-ulp flip of the bf16-rounded carry at one "
                                    "step propagates through later steps"),
    }
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        xs, h0 = xs32.to(dtype), h032.to(dtype)
        p = {k: v.to(dtype) for k, v in p32.items()}
        got = rk.masked_gru_scan(xs, lens, h0, p)
        want = rk.masked_gru_scan_plain(xs, lens, h0, p)
        torch.cuda.synchronize()
        if got.dtype != dtype:
            raise AssertionError(f"kernel B returned {got.dtype} for {dtype} input")
        atol, rtol, why = tols[dtype]
        err = compare(
            f"kernel B masked_gru_scan [{L},{n},{d}] u={u} {str(dtype)[6:]}",
            got, want, atol=atol, rtol=rtol, why=why,
        )
        # timed at full lengths: every flagship path has path_len links
        ms = cuda_ms(lambda: rk.masked_gru_scan(xs, full, h0, p))
        plain_ms = cuda_ms(lambda: rk.masked_gru_scan_plain(xs, full, h0, p))
        gru = _library_gru(p, d, u, dtype, dev)
        with torch.no_grad():
            lib = gru(xs, h0[None])[1][0]
            yardstick_diff(f"library torch.nn.GRU (cuDNN) at full lengths {str(dtype)[6:]}",
                           lib, rk.masked_gru_scan(xs, full, h0, p))
            library_ms = cuda_ms(lambda: gru(xs, h0[None]))
        flops = 2 * L * n * (d + u) * 3 * u
        in_bytes, state_bytes = _gru_bytes(L, n, d, u, xs.element_size())
        bound_ms, bound_by = bound(in_bytes + state_bytes, flops, dtype)
        print(f"    time at full lengths: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.nn.GRU {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({flops / ms / 1e9:.1f} TFLOP/s by the kernel)")
        out[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
    return out


GRAD_NAMES = ("d_xs", "d_h0", "d_kernel", "d_recurrent_kernel", "d_bias")


def check_gru_scan_bwd(dev, rng) -> dict:
    """Kernel C through `masked_gru_scan`'s autograd against the gradients of
    the plain version, at random lengths 0..L and at full lengths."""
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk

    L, n, d, u = FLAGSHIP["path_len"], FLAGSHIP["n_paths"], HS, HS
    xs32, lens, full, h032, p32, ct32 = _gru_inputs(dev, rng, L, n, d, u)
    # d_xs and d_h0 are per-row values of order 1: absolute limits. The weight
    # and bias gradients sum L * n = 131,072 row-steps: limits relative to the
    # leaf's largest entry.
    tols = {
        torch.float32: (1e-4, 1e-5, "f32 sums in another order"),
        torch.bfloat16: (3e-2, 2e-2, "gate gradients and the carry round to bf16 at "
                                     "other places than autograd's"),
    }
    names = ("kernel", "recurrent_kernel", "bias")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        xs, h0, ct = xs32.to(dtype), h032.to(dtype), ct32.to(dtype)
        p = {k: v.to(dtype) for k, v in p32.items()}
        row_tol, sum_tol, why = tols[dtype]
        err = 0.0
        for which, ln in (("random lengths", lens), ("full lengths", full)):
            leaves = [xs.clone().requires_grad_(True), h0.clone().requires_grad_(True)]
            leaves += [p[k].clone().requires_grad_(True) for k in names]
            before = rk.bwd_launch_count
            h = rk.masked_gru_scan(leaves[0], ln, leaves[1], dict(zip(names, leaves[2:])))
            got = torch.autograd.grad(h, leaves, ct)
            torch.cuda.synchronize()
            if rk.bwd_launch_count != before + 1:
                raise AssertionError("the backward did not launch kernel C")
            want = rk.masked_gru_scan_bwd_plain(xs, ln, h0, p, ct)
            for name, g, w in zip(GRAD_NAMES, got, want):
                if g.dtype != dtype:
                    raise AssertionError(f"kernel C returned {name} in {g.dtype}")
                per_row = name in ("d_xs", "d_h0")
                atol = row_tol if per_row else sum_tol * float(w.float().abs().max())
                e = compare(
                    f"kernel C {name} [{L},{n},{d}] u={u} {str(dtype)[6:]}, {which}",
                    g, w, atol=atol, rtol=0.0,
                    why=why + ("" if per_row else f"; {sum_tol:g} of the leaf's largest entry"),
                )
                if per_row:
                    err = max(err, e)
        wx, wh, b = (p[k].contiguous() for k in names)
        ms = cuda_ms(lambda: rk._launch_backward(xs, full, h0, wx, wh, b, ct))
        plain_ms = cuda_ms(lambda: rk.masked_gru_scan_bwd_plain(xs, full, h0, p, ct), iters=5)
        gru = _library_gru(p, d, u, dtype, dev)
        x_lib = xs.clone().requires_grad_(True)
        h_lib = h0[None].clone().requires_grad_(True)
        h_n = gru(x_lib, h_lib)[1][0]
        lib_leaves = [x_lib, h_lib, *gru.parameters()]
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(h_n, lib_leaves, ct, retain_graph=True))
        flops = 3 * 2 * L * n * (d + u) * 3 * u  # recompute, transposed products, weight grads
        in_bytes, state_bytes = _gru_bytes(L, n, d, u, xs.element_size())
        # read the inputs and ct; write d_xs, d_h0 and the f32 weight gradients
        n_bytes = (in_bytes + state_bytes + L * n * d * xs.element_size() + n * u * 4
                   + (d + u + 2) * 3 * u * 4)
        bound_ms, bound_by = bound(n_bytes, flops, dtype)
        print(f"    time at full lengths: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.nn.GRU backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({flops / ms / 1e9:.1f} TFLOP/s by the kernel)")
        out[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
    return out


def check_segment_sum_ids(dev, rng, e: int, n: int, d: int) -> dict:
    """The id-keyed sum on [e, d] rows into n segments (every edge counts),
    beside `index_add_`."""
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    ids = torch.from_numpy(np.sort(rng.integers(0, n, size=e))).to(dev)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        data = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(dev, dtype)
        before = sk.ids_launch_count
        got = sk.sorted_segment_sum_ids(data, ids, n)
        torch.cuda.synchronize()
        if sk.ids_launch_count != before + 1 or got.dtype != torch.float32:
            raise AssertionError("sorted_segment_sum_ids did not launch kernel A into f32")
        want = sk.sorted_segment_sum_ids_plain(data, ids, n)
        err = compare(
            f"id-keyed segment sum [{e}x{d}] -> [{n}x{d}] {str(dtype)[6:]}",
            got, want, atol=1e-4, rtol=1e-5,
            why=f"f32 sums of ~{e // n} rows in another order (plain uses atomics)",
        )
        ms = cuda_ms(lambda: sk.sorted_segment_sum_ids(data, ids, n))
        plain_ms = cuda_ms(lambda: sk.sorted_segment_sum_ids_plain(data, ids, n))
        # the library's scatter-add of the same rows, in the data's type
        lib = torch.zeros((n, d), dtype=dtype, device=dev).index_add_(0, ids, data)
        yardstick_diff(f"library index_add_ {str(dtype)[6:]} (sums in the data's type)",
                       lib, want)
        library_ms = cuda_ms(
            lambda: torch.zeros((n, d), dtype=dtype, device=dev).index_add_(0, ids, data))
        n_bytes = e * d * data.element_size() + e * ids.element_size() + n * d * 4
        bound_ms, bound_by = bound(n_bytes, e * d, torch.float32)  # f32 adds
        print(f"    time: searchsorted + kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}")
        out[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
    return out


def incidence_of(sample, n_links: int, n_paths: int) -> np.ndarray:
    """The int8 multiplicity matrix [links, paths] of a sample's path -> link
    edges, as `build_batch` stores it."""
    adj = sample.adjacencies["adj_paths_links"]
    m = np.zeros((n_links, n_paths), np.int32)
    np.add.at(m, (adj.dst_idx, adj.src_idx), 1)
    if m.max() > 127:
        raise AssertionError("a multiplicity above 127 does not fit int8")
    return m.astype(np.int8)


def check_flash_gat(dev, rng, what: str, blocks: np.ndarray, d: int, x_dtypes, m_dtype,
                    timed: bool) -> dict:
    """Kernels D and E on `blocks` [G, bd, bs] at width d against their plain
    versions, through the wrappers; E twice, compared bitwise."""
    from ignnition_tpu_torch.ops import segment as seg
    from ignnition_tpu_torch.ops.cuda import attention_kernels as ak

    g, bd, bs = blocks.shape
    nnz = int(np.count_nonzero(blocks))
    m = torch.from_numpy(blocks).to(dev).to(m_dtype)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    ssrc, sdst, x32, ct32 = f(g, bs), f(g, bd), f(g, bs, d), f(g, bd, d)
    stab = seg._flash_stab(ssrc, sdst)
    fwd, bwd = {}, {}
    for dtype in x_dtypes:
        name = f"[{g},{bd},{bs}] D={d} m {str(m_dtype)[6:]} x {str(dtype)[6:]} ({what})"
        x, ct = x32.to(dtype), ct32.to(dtype)
        before = (ak.fwd_launch_count, ak.bwd_launch_count)
        out, den = ak.flash_gat_forward(ssrc, sdst, x, m, stab)
        srow = (ct.float() * out.float()).sum(dim=2)
        got = ak.flash_gat_backward(ssrc, sdst, x, m, stab, den, ct, srow)
        again = ak.flash_gat_backward(ssrc, sdst, x, m, stab, den, ct, srow)
        torch.cuda.synchronize()
        if (ak.fwd_launch_count, ak.bwd_launch_count) != (before[0] + 1, before[1] + 2):
            raise AssertionError("the wrappers did not launch kernels D and E")
        if out.dtype != dtype or den.dtype != torch.float32:
            raise AssertionError(f"kernel D returned {out.dtype}, {den.dtype}")
        for a, b, which in zip(got, again, ("dtab_plus", "d_sdst")):
            if not torch.equal(a, b):
                raise AssertionError(f"kernel E {which} differs between two runs")
        w_out, w_den = ak.flash_gat_forward_plain(ssrc, sdst, x, m, stab)
        want = ak.flash_gat_backward_plain(ssrc, sdst, x, m, stab, den, ct, srow)
        bf16 = dtype == torch.bfloat16
        # bf16: the f32 sums differ in their order, so the rounding of out to
        # bf16 may flip by one ulp, at most 2**-7 of the value
        atol, rtol = (1e-4, 2.0**-7) if bf16 else (1e-5, 1e-5)
        err = compare(f"kernel D out {name}", out, w_out, atol=atol, rtol=rtol,
                      why="one bf16 ulp of the rounded output" if bf16
                      else "f32 sums of a row's entries in another order")
        compare(f"kernel D den {name}", den, w_den, atol=1e-6, rtol=1e-5,
                why="f32 sums in another order")
        if bool((den == 0).any()) and bool(out[den == 0].any()):
            raise AssertionError("a row without support is not exactly 0")
        err_b = 0.0
        for which, a, w in zip(("dtab_plus", "d_sdst"), got, want):
            top = float(w.abs().max())
            if bf16:
                # an f32 ulp in a = z / den can flip a's bf16 rounding, 2**-8 of
                # one term: such entries are few and stay within 2**-7 of the
                # output's largest entry
                off = float(((a - w).abs() > 1e-5 * top + 1e-4 * w.abs()).float().mean())
                print(f"    kernel E {which}: {off:.2e} of the entries beyond the f32 limit "
                      f"(flips of a's bf16 rounding; at most 1e-4 of them may be)")
                if off > 1e-4:
                    raise AssertionError(f"kernel E {which}: too many entries off")
            err_b = max(err_b, compare(
                f"kernel E {which} {name}, bitwise repeatable", a, w,
                atol=(2.0**-7 if bf16 else 1e-5) * top, rtol=1e-4,
                why="rare flips of a's bf16 rounding" if bf16
                else "f32 sums in another order; 1e-5 of the largest entry"))
        if not timed:
            continue
        es, ms_ = x.element_size(), m.element_size()
        vectors = 4 * g * (bs + 3 * bd)
        fwd_bytes = g * bd * bs * ms_ + g * bs * d * es + vectors + g * bd * (d * es + 4)
        bwd_bytes = (g * bd * bs * ms_ + g * (bs + bd) * d * es + vectors + 8 * g * bd
                     + 4 * g * (bs * (d + 1) + bd))
        # operations of this run's data: only the non-zero entries do work
        fwd_bound = bound(fwd_bytes, nnz * (2 * d + 8), dtype)
        bwd_bound = bound(bwd_bytes, nnz * (6 * d + 16), dtype)
        fwd_ms = cuda_ms(lambda: ak.flash_gat_forward(ssrc, sdst, x, m, stab))
        bwd_ms = cuda_ms(
            lambda: ak.flash_gat_backward(ssrc, sdst, x, m, stab, den, ct, srow))
        fwd_plain = cuda_ms(lambda: ak.flash_gat_forward_plain(ssrc, sdst, x, m, stab),
                            iters=5, warmup=1)
        bwd_plain = cuda_ms(
            lambda: ak.flash_gat_backward_plain(ssrc, sdst, x, m, stab, den, ct, srow),
            iters=5, warmup=1)
        # the matrix-materializing route with library products (never on the
        # port's path): no single PyTorch call computes this function
        leaves = [ssrc[0].clone().requires_grad_(True), sdst[0].clone().requires_grad_(True),
                  x[0].clone().requires_grad_(True)]
        dense_fwd = cuda_ms(lambda: seg._blocks_masked_softmax_matmul(
            ssrc.reshape(-1), sdst.reshape(-1), x.reshape(g * bs, d), m), iters=5, warmup=1)
        if g == 1:
            routed = seg._dense_masked_softmax_matmul(*leaves, m[0])
            dense_bwd = cuda_ms(lambda: torch.autograd.grad(
                routed, leaves, ct[0], retain_graph=True), iters=5, warmup=1)
        else:
            dense_bwd = None
        print(f"    time {name}: D {fwd_ms:.4f} ms (plain {fwd_plain:.3f}, materializing "
              f"route {dense_fwd:.3f}, bound {fwd_bound[0]:.4f} by {fwd_bound[1]}, "
              f"{fwd_bytes / fwd_ms / 1e6:.0f} GB/s); E {bwd_ms:.4f} ms (plain "
              f"{bwd_plain:.3f}, materializing route "
              f"{'-' if dense_bwd is None else format(dense_bwd, '.3f')}, bound "
              f"{bwd_bound[0]:.4f} by {bwd_bound[1]}); {nnz} non-zeros of {g * bd * bs}")
        fwd[dtype] = dict(max_abs_err=err, ms=fwd_ms, plain_ms=fwd_plain,
                          bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=None,
                          materializing_route_ms=dense_fwd)
        bwd[dtype] = dict(max_abs_err=err_b, ms=bwd_ms, plain_ms=bwd_plain,
                          bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=None,
                          materializing_route_ms=dense_bwd)
    return dict(fwd=fwd, bwd=bwd)


def check_attention_kernels(dev, rng) -> dict:
    """Kernels D and E at the flagship's [2048, 16384] int8 incidence (D=32,
    bf16 and f32), with a bf16 incidence, over 4 graph blocks of the
    `blocks_g4` size, and at a shape the TPU tiles would refuse."""
    both = (torch.bfloat16, torch.float32)
    size = FLAGSHIP
    m = incidence_of(make_sample(rng, **size), size["n_links"], size["n_paths"])
    main = check_flash_gat(dev, rng, "flagship stage 2", m[None], HS, both, torch.int8, True)
    check_flash_gat(dev, rng, "bf16 incidence", m[None], HS, (torch.bfloat16,),
                    torch.bfloat16, False)
    blocks = np.stack([incidence_of(make_sample(rng, 512, 4096, 8), 512, 4096)
                       for _ in range(4)])
    main["blocks"] = check_flash_gat(dev, rng, "4 graph blocks", blocks, HS,
                                     (torch.bfloat16,), torch.int8, True)
    ragged = incidence_of(make_sample(rng, 1003, 5001, 8), 1003, 5001)
    check_flash_gat(dev, rng, "ragged, unaligned rows", ragged[None], 48, both,
                    torch.int8, False)
    check_flash_gat(dev, rng, "ragged, bf16 incidence", ragged[None], 48,
                    (torch.float32,), torch.bfloat16, False)
    return main


# --------------------------------------------------------------------------
# phase 3: serving
# --------------------------------------------------------------------------


def serve(dev, card: str) -> dict:
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.data.graph import merge_metas
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)

    sizes = {"flagship": FLAGSHIP, "flagship_x4": FLAGSHIP_X4}
    requests = []  # (size name, sample)
    servers = {}
    t0 = time.perf_counter()
    for name, size in sizes.items():
        count = N_FLAGSHIP_REQUESTS if name == "flagship" else 1
        samples = [make_sample(rng, **size) for _ in range(count)]
        # the served shapes: padded to fit every request of this size
        meta = merge_metas(
            [igt.build_batch([s], ir, padding, training=False)[1] for s in samples]
        )
        servers[name] = igt.ServingModel(
            igt.build(ir), params, meta, ir, compute_dtype=torch.bfloat16, device=dev
        )
        requests += [(name, s) for s in samples]
    print(f"[serve] {len(requests)} requests made and servers set up in "
          f"{time.perf_counter() - t0:.1f} s (host)")

    # ---- the main path: answer every request, counting kernel launches ----
    sk.launch_count = 0
    rk.launch_count = 0
    answers = []
    for name, sample in requests:
        a0, b0 = sk.launch_count, rk.launch_count
        preds = servers[name].predict_samples([sample])
        da, db = sk.launch_count - a0, rk.launch_count - b0
        n_paths = sample.num_nodes["path"]
        if preds.shape != (n_paths,) or not np.all(np.isfinite(preds)):
            raise AssertionError(
                f"{name}: predictions of shape {preds.shape} (want ({n_paths},)) "
                f"or non-finite")
        want_a = ITERATIONS if name == "flagship_x4" else 0
        print(f"  request {name}: {n_paths} predictions, finite, "
              f"mean {preds.mean():.5f}; launches kernel A +{da}, kernel B +{db}")
        if db != ITERATIONS or da != want_a:
            raise AssertionError(
                f"{name}: expected kernel A +{want_a} and kernel B +{ITERATIONS} "
                f"launches per forward, got +{da} and +{db}")
        answers.append(preds)
    launches = {"csr_segment_sum": sk.launch_count, "masked_gru_scan": rk.launch_count}
    print(f"[serve] main path launch counts: kernel A {launches['csr_segment_sum']}, "
          f"kernel B {launches['masked_gru_scan']}")
    if min(launches.values()) == 0:
        raise AssertionError("a kernel of the main path was never launched")

    # ---- kernel path vs plain path (the same model on the CPU) ----
    for name in sizes:
        sample = next(s for n, s in requests if n == name)
        kernels_vs_plain_forward(name, servers[name], ir, params, sample, dev,
                                 (None, torch.bfloat16))

    # ---- latency ----
    latency = {}
    for name in sizes:
        server = servers[name]
        sample = next(s for n, s in requests if n == name)
        arrays = server.build_batch([sample])
        inputs = {k: v for k, v in arrays.items() if k not in ("label", "label_mask")}
        fwd = forward_ms(server, to_device(inputs, dev))
        e2e = []
        for i in range(6):
            t1 = time.perf_counter()
            server.predict_samples([sample])
            if i >= 1:
                e2e.append((time.perf_counter() - t1) * 1e3)
        latency[name] = dict(forward_ms=float(np.median(fwd)), request_ms=float(np.median(e2e)))
        print(f"[latency] {name}: device forward median {np.median(fwd):.3f} ms "
              f"(min {min(fwd):.3f}, max {max(fwd):.3f}, 20 runs, CUDA events); "
              f"whole request (build_batch + copy + forward + trim) median "
              f"{np.median(e2e):.1f} ms (5 runs, host clock) on {card}")

        # ---- where the device time goes ----
        dev_batch = to_device(inputs, dev)
        latency[name].update(print_profile(
            f"{name} forward", lambda: server.forward_device(dev_batch),
            latency[name]["forward_ms"]))
    return dict(launches=launches, latency=latency)


# --------------------------------------------------------------------------
# phase 4: training
# --------------------------------------------------------------------------

def step0_gradients_vs_plain(name, ir, padding, arrays, meta, state, batch, noise=0.0):
    """Hold the loss and every gradient leaf of the kernel path (the card) to
    the plain path (the same model and batch on the CPU) in f32, before any
    step. Returns the initial parameters as a CPU tree, the CPU state and the
    CPU gradients by name."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params, map_params

    init_tree = map_params(lambda v: v.detach().cpu().clone(), state.params)
    f32_card = igt.Trainer(igt.build(ir), padding, compute_dtype=None)
    g_card, m_card = f32_card.grads_fn(meta)(state.params, batch)
    f32_cpu = igt.Trainer(igt.build(ir), padding, compute_dtype=None, device="cpu")
    cpu_state = f32_cpu.init_state(params=init_tree)
    t1 = time.perf_counter()
    g_cpu, m_cpu = f32_cpu.grads_fn(meta)(cpu_state.params, to_device(arrays, "cpu"))
    cpu_s = time.perf_counter() - t1
    compare(f"{name} step-0 loss, kernels vs plain (CPU, {cpu_s:.1f} s) f32",
            m_card["total"], m_cpu["total"], atol=1e-4, rtol=1e-4,
            why="f32 sums in another order on each device")
    want = flatten_params(g_cpu)
    for k, g in flatten_params(g_card).items():
        top = float(want[k].abs().max())
        compare(f"{name} step-0 gradient {k} (largest entry {top:.3e})", g, want[k],
                atol=1e-4 * top + noise, rtol=1e-3,
                why="f32 sums over up to 131,072 rows in another order; 1e-4 of the "
                    "leaf's largest entry" + (f" and {noise:g} of f32 noise" if noise else ""))
    return init_tree, cpu_state, want


def time_training_step(name, step, state, batch, arrays, card) -> dict:
    """Median of 20 steps after 3 (CUDA events), edge-messages per second,
    peak device memory and the profile of one step by kernel."""
    times = []
    for i in range(3 + 20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    step_ms = float(np.median(times))
    edges = sum(int(np.sum(arrays[f"edge_mask_{adj}"] > 0))
                for adj in ("adj_links_paths", "adj_paths_links"))
    rate = ITERATIONS * edges / (step_ms / 1e3)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[train] {name}: step median {step_ms:.3f} ms (min {min(times):.3f}, max "
          f"{max(times):.3f}, 20 steps after 3, CUDA events), {rate / 1e6:.1f} M "
          f"edge-messages/s ({ITERATIONS} iterations x {edges} edges), peak device "
          f"memory {peak:.0f} MiB, bf16 compute, on {card}")
    out = dict(step_ms=step_ms, edge_messages_per_s=rate, peak_mib=peak)
    out.update(print_profile(f"{name} training step", lambda: step(state, batch), step_ms))
    return out



def train(dev, card: str) -> dict:
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk
    from ignnition_tpu_torch.training.metrics import MetricAccumulator

    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    rng = np.random.default_rng(SEED + 1)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    launches = {"csr_segment_sum": 0, "masked_gru_scan": 0, "masked_gru_scan_bwd": 0}
    result = {}
    for name, size in (("flagship", FLAGSHIP), ("flagship_x4", FLAGSHIP_X4)):
        t0 = time.perf_counter()
        arrays, meta = igt.build_batch([make_sample(rng, **size)], ir, padding, training=True)
        print(f"[train] {name}: build_batch(training=True) {time.perf_counter() - t0:.2f} s "
              f"(host, numpy routines)")
        # bf16 compute over f32 masters; no device argument: the card is the default
        trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
        if trainer.device.type != "cuda":
            raise AssertionError(f"the trainer chose {trainer.device}, not the card")
        batch = to_device(arrays, trainer.device)
        state = trainer.init_state(torch.Generator().manual_seed(SEED))

        # ---- step-0 gradients: kernel path (card) vs plain path (CPU), f32 ----
        init_tree, cpu_state, want = step0_gradients_vs_plain(
            name, ir, padding, arrays, meta, state, batch)
        init_params = flatten_params(init_tree)

        # the training dtype: kernel path against plain path, both in bf16
        # (printed, not held: bf16 roundings fall differently on the two paths)
        g_bf16, _ = trainer.grads_fn(meta)(state.params, batch)
        bf16_cpu = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16,
                               device="cpu")
        g_bf16_cpu, _ = bf16_cpu.grads_fn(meta)(cpu_state.params, to_device(arrays, "cpu"))
        for (k, gb), gc in zip(flatten_params(g_bf16).items(),
                               flatten_params(g_bf16_cpu).values()):
            top = max(float(gc.abs().max()), 1e-30)
            print(f"      bf16 compute, {k}: kernels vs plain (CPU) "
                  f"{float((gb.cpu() - gc).abs().max()) / top:.2e}, plain bf16 vs plain f32 "
                  f"{float((gc - want[k]).abs().max()) / top:.2e} of the leaf's largest entry")

        # ---- the main path: training steps, counting kernel launches ----
        step = trainer.train_step_fn(meta)
        a = "adj_links_paths"
        windows = (arrays[f"slice_sort_row_ptr_{a}"].shape[0] - 1) // meta.nodes("link")
        dense = any(k.startswith(("dense_inc_", "inc_blocks_")) for k in arrays)
        sliced = any(k.startswith("bwd_slice_dst_") for k in arrays)
        # kernel A: `_gss_bwd` once per window and iteration, but for the
        # first iteration, whose link states come from the features alone and
        # need no gradient; past the dense cap also stage 2's forward and,
        # without the slice map, its backward
        want_a = (ITERATIONS - 1) * windows + (
            0 if dense else ITERATIONS * (1 if sliced else 2))
        sk.launch_count = rk.launch_count = rk.bwd_launch_count = 0
        metrics = []
        for i in range(TRAIN_STEPS[name]):
            before = (sk.launch_count, rk.launch_count, rk.bwd_launch_count)
            state, m = step(state, batch)
            da, db, dc = (now - was for now, was in zip(
                (sk.launch_count, rk.launch_count, rk.bwd_launch_count), before))
            if (da, db, dc) != (want_a, ITERATIONS, ITERATIONS):
                raise AssertionError(
                    f"{name} step {i}: expected kernel A +{want_a}, B +{ITERATIONS}, "
                    f"C +{ITERATIONS} launches, got +{da}, +{db}, +{dc}")
            metrics.append(m)
        torch.cuda.synchronize()
        launches["csr_segment_sum"] += sk.launch_count
        launches["masked_gru_scan"] += rk.launch_count
        launches["masked_gru_scan_bwd"] += rk.bwd_launch_count
        totals = [float(m["total"]) for m in metrics]
        losses = [float(m["loss"]) for m in metrics]
        print(f"  {name}: {len(totals)} steps, loss+reg " + " ".join(f"{t:.5f}" for t in totals)
              + "; loss " + " ".join(f"{t:.5f}" for t in losses)
              + f"; per step kernel A +{want_a} ({windows} slice-sort windows), "
              f"B +{ITERATIONS}, C +{ITERATIONS}")
        if not all(np.isfinite(totals + losses)):
            raise AssertionError(f"{name}: a loss is not finite")
        if not totals[-1] < totals[0]:
            raise AssertionError(f"{name}: the loss did not fall: {totals}")
        if state.step != len(totals) or state.opt_state["count"] != len(totals):
            raise AssertionError(f"{name}: the state counts {state.step} steps")
        moved = max(float((v.detach().cpu() - init_params[k]).abs().max())
                    for k, v in flatten_params(state.params).items())
        if not 0.0 < moved < 0.1:
            raise AssertionError(f"{name}: parameters moved by {moved}")

        # ---- evaluation step (f32 compute, no graph) ----
        preds, loss = trainer.eval_step_fn(meta)(state.params, batch)
        n_pad = meta.nodes("path")
        if preds.shape != (n_pad,) or preds.requires_grad or not torch.isfinite(preds).all():
            raise AssertionError(f"{name}: eval predictions {tuple(preds.shape)} or non-finite")
        acc = MetricAccumulator()
        acc.update(arrays["label"], preds.cpu().numpy(), arrays["label_mask"])
        print(f"  {name}: eval loss {float(loss):.5f}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in acc.result().items()))

        # ---- step time ----
        result[name] = dict(losses=totals, **time_training_step(
            name, step, state, batch, arrays, card))
    print(f"[train] main path launch counts: kernel A {launches['csr_segment_sum']}, "
          f"kernel B {launches['masked_gru_scan']}, kernel C {launches['masked_gru_scan_bwd']}")
    if min(launches.values()) == 0:
        raise AssertionError("a kernel of the training path was never launched")
    return dict(launches=launches, steps=result)


# --------------------------------------------------------------------------
# phase 5: the attention family
# --------------------------------------------------------------------------


class Counts:
    """Launch counts of every kernel wrapper: `reset()` sets them to 0,
    `read()` returns them by kernel name."""

    def __init__(self):
        from ignnition_tpu_torch.ops.cuda import attention_kernels as ak
        from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk
        from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

        self.ak, self.rk, self.sk = ak, rk, sk

    def reset(self) -> None:
        self.sk.launch_count = self.sk.ids_launch_count = 0
        self.rk.launch_count = self.rk.bwd_launch_count = 0
        self.ak.fwd_launch_count = self.ak.bwd_launch_count = 0

    def read(self) -> dict:
        return {
            "csr_segment_sum": self.sk.launch_count,
            "segment_sum_ids": self.sk.ids_launch_count,
            "masked_gru_scan": self.rk.launch_count,
            "masked_gru_scan_bwd": self.rk.bwd_launch_count,
            "flash_gat_fwd": self.ak.fwd_launch_count,
            "flash_gat_bwd": self.ak.bwd_launch_count,
        }


def expect_counts(what: str, got: dict, **want) -> None:
    """Raise unless the launch counts `got` are `want` (0 where not named)."""
    wrong = {k: (v, want.get(k, 0)) for k, v in got.items() if v != want.get(k, 0)}
    print(f"  {what}: launches " + ", ".join(f"{k} {v}" for k, v in got.items() if v))
    if wrong:
        raise AssertionError(f"{what}: launch counts (got, expected) {wrong}")


def serve_one_size(dev, ir, params, samples, padding, compute_dtype=torch.bfloat16):
    """A `ServingModel` at the shapes that fit `samples`."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data.graph import merge_metas

    meta = merge_metas([igt.build_batch([s], ir, padding, training=False)[1] for s in samples])
    return igt.ServingModel(igt.build(ir), params, meta, ir, compute_dtype=compute_dtype,
                            device=dev)


def kernels_vs_plain_forward(name, server, ir, params, sample, dev, dtypes) -> None:
    """One request's predictions on the card against the same model on the
    CPU (every kernel's plain version)."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    tols = {
        None: (1e-4, 1e-4, "f32: sums and products in another order on each device"),
        torch.bfloat16: (3e-2, 3e-2, "bf16: roundings of the bf16 states and "
                                     "matmul outputs fall differently over the iterations"),
    }
    arrays = server.build_batch([sample])
    inputs = {k: v for k, v in arrays.items() if k not in ("label", "label_mask")}
    cpu_model = igt.build(ir)
    cpu_model.load_params(params)
    b_dev, b_cpu = to_device(inputs, dev), to_device(inputs, "cpu")
    mask = torch.from_numpy(arrays["node_mask_path"] > 0)
    for cd in dtypes:
        atol, rtol, why = tols[cd]
        with torch.inference_mode():
            got = server.model(b_dev, server.meta, compute_dtype=cd)
            t1 = time.perf_counter()
            want = cpu_model(b_cpu, server.meta, compute_dtype=cd)
            cpu_s = time.perf_counter() - t1
        compare(f"{name} predictions, kernels vs plain (CPU, {cpu_s:.1f} s) "
                f"{'f32' if cd is None else 'bf16'}",
                got.cpu()[mask], want[mask], atol=atol, rtol=rtol, why=why)


def attention(dev, card: str) -> dict:
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params

    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    ir = igt.parse_model_description(attention_description(), FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    leaves = [k for k in flatten_params(params) if k.startswith("aggregation/")]
    if leaves != [f"aggregation/s1/m0/{k}" for k in ("kernel1", "kernel2", "attn_kernel")]:
        raise AssertionError(f"attention leaves {leaves}")
    rng = np.random.default_rng(SEED + 2)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    result = {}

    # ---- serving at the flagship size: dense attention, kernel D ----
    samples = [make_sample(rng, **FLAGSHIP) for _ in range(N_FLAGSHIP_REQUESTS)]
    server = serve_one_size(dev, ir, params, samples, padding)
    inc = server.build_batch([samples[0]])["dense_inc_adj_paths_links"]
    print(f"[attention] flagship incidence {inc.dtype} {inc.shape}, "
          f"{int(np.count_nonzero(inc))} non-zeros")
    for i, sample in enumerate(samples):
        counts.reset()
        preds = server.predict_samples([sample])
        got = counts.read()
        add(got)
        if preds.shape != (FLAGSHIP["n_paths"],) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"attention request {i}: {preds.shape} or non-finite")
        expect_counts(f"attention request {i} ({preds.shape[0]} predictions, mean "
                      f"{preds.mean():.5f})", got,
                      masked_gru_scan=ITERATIONS, flash_gat_fwd=ITERATIONS)
    kernels_vs_plain_forward("attention flagship", server, ir, params, samples[0], dev,
                             (None, torch.bfloat16))
    arrays = server.build_batch([samples[0]])
    inputs = to_device({k: v for k, v in arrays.items()
                        if k not in ("label", "label_mask")}, dev)
    fwd = forward_ms(server, inputs)
    e2e = []
    for _ in range(3):
        t1 = time.perf_counter()
        server.predict_samples([samples[0]])
        e2e.append((time.perf_counter() - t1) * 1e3)
    result["serving"] = dict(forward_ms=float(np.median(fwd)), request_ms=float(np.median(e2e)))
    print(f"[latency] attention flagship: device forward median {np.median(fwd):.3f} ms "
          f"(min {min(fwd):.3f}, max {max(fwd):.3f}, 20 runs, CUDA events); whole request "
          f"median {np.median(e2e):.1f} ms (3 runs, host clock) on {card}")
    result["serving"].update(print_profile(
        "attention flagship forward", lambda: server.forward_device(inputs),
        result["serving"]["forward_ms"]))

    # ---- training at the flagship size: kernels D and E ----
    t0 = time.perf_counter()
    arrays, meta = igt.build_batch([make_sample(rng, **FLAGSHIP)], ir, padding, training=True)
    print(f"[attention] build_batch(training=True) {time.perf_counter() - t0:.2f} s (host)")
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
    batch = to_device(arrays, trainer.device)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    init_tree, _, _ = step0_gradients_vs_plain(
        "attention", ir, padding, arrays, meta, state, batch, noise=1e-7)
    init_params = flatten_params(init_tree)
    step = trainer.train_step_fn(meta)
    metrics = []
    for i in range(ATTENTION_TRAIN_STEPS):
        counts.reset()
        state, m = step(state, batch)
        got = counts.read()
        add(got)
        # kernel A: the slice gather's backward, but for the first iteration,
        # whose link states need no gradient. Kernel E: but for the last
        # iteration, whose link states the readout (over paths) never reads,
        # so autograd has nothing to send back through that attention.
        expect_counts(f"attention training step {i}", got,
                      csr_segment_sum=ITERATIONS - 1, masked_gru_scan=ITERATIONS,
                      masked_gru_scan_bwd=ITERATIONS, flash_gat_fwd=ITERATIONS,
                      flash_gat_bwd=ITERATIONS - 1)
        metrics.append({k: float(v) for k, v in m.items()})
    print("  attention training: " + "; ".join(
        f"{k} " + " ".join(f"{m[k]:.5f}" for m in metrics) for k in ("total", "loss", "reg")))
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("attention training: a loss is not finite")
    regs = [m["reg"] for m in metrics]
    if not all(b < a for a, b in zip(regs, regs[1:])):
        raise AssertionError(f"attention training: the L2 term did not fall: {regs}")
    moved = {k: float((v.detach().cpu() - init_params[k]).abs().max())
             for k, v in flatten_params(state.params).items()}
    if not all(0.0 < v < 0.1 for v in moved.values()):
        raise AssertionError(f"attention training: parameters moved by {moved}")
    result["training"] = dict(
        losses=[m["total"] for m in metrics], regs=regs,
        **time_training_step("attention flagship", step, state, batch, arrays, card))

    # ---- 4x: past the dense cap, per-edge attention through kernel A ----
    sample = make_sample(rng, **FLAGSHIP_X4)
    server = serve_one_size(dev, ir, params, [sample], padding)
    counts.reset()
    preds = server.predict_samples([sample])
    got = counts.read()
    add(got)
    if preds.shape != (FLAGSHIP_X4["n_paths"],) or not np.all(np.isfinite(preds)):
        raise AssertionError(f"attention x4: {preds.shape} or non-finite")
    expect_counts(f"attention x4 request ({preds.shape[0]} predictions)", got,
                  csr_segment_sum=2 * ITERATIONS, masked_gru_scan=ITERATIONS)
    kernels_vs_plain_forward("attention x4 (per-edge)", server, ir, params, sample, dev,
                             (None,))
    arrays = server.build_batch([sample])
    inputs = to_device({k: v for k, v in arrays.items()
                        if k not in ("label", "label_mask")}, dev)
    fwd = forward_ms(server, inputs, runs=10)
    result["serving_x4"] = dict(forward_ms=float(np.median(fwd)))
    print(f"[latency] attention x4 (per-edge): device forward median {np.median(fwd):.3f} ms "
          f"(10 runs, CUDA events) on {card}")
    result["serving_x4"].update(print_profile(
        "attention x4 forward", lambda: server.forward_device(inputs),
        result["serving_x4"]["forward_ms"]))

    # ---- hs=48: a width off 128, the id-keyed sum on a model path ----
    ir48 = igt.parse_model_description(attention_description(hs=48), FEATURE_DIMS)
    params48 = igt.build(ir48).init(torch.Generator().manual_seed(SEED))
    sample = make_sample(rng, **SMALL_PER_EDGE)
    server = serve_one_size(dev, ir48, params48, [sample], padding, compute_dtype=None)
    counts.reset()
    preds = server.predict_samples([sample])
    got = counts.read()
    add(got)
    if preds.shape != (SMALL_PER_EDGE["n_paths"],) or not np.all(np.isfinite(preds)):
        raise AssertionError(f"attention hs=48: {preds.shape} or non-finite")
    # per iteration: the numerator (width 48) by ids, the denominator (width 8)
    # by row pointers; both are launches of kernel A
    expect_counts(f"attention hs=48 request ({preds.shape[0]} predictions)", got,
                  csr_segment_sum=2 * ITERATIONS, segment_sum_ids=ITERATIONS,
                  masked_gru_scan=ITERATIONS)
    kernels_vs_plain_forward("attention hs=48 (per-edge)", server, ir48, params48, sample,
                             dev, (None,))
    # the per-edge backward on the card: `gather_by_dst` and the id-keyed sum
    # under autograd, both through kernel A
    arrays, meta = igt.build_batch([sample], ir48, padding, training=True)
    trainer = igt.Trainer(igt.build(ir48), padding, compute_dtype=None)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    step0_gradients_vs_plain("attention hs=48", ir48, padding, arrays, meta, state,
                             to_device(arrays, trainer.device), noise=1e-7)
    print("[attention] main path launch counts: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, **result)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 1: card and build ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s)"
          f" -> {_build.library_path().name}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- phase 2: kernels against their plain versions ----
    rng = np.random.default_rng(SEED)
    e_slices = FLAGSHIP["n_paths"] * FLAGSHIP["path_len"]
    print(f"[kernels] at the main paths' shapes on {card}")
    seg = check_segment_sum(dev, rng, "stage 2 forward at x4", 524_288,
                            FLAGSHIP_X4["n_links"], gathered=False)
    seg_bwd = check_segment_sum(dev, rng, "slice-gather backward", e_slices,
                                FLAGSHIP["n_links"], gathered=True)
    # per-edge attention at x4: the softmax denominator is [E, 8] -> [N, 8]
    seg_w8 = check_segment_sum(dev, rng, "attention x4 denominator", 524_288,
                               FLAGSHIP_X4["n_links"], gathered=False, d=8)
    seg_ids = check_segment_sum_ids(dev, rng, e_slices, FLAGSHIP["n_links"], 48)
    seg_ids32 = check_segment_sum_ids(dev, rng, e_slices, FLAGSHIP["n_links"], HS)
    gru = check_gru_scan(dev, rng)
    gru_bwd = check_gru_scan_bwd(dev, rng)
    gat = check_attention_kernels(dev, rng)

    # ---- phase 3: serving ----
    served = serve(dev, card)

    # ---- phase 4: training ----
    trained = train(dev, card)

    # ---- phase 5: the attention family ----
    attended = attention(dev, card)

    bf16 = torch.bfloat16
    csrc = "ignnition_tpu_torch/csrc/"
    pallas = "ignnition_tpu/ops/pallas/"
    sources = {
        "csr_segment_sum": (csrc + "segment_sum.cu", pallas + "segment_kernels.py:337", seg),
        "segment_sum_ids": (csrc + "segment_sum.cu", pallas + "segment_kernels.py:150",
                            seg_ids),
        "masked_gru_scan": (csrc + "gru_scan.cu", pallas + "rnn_kernels.py:260", gru),
        "masked_gru_scan_bwd": (csrc + "gru_scan_bwd.cu", pallas + "rnn_kernels.py:279",
                                gru_bwd),
        "flash_gat_fwd": (csrc + "flash_gat.cu", pallas + "attention_kernels.py:136",
                          gat["fwd"]),
        "flash_gat_bwd": (csrc + "flash_gat.cu", pallas + "attention_kernels.py:212",
                          gat["bwd"]),
    }
    kernels = []
    for name, (source, replaces, checked) in sources.items():
        on_serving = served["launches"].get(name, 0)
        on_training = trained["launches"].get(name, 0)
        on_attention = attended["launches"][name]
        if on_serving + on_training + on_attention == 0:
            raise AssertionError(f"kernel {name} was launched on no main path")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=on_serving + on_training + on_attention,
            launches_serving=on_serving, launches_training=on_training,
            launches_attention=on_attention,
            **checked[bf16], f32=checked[torch.float32],
        ))
    kernels[0]["at_slice_gather_backward_shape"] = dict(
        bf16=seg_bwd[bf16], f32=seg_bwd[torch.float32])
    kernels[0]["at_width_8"] = dict(bf16=seg_w8[bf16], f32=seg_w8[torch.float32])
    kernels[1]["at_width_32"] = dict(bf16=seg_ids32[bf16], f32=seg_ids32[torch.float32])
    for k, which in ((kernels[4], "fwd"), (kernels[5], "bwd")):
        k["over_4_graph_blocks"] = gat["blocks"][which][bf16]
    print(json.dumps({"kernels": kernels, "latency": served["latency"],
                      "training": trained["steps"],
                      "attention": {k: v for k, v in attended.items() if k != "launches"},
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
