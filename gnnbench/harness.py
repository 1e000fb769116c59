"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the plain reference, and the result line.

Everything a cell needs is found by name: its entry in `BENCHMARK.json`
(configuration, traffic mix, chips, metrics), `workloads/<cell>.json` (the
compute type is the configuration's; here the rotation's log interval, the
traced steps and the limits of the comparison), `configs/<config>.json`,
`traffic/<mix>.json` and its `traffic/<family>.py`, `reference/<config>.py`,
`cost/<config>.py` and `metrics/<metric>.py`.
"""

from __future__ import annotations

import importlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from . import compare, counts, generate

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CHECKED = 3  # the first steps, compared with the reference
FORBIDDEN = ("jax", "jaxlib", "flax", "ignnition_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    run: dict  # workloads/<cell>.json
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def load_cell(name: str) -> Cell:
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry = next((c for c in bench["workloads"] if c["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(ROOT / cfg["file"]) as f:
        config = json.load(f)
    with open(HERE / "workloads" / f"{name}.json") as f:
        run = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, int(entry["chips"]), config, generate.load_mix(entry["traffic"]), run,
                e2e, per_layer)


@dataclass
class Window:
    """What the per-layer readers read (`metrics/<name>.py`)."""
    config: dict
    chips: int
    raws: List[List[dict]]  # the rotation's batches, raw
    costs: List[dict]  # each batch's required operations and bytes (cost/<config>.py)
    order: List[int] = field(default_factory=list)  # the batch of each measured step
    window_s: float = 0.0
    host_step_s: List[float] = field(default_factory=list)  # each call into the step
    trace: object = None  # trace.Trace of the traced steps
    traced_order: List[int] = field(default_factory=list)


def say(msg: str) -> None:
    print(f"gnnbench: {msg}", file=sys.stderr, flush=True)


def modules(name: str, config: dict):
    return importlib.import_module(f"gnnbench.{name}.{config['name']}")


def check_leaves(prog_shapes: Dict[str, tuple], spec: Dict[str, tuple]) -> None:
    mine = {k: tuple(v[0]) for k, v in spec.items()}
    if mine != prog_shapes:
        raise RuntimeError(f"the program's parameter leaves {prog_shapes} differ from the "
                           f"reference's {mine}")


def first_steps(prog, batches, weights, beta_1: float) -> dict:
    """Start the program from `weights` and run the checked steps through the
    window's own call: their losses, the first gradient (Adam's first moment
    after one step over 1 - beta_1) and the parameters' change after them."""
    prog.start(weights)
    p0 = prog.params()
    losses, grad1 = [], None
    for i in range(CHECKED):
        arrays, meta = batches[i % len(batches)]
        logs = prog.step(arrays, meta)
        losses.append(logs["loss"])
        if grad1 is None:
            grad1 = {k: v / (1.0 - beta_1) for k, v in prog.first_moment().items()}
    delta = {k: v - p0[k] for k, v in prog.params().items()}
    return {"loss": losses, "grad1": grad1, "delta": delta}


def reference_side(cell: Cell, raws: List[List[dict]], weights, device, rounding="float32"):
    """The reference's checked steps (`reference.common.train`); `rounding`
    "control" computes them in the configuration's control precision."""
    from .reference import common

    if rounding == "control":
        rounding = common.CONTROLS[cell.config["compute_dtype"]]
    ref = modules("reference", cell.config)
    prepared = [ref.prepare(raws[i], cell.config, device) for i in range(CHECKED)]
    return common.train(lambda p, b, r: ref.loss(p, b, cell.config, r), weights, prepared,
                        cell.config["description"]["learning_options"]["optimizer"],
                        rounding=rounding, steps=CHECKED)


def beta_1(config: dict) -> float:
    return float(config["description"]["learning_options"]["optimizer"].get("beta_1", 0.9))


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float,
            step_hook=None) -> dict:
    """One run of `cell` on `device`; returns the result line as a dict.
    `step_hook(step) -> step` wraps the program's step (the faults of the
    benchmark's tests)."""
    import torch

    from . import peaks, port, trace as tracing, weights as weights_mod

    config = cell.config
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        say(f"peaks {peaks.FLOPS} FLOP/s, {peaks.HBM_BYTES:.4g} B/s; card {power_limit()}")
    raws = [generate.batch(cell.mix, seed, i) for i in range(int(cell.mix["batches"]))]
    spec = modules("reference", config).param_spec(config)
    prog = port.Program(config, device, config["compute_dtype"])
    if step_hook is not None:
        prog.step = step_hook(prog.step)
    check_leaves(prog.leaf_shapes(), spec)
    w = weights_mod.make(spec, seed, device)
    batches = [prog.batch(r) for r in raws]
    checked = first_steps(prog, batches, w, beta_1(config))
    calls: Dict[object, int] = {}
    for i in range(CHECKED):
        calls[batches[i][1]] = calls.get(batches[i][1], 0) + 1
    for arrays, meta in batches:  # every shape warmed and captured before the window
        while calls.get(meta, 0) < 2:
            prog.step(arrays, meta)
            calls[meta] = calls.get(meta, 0) + 1
    cost = modules("cost", config)
    win = Window(config, cell.chips, raws, [cost.step(r, config) for r in raws])
    messages = [counts.edge_messages(r, config["description"]) for r in raws]
    log_every = int(cell.run["log_every"])
    state = {"s": CHECKED, "nonfinite": 0}

    def one_step(order, host=None):
        b = state["s"] % len(batches)
        h = time.perf_counter()
        logs = prog.step(*batches[b])
        if host is not None:
            host.append(time.perf_counter() - h)
        state["s"] += 1
        order.append(b)
        if state["s"] % log_every == 0:
            if not all(math.isfinite(float(logs[k])) for k in ("loss", "reg", "total")):
                state["nonfinite"] += 1

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    setup_s = start - t0
    while True:
        one_step(win.order, win.host_step_s)
        if time.perf_counter() - start >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    win.window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced:
        from torch.profiler import record_function

        def run_steps(n):
            for _ in range(n):
                with record_function("gnnbench.step"):
                    one_step(win.traced_order)

        win.trace = tracing.record(run_steps, int(cell.run["trace_steps"]))
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = importlib.import_module(f"gnnbench.metrics.{m['name']}").read(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "train_Medge_msgs_per_s": sum(messages[b] for b in win.order) / win.window_s / 1e6,
            "peak_device_MiB": peak / 2 ** 20,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    checked["loss"] = [float(x) for x in checked["loss"]]
    prog.release()
    del batches, prog
    values = compare.gaps(checked, reference_side(cell, raws, w, device))
    limits = cell.run["limits"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": compare.judge(values, limits) and state["nonfinite"] == 0,
              "attempted": len(win.order), "failed": state["nonfinite"],
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = win.trace.busy_s()
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = {k: {"value": values[k], "limit": limits[k]} for k in compare.NAMES}
    return result


def forbidden_loaded() -> List[str]:
    """The JAX packages in this process, by whole top-level names."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv: Optional[list] = None, t0: Optional[float] = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must not be negative")
    try:
        cell = load_cell(args.workload)
    except (KeyError, FileNotFoundError) as err:
        say(f"{err}")
        return 2
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        say(f"the cell {cell.name} needs {cell.chips} CUDA device(s); this machine has {found}")
        return 2
    if cell.chips != 1:
        say(f"the cell {cell.name} asks for {cell.chips} chips: four-chip cells are not built")
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), t0)
    bad = forbidden_loaded()
    if bad:
        say(f"the process holds {', '.join(bad)}: the benchmark measures ignnition_tpu_torch "
            "alone")
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
