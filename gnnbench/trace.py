"""The traced window: a few steps under torch.profiler, read into plain lists.

The benchmark's own spans (`torch.profiler.record_function`) mark the window
(`gnnbench.window`) and each step (`gnnbench.step`: the call into the compiled
step, and every `log_every` steps the read of its losses to the host). The
device's timeline is every kernel, copy and set in the window; the spans'
marks on it are left out. Nothing is written to disk.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

Interval = Tuple[str, float, float]  # (name, start s, end s)

ATTRIBUTED = 400  # the longest idle stretches named by the host's work; the rest summed


@dataclass
class Trace:
    window: Tuple[float, float]  # the traced window, on the profiler's clock, seconds
    device: List[Interval] = field(default_factory=list)  # kernels, copies, sets
    host: List[Interval] = field(default_factory=list)  # host ops and spans
    steps: int = 0

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, parts: Tuple[str, ...]) -> List[Interval]:
        """The device records whose name holds one of `parts`."""
        return [d for d in self.device if any(p in d[0] for p in parts)]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's records, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle stretches of the device inside the window."""
        lo, hi = self.window
        out, at = [], lo
        for s, e in self.busy():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if hi > at:
            out.append((at, hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host op or span running at `t`, or "(host idle)"."""
        best = None
        for name, s, e in self.host:
            if s <= t <= e and name != "gnnbench.window" and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "(host idle)"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        stretches summed by what the host was doing at their middle, in
        seconds."""
        ops: dict = {}
        for name, s, e in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s)
        idle: dict = {}
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])
        for s, e in gaps[:ATTRIBUTED]:
            name = self.host_at((s + e) / 2)
            idle[name] = idle.get(name, 0.0) + (e - s)
        if len(gaps) > ATTRIBUTED:
            idle["(shorter gaps)"] = sum(e - s for s, e in gaps[ATTRIBUTED:])
        best = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(idle)}


def record(run_steps, steps: int, attempts: int = 3) -> Trace:
    """Profile `run_steps(steps)` (which syncs the device at its end) and
    read the profile; taken again, up to `attempts` times, while the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    trace = None
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("gnnbench.window"):
                run_steps(steps)
                torch.cuda.synchronize()
        events = list(prof.events())
        win = next(e for e in events if e.name == "gnnbench.window")
        trace = Trace(window=(win.time_range.start / 1e6, win.time_range.end / 1e6), steps=steps)
        for e in events:
            rec = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            if e.device_type != DeviceType.CUDA:
                trace.host.append(rec)
            elif not e.name.startswith("gnnbench."):  # a span's mark on the device's timeline
                trace.device.append(rec)
        if trace.device:
            break
    return trace
