"""The split of the device's idle time in a traced window by what held it
back, on the profiler's records with their correlation ids (the accepted
`trace.Trace` keeps no ids, so no run reads it yet).

A gap of the device's busy timeline is **starved** when the host call that
launched the device record ending it (matched by the profiler's correlation
id: a kernel of a graph replay carries the id of its `cudaGraphLaunch`, a
copy that of its `cudaMemcpyAsync`) began after the gap did: nothing was
queued. The other gaps closed by a record are the device's own pauses
between work it already held (between a graph's nodes, on a stream event).
The stretch after the last record is neither, and counts only as idle.
Where fewer than `MATCHED` of the window's device records find their
launching call, the split is not given.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

MATCHED = 0.95  # the least share of device records whose launch is found
Record = Tuple[str, float, float, int]  # (name, start s, end s, correlation id)


def split(window: Tuple[float, float], device: List[Record],
          launches: Dict[int, Tuple[str, float, float]]) -> dict:
    """The idle stretches of `device` (clipped to `window`) split into
    starved, the device's own pauses, and the tail after the last record, in
    seconds; `launches` maps a correlation id to its host call (name, start,
    end). `starved` lists each starved gap with the call that ended it."""
    lo, hi = window
    inside = sorted((r for r in device if r[2] > lo and r[1] < hi), key=lambda r: r[1])
    matched = sum(1 for r in inside if r[3] in launches)
    out = {"window_s": hi - lo, "records": len(inside),
           "matched": matched / len(inside) if inside else 0.0,
           "idle_s": 0.0, "starved_s": None, "paused_s": None, "tail_s": 0.0, "starved": []}
    at, starved, paused = lo, 0.0, 0.0
    for name, s, e, cid in inside:
        s = max(s, lo)
        if s > at:
            launch = launches.get(cid)
            if launch is not None and launch[1] > at:
                starved += s - at
                out["starved"].append((at, s, name, launch))
            else:
                paused += s - at
            out["idle_s"] += s - at
        at = max(at, min(e, hi))
    if hi > at:
        out["tail_s"] = hi - at
        out["idle_s"] += hi - at
    if out["matched"] >= MATCHED:
        out["starved_s"], out["paused_s"] = starved, paused
    else:
        out["starved"] = []
    return out


def innermost(host: List[Tuple[str, float, float]], t: float, prefix: str) -> Optional[str]:
    """The name of the shortest host record whose name starts with `prefix`
    and which holds the time `t`, or None."""
    best = None
    for name, s, e in host:
        if name.startswith(prefix) and s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else None


def starved_by_span(result: dict, host: List[Tuple[str, float, float]]) -> Dict[str, float]:
    """The starved seconds by the program's innermost span (`igt.`) around
    the call that ended each starved gap, and by that call's name."""
    by: Dict[str, float] = {}
    for s, e, _, (call, start, _) in result["starved"]:
        key = f"{innermost(host, start, 'igt.') or '(no program span)'} / {call}"
        by[key] = by.get(key, 0.0) + (e - s)
    return by


def starved_by_host_at_start(result: dict,
                             host: List[Tuple[str, float, float]]) -> Dict[str, float]:
    """The starved seconds by the host's innermost work when each starved gap
    began: what the host was doing when the device ran out of work (a
    `cudaStreamSynchronize`: a read that waited for the device)."""
    by: Dict[str, float] = {}
    for s, e, _, _ in result["starved"]:
        key = innermost(host, s, "") or "(host idle)"
        by[key] = by.get(key, 0.0) + (e - s)
    return by
