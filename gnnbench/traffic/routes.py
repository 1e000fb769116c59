"""The `routes` family: RouteNet samples with synthetic routes.

Each sample has `links` directed links and `paths` paths. A path takes a
length from `path_len` (the whole batch holds the lengths lo..hi equally
often) and as many distinct links, drawn at random and in a random order:
the routes are random link sets, not shortest paths over a real topology,
and need not be connected. Link capacities are drawn from `capacities`, path
traffic uniformly from `traffic`; a path's delay is delay_scale * sum over
its links of 1 / max(capacity - load, 1), where a link's load is the traffic
of the paths that cross it (an M/M/1 flavour). `samples_per_batch` samples
make a batch.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..generate import balanced, group_by_dst, random_distinct


def generate(mix: dict, shape: np.random.Generator, rng: np.random.Generator) -> List[dict]:
    s, p, k = int(mix["samples_per_batch"]), int(mix["paths"]), int(mix["links"])
    lo, hi = mix["path_len"]
    lengths = balanced(lo, hi, s * p, shape).reshape(s, p)
    picks = random_distinct(shape, s * p, k, hi).reshape(s, p, hi)
    order = rng.permutation(s)
    capacity = rng.choice(np.asarray(mix["capacities"], np.float64), size=(s, k))
    traffic = rng.uniform(*mix["traffic"], size=(s, p))
    scale = float(mix["delay_scale"])
    out = []
    for i, j in enumerate(order):
        valid = np.arange(hi)[None, :] < lengths[j][:, None]
        src = rng.permutation(k)[picks[j][valid]]  # row-major: by path, then position
        dst = np.repeat(np.arange(p), lengths[j])
        seq = np.concatenate([np.arange(n) for n in lengths[j]])
        load = np.bincount(src, weights=traffic[i][dst], minlength=k)
        per_edge = 1.0 / np.maximum(capacity[i][src] - load[src], 1.0)
        delay = scale * np.bincount(dst, weights=per_edge, minlength=p)
        out.append({
            "num_nodes": {"link": k, "path": p},
            "features": {
                "link_capacity": capacity[i][:, None].astype(np.float32),
                "traffic": traffic[i][:, None].astype(np.float32),
            },
            "adjacencies": {
                "adj_links_paths": (src.astype(np.int32), dst.astype(np.int32),
                                    seq.astype(np.int32)),
                "adj_paths_links": group_by_dst(dst, src, k),
            },
            "label": delay.astype(np.float32),
        })
    return out


def medium(mix: dict) -> dict:
    """Samples at their full size, few to a batch: the size at which the
    control's readings stand where they do at the cells' own."""
    return {**mix, "samples_per_batch": 4, "batches": 3}


def small(mix: dict) -> dict:
    """A size the CPU runs in seconds."""
    return {**mix, "samples_per_batch": 2, "paths": 40, "batches": 3}
