"""The one traffic generator: raw graph samples from a mix's parameters and a seed.

A traffic mix is a data file, `gnnbench/traffic/<mix>.json`, whose `family`
names a module `gnnbench/traffic/<family>.py` and whose other keys are that
family's parameters. A family module has `generate(mix, shape, rng)`, which
returns one batch's raw samples, and `small(mix)` and `medium(mix)`, the mix
cut for the tests on the CPU. The same (mix, seed) gives the same samples,
on any machine. Every seed gets the same set of graphs in each batch: their
structure is drawn from the batch's index alone (`shape`), and the seed
(`rng`) draws the order of the samples, a relabelling of each sample's nodes
or links, and every feature and label. So every seed does the same work and
holds the same memory, in another order.

A raw sample is a plain dict of numpy arrays, the dataset's content and
nothing the program derives from it:

    {"num_nodes": {entity: n},
     "features": {feature: float32 [n, 1]},      (before any normalization)
     "adjacencies": {adj: (src, dst, seq)},      (int32 [E] each, grouped by
                                                  destination, `seq` the
                                                  position of an edge among
                                                  its destination's sources)
     "label": float32 [rows]}
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import List

import numpy as np

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    """The parameters of the traffic mix `name` (`traffic/<name>.json`)."""
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def rng_for(seed: int, *purpose: int) -> np.random.Generator:
    """A numpy generator for one purpose of one run's seed (any non-negative
    whole number, past 32 bits too)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *purpose]))


def family(mix: dict):
    """The module of the mix's family (`traffic/<family>.py`)."""
    return importlib.import_module(f"gnnbench.traffic.{mix['family']}")


def batch(mix: dict, seed: int, index: int) -> List[dict]:
    """The raw samples of batch `index` of the mix under `seed`."""
    return family(mix).generate(mix, rng_for(0, 2, index), rng_for(seed, 1, index))


def balanced(lo: int, hi: int, count: int, rng: np.random.Generator) -> np.ndarray:
    """`count` whole numbers lo..hi, each as often as the count allows, in a
    random order."""
    values = np.arange(lo, hi + 1)
    reps = -(-count // len(values))
    return rng.permutation(np.tile(values, reps)[:count])


def random_distinct(rng: np.random.Generator, rows: int, n: int, k: int) -> np.ndarray:
    """[rows, k] distinct picks from range(n) in each row, in a random order."""
    keys = rng.random((rows, n))
    idx = np.argpartition(keys, k - 1, axis=1)[:, :k]
    order = np.argsort(np.take_along_axis(keys, idx, axis=1), axis=1)
    return np.take_along_axis(idx, order, axis=1)


def group_by_dst(src: np.ndarray, dst: np.ndarray, n_dst: int):
    """(src, dst, seq) of an edge list stably sorted by destination."""
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(dst, minlength=n_dst)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    seq = np.arange(len(dst)) - starts
    return src.astype(np.int32), dst.astype(np.int32), seq.astype(np.int32)
