"""Synthetic RouteNet-style dataset generation.

The reference ships with subsets of the KDN NSFNET/GEANT datasets
(readme.md:36-44) which are not redistributable here. This module produces
format-identical datasets (tar.gz archives of `data.json` sample lists, see
data/dataset.py) with a queueing-flavoured delay label so end-to-end training
has real signal:

    load(l)   = sum of traffic of paths crossing link l
    delay(p)  = sum over links l in p of 1 / (capacity_l - load_l)  (M/M/1-ish)

Used by the test-suite, the benchmark harness, and the quickstart examples.
"""

from __future__ import annotations

import json
import os
import tarfile
from io import BytesIO
from typing import Dict, List, Optional

import numpy as np


def make_routenet_sample(
    rng: np.random.Generator,
    n_links: int = 20,
    n_paths: int = 15,
    max_path_len: int = 6,
    with_nodes: bool = False,
) -> dict:
    """One synthetic sample in the reference dataset format.

    with_nodes=True adds a `node` entity, node adjacencies, and a
    `path_interleave` pattern — exercising the Q-size style model (reference
    examples/Q-size/model_description.json).
    """
    entities: Dict[str, str] = {}
    for i in range(n_links):
        entities[f"l{i}"] = "link"
    n_nodes = n_links if with_nodes else 0
    for i in range(n_nodes):
        entities[f"n{i}"] = "node"
    for i in range(n_paths):
        entities[f"p{i}"] = "path"

    capacity = rng.uniform(20.0, 40.0, n_links)
    traffic = rng.uniform(0.2, 0.8, n_paths)
    queue_sizes = rng.uniform(2.0, 32.0, n_nodes) if with_nodes else None

    paths: List[List[int]] = []
    for _ in range(n_paths):
        length = int(rng.integers(2, max_path_len + 1))
        paths.append(list(rng.choice(n_links, size=length, replace=False)))

    load = np.zeros(n_links)
    for p, links in enumerate(paths):
        for l in links:
            load[l] += traffic[p]

    delay = []
    for p, links in enumerate(paths):
        d = 0.0
        for l in links:
            d += 1.0 / max(capacity[l] - load[l], 1.0)
        if with_nodes:
            d += sum(0.01 * queue_sizes[l % n_nodes] for l in links)
        delay.append(d)

    adj_links_paths = {f"p{p}": [f"l{l}" for l in links] for p, links in enumerate(paths)}
    adj_paths_links: Dict[str, List[str]] = {f"l{l}": [] for l in range(n_links)}
    for p, links in enumerate(paths):
        for l in links:
            adj_paths_links[f"l{l}"].append(f"p{p}")
    # drop links with no paths from the adjacency dict (the reference format
    # simply omits destinations with no sources)
    adj_paths_links = {k: v for k, v in adj_paths_links.items() if v}

    sample = {
        "entities": entities,
        "link_capacity": capacity.tolist(),
        "traffic": traffic.tolist(),
        "delay": delay,
        "adj_links_paths": adj_links_paths,
        "adj_paths_links": adj_paths_links,
    }

    if with_nodes:
        # each path visits one node per link (so link/node blocks interleave
        # evenly and the tiled ['link','node'] pattern matches per-source
        # sequence lengths, as the Q-size datasets do)
        adj_nodes_paths = {}
        adj_paths_nodes: Dict[str, List[str]] = {}
        for p, links in enumerate(paths):
            nodes = [int(l) % n_nodes for l in links]
            adj_nodes_paths[f"p{p}"] = [f"n{n}" for n in nodes]
            for n in nodes:
                adj_paths_nodes.setdefault(f"n{n}", []).append(f"p{p}")
        sample["queue_sizes"] = queue_sizes.tolist()
        sample["adj_nodes_paths"] = adj_nodes_paths
        sample["adj_paths_nodes"] = adj_paths_nodes
        sample["path_interleave"] = ["link", "node"]
    return sample


def _write_archives(
    directory: str,
    make_sample,
    num_archives: int,
    samples_per_archive: int,
    seed: int,
    **sample_kw,
) -> None:
    """Shared writer: `num_archives` tar.gz files of `samples_per_archive`
    samples each, one `data.json` member per archive — the dataset layout
    data/dataset.py consumes (the migration tooling batches 100 samples per
    archive, reference migrate.py:119-127)."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for a in range(num_archives):
        samples = [
            make_sample(rng, **sample_kw) for _ in range(samples_per_archive)
        ]
        payload = json.dumps(samples).encode()
        path = os.path.join(directory, f"sample_{a}.tar.gz")
        with tarfile.open(path, "w:gz") as tar:
            info = tarfile.TarInfo("data.json")
            info.size = len(payload)
            tar.addfile(info, BytesIO(payload))


def write_dataset(
    directory: str,
    num_archives: int = 2,
    samples_per_archive: int = 10,
    seed: int = 0,
    with_nodes: bool = False,
    **sample_kw,
) -> None:
    _write_archives(
        directory, make_routenet_sample, num_archives, samples_per_archive,
        seed, with_nodes=with_nodes, **sample_kw,
    )


# --------------------------------------------------------------------------
# Homogeneous graph-property dataset (GAT/GCN-family example)
# --------------------------------------------------------------------------


def make_graphprop_sample(
    rng: np.random.Generator,
    n_nodes: int = 24,
    out_degree: int = 3,
    diffusion_steps: int = 3,
) -> dict:
    """One homogeneous-graph sample with a graph-level label.

    A single `node` entity with per-node injection `x` and capacity `cap`;
    a symmetric random `adj_nodes_nodes` adjacency; and a graph-level label
    `y` produced by a `diffusion_steps`-step nonlinear mean-diffusion of `x`
    over the graph, read out as a capacity-weighted mean:

        h_0     = x
        h_{k+1} = tanh(mean over in-neighbors of h_k + 0.5 * x)
        y       = mean(h_K * cap)

    A K-iteration GNN whose aggregation is (near-)mean — attention with
    learned-uniform weights, or degree-normalized convolution — can represent
    the label exactly, so training has real signal.
    """
    entities = {f"n{i}": "node" for i in range(n_nodes)}
    x = rng.normal(0.0, 1.0, n_nodes)
    cap = rng.uniform(0.5, 2.0, n_nodes)

    neighbors: List[set] = [set() for _ in range(n_nodes)]
    for i in range(n_nodes):
        for j in rng.choice(n_nodes, size=out_degree, replace=False):
            j = int(j)
            if j != i:
                neighbors[i].add(j)
                neighbors[j].add(i)  # symmetric
    # every node keeps at least one neighbor so the mean is well-defined
    for i in range(n_nodes):
        if not neighbors[i]:
            j = (i + 1) % n_nodes
            neighbors[i].add(j)
            neighbors[j].add(i)

    h = x.copy()
    for _ in range(diffusion_steps):
        agg = np.array([np.mean(h[list(neighbors[d])]) for d in range(n_nodes)])
        h = np.tanh(agg + 0.5 * x)
    y = float(np.mean(h * cap))

    adj_nodes_nodes = {
        f"n{d}": [f"n{s}" for s in sorted(neighbors[d])] for d in range(n_nodes)
    }
    return {
        "entities": entities,
        "x": x.tolist(),
        "cap": cap.tolist(),
        "y": [y],
        "adj_nodes_nodes": adj_nodes_nodes,
    }


def write_graphprop_dataset(
    directory: str,
    num_archives: int = 2,
    samples_per_archive: int = 10,
    seed: int = 0,
    **sample_kw,
) -> None:
    _write_archives(
        directory, make_graphprop_sample, num_archives, samples_per_archive,
        seed, **sample_kw,
    )


# --------------------------------------------------------------------------
# Link-prediction dataset (edge-domain label example)
# --------------------------------------------------------------------------


def make_linkpred_sample(
    rng: np.random.Generator,
    n_nodes: int = 20,
    out_degree: int = 3,
    noise: float = 0.05,
) -> dict:
    """One sample whose label lives on the EDGES of `adj_nodes_nodes`.

    Per-node scalar `x`; a random directed adjacency; per-edge label

        edge_score(s, d) = x_s * x_d + 0.3 * (x_s + x_d) + noise

    listed in the adjacency dict's insertion order (the reference dataset
    convention). Destinations are inserted in a SHUFFLED order on purpose:
    the merged batch destination-sorts its edge lists, and edge-domain
    labels/predictions must follow that reordering exactly — a dataset whose
    dict happens to be pre-sorted would hide alignment bugs.
    """
    entities = {f"n{i}": "node" for i in range(n_nodes)}
    x = rng.uniform(-1.0, 1.0, n_nodes)

    adj: dict = {}
    labels: List[float] = []
    for d in rng.permutation(n_nodes):
        d = int(d)
        srcs = [int(s) for s in rng.choice(n_nodes, size=out_degree, replace=False)
                if int(s) != d]
        if not srcs:
            srcs = [(d + 1) % n_nodes]
        adj[f"n{d}"] = [f"n{s}" for s in srcs]
        for s in srcs:
            labels.append(
                float(x[s] * x[d] + 0.3 * (x[s] + x[d])
                      + noise * rng.standard_normal())
            )
    return {
        "entities": entities,
        "x": x.tolist(),
        "edge_score": labels,
        "adj_nodes_nodes": adj,
    }


def write_linkpred_dataset(
    directory: str,
    num_archives: int = 2,
    samples_per_archive: int = 10,
    seed: int = 0,
    **sample_kw,
) -> None:
    _write_archives(
        directory, make_linkpred_sample, num_archives, samples_per_archive,
        seed, **sample_kw,
    )


# --------------------------------------------------------------------------
# GAT dataset (attention-aggregation example: the label is an
# importance-weighted softmax mean of neighbor signals)
# --------------------------------------------------------------------------


def make_gat_sample(
    rng: np.random.Generator,
    n_nodes: int = 24,
    out_degree: int = 4,
    temp: float = 2.0,
    noise: float = 0.02,
) -> dict:
    """One homogeneous-graph sample whose node label REQUIRES attention.

    Per-node `signal` and `importance`; a random directed adjacency; label

        y_d = sum_s softmax_s(temp * importance_s) * signal_s + 0.3 * signal_d

    (softmax over d's in-neighbors). A mean/sum aggregation cannot weight
    neighbors by their own importance, while GATv1 scores
    e = lrelu(a1.(K1 m_s) + a2.(K2 h_d)) can represent temp * importance_s
    directly — so attention models fit this dataset and uniform
    aggregations plateau (tests/test_gat_example.py proves real signal).
    """
    entities = {f"n{i}": "node" for i in range(n_nodes)}
    signal = rng.uniform(-1.0, 1.0, n_nodes)
    importance = rng.uniform(-1.0, 1.0, n_nodes)

    adj: dict = {}
    labels = np.zeros(n_nodes)
    for d in range(n_nodes):
        srcs = [int(s) for s in rng.choice(n_nodes, size=out_degree,
                                           replace=False) if int(s) != d]
        if not srcs:
            srcs = [(d + 1) % n_nodes]
        adj[f"n{d}"] = [f"n{s}" for s in srcs]
        w = np.exp(temp * importance[srcs])
        w /= w.sum()
        labels[d] = float(
            (w * signal[srcs]).sum() + 0.3 * signal[d]
            + noise * rng.standard_normal()
        )
    return {
        "entities": entities,
        "signal": signal.tolist(),
        "importance": importance.tolist(),
        "y": labels.tolist(),
        "adj_nodes_nodes": adj,
    }


def write_gat_dataset(
    directory: str,
    num_archives: int = 2,
    samples_per_archive: int = 10,
    seed: int = 0,
    **sample_kw,
) -> None:
    _write_archives(
        directory, make_gat_sample, num_archives, samples_per_archive,
        seed, **sample_kw,
    )
