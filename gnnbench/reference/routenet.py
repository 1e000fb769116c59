"""Plain reference of RouteNet (Rusek et al., arXiv:1910.01508) as the frozen
description `configs/routenet.json` states it.

Link and path states of width hs start as [normalized feature, 0, ...]. Each
of the iterations: every path runs the GRU over the states of its links in
path order, from its own state (stage 1, "ordered"); then every link adds the
new states of the paths that cross it and applies its GRU to the sum (stage 2,
"sum"). The readout's Dense stack maps each path's state to its predicted log
delay; the loss is the mean squared error against log(delay) plus the L2 terms.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import common


def _hs(desc: dict) -> int:
    sizes = {e["hidden_state_dimension"] for e in desc["entities"]}
    if len(sizes) != 1:
        raise ValueError("the reference expects one state width for links and paths")
    return sizes.pop()


def _readout(desc: dict) -> List[dict]:
    name = desc["readout"][0]["nn_name"]
    return next(n for n in desc["neural_networks"] if n["nn_name"] == name)["nn_architecture"]


def param_spec(config: dict) -> Dict[str, tuple]:
    """{leaf: (shape, init)} under the names the benchmark hands to both sides."""
    desc = config["description"]
    hs = _hs(desc)
    spec = {}
    spec.update(common.gru_spec("update/path_update", hs, hs))
    spec.update(common.gru_spec("update/link_update", hs, hs))
    spec.update(common.mlp_spec(_readout(desc), "readout/op0", hs))
    return spec


def prepare(raws: List[dict], config: dict, device) -> dict:
    """The merged batch as the reference reads it, from raw samples: each
    path's links in order ([paths, longest], the missing ones naming an extra
    zero row), its length, the (path, link) pairs of stage 2, the normalized
    features and the log of the labels."""
    scale = config["normalizations"]["normalization_routenet"]
    link_off = np.cumsum([0] + [r["num_nodes"]["link"] for r in raws])
    path_off = np.cumsum([0] + [r["num_nodes"]["path"] for r in raws])
    n_links, n_paths = int(link_off[-1]), int(path_off[-1])
    src = np.concatenate([r["adjacencies"]["adj_links_paths"][0] + link_off[i]
                          for i, r in enumerate(raws)])
    dst = np.concatenate([r["adjacencies"]["adj_links_paths"][1] + path_off[i]
                          for i, r in enumerate(raws)])
    seq = np.concatenate([r["adjacencies"]["adj_links_paths"][2] for r in raws])
    longest = int(seq.max()) + 1
    path_links = np.full((n_paths, longest), n_links, np.int64)
    path_links[dst, seq] = src
    lengths = np.bincount(dst, minlength=n_paths)
    pl_src = np.concatenate([r["adjacencies"]["adj_paths_links"][0] + path_off[i]
                             for i, r in enumerate(raws)])
    pl_dst = np.concatenate([r["adjacencies"]["adj_paths_links"][1] + link_off[i]
                             for i, r in enumerate(raws)])

    def feature(name):
        a, b = scale[name]
        return (np.concatenate([r["features"][name][:, 0] for r in raws]) - a) / b

    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return {
        "link_x": as_t(feature("link_capacity"), torch.float32),
        "path_x": as_t(feature("traffic"), torch.float32),
        "path_links": as_t(path_links, torch.int64),
        "lengths": as_t(lengths, torch.int64),
        "pl_src": as_t(pl_src, torch.int64),
        "pl_dst": as_t(pl_dst, torch.int64),
        "label": as_t(np.log(np.concatenate([r["label"] for r in raws]).astype(np.float64)),
                      torch.float32),
    }


def predictions(params, b: dict, config: dict, rnd) -> torch.Tensor:
    desc = config["description"]
    hs = _hs(desc)
    p = {k: rnd(v) for k, v in params.items()}
    n_links, n_paths = b["link_x"].shape[0], b["path_x"].shape[0]
    dev = b["link_x"].device
    hl = rnd(torch.cat([b["link_x"][:, None], torch.zeros(n_links, hs - 1, device=dev)], 1))
    hp = rnd(torch.cat([b["path_x"][:, None], torch.zeros(n_paths, hs - 1, device=dev)], 1))
    zero_row = torch.zeros(1, hs, device=dev)
    for _ in range(int(desc["message_passing"]["num_iterations"])):
        table = torch.cat([hl, zero_row], 0)
        h = hp
        for t in range(b["path_links"].shape[1]):
            step = common.gru(table[b["path_links"][:, t]], h, p, "update/path_update", rnd)
            h = torch.where((t < b["lengths"])[:, None], step, h)
        hp = h
        agg = rnd(torch.zeros(n_links, hs, device=dev).index_add(0, b["pl_dst"], hp[b["pl_src"]]))
        hl = common.gru(agg, hl, p, "update/link_update", rnd)
    return common.mlp(hp, _readout(desc), p, "readout/op0", rnd)[:, 0]


def loss(params, b: dict, config: dict, rnd):
    """(mean squared error of the log delay, L2 terms)."""
    preds = predictions(params, b, config, rnd)
    data = torch.mean((preds - b["label"]) ** 2)
    return data, common.l2(_readout(config["description"]), params, "readout/op0")
