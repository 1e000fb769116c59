"""The port's host side of destination sharding against the JAX package's,
on the CPU, with no world of processes: the locality renumbering
(`parallel/locality.py`: `locality_order`, `reorder_sample`,
`boundary_edge_count`) and the partitioner's numpy functions
(`parallel/edgeshard.py`: `partition_batch`, `partition_dims`,
`halo_fractions`, `comm_bytes_per_step`). Both packages' copies run on the
same samples (each package's own `GraphSample` and `build_batch` output of
the same raw graphs); orders, samples and partitioned arrays must be equal
bit for bit, the accounting at rtol 1e-12. The samples are those of
`tests/test_locality.py` and `tests/test_edgeshard.py`.
"""

import copy

import numpy as np
import pytest

import ignnition_tpu_torch as igt
from ignnition_tpu.data import SampleSpec as JSpec
from ignnition_tpu.data import build_batch as j_build_batch
from ignnition_tpu.data import convert_sample as j_convert
from ignnition_tpu.data.dataset import AdjacencyArrays as JAdj
from ignnition_tpu.data.dataset import GraphSample as JSample
from ignnition_tpu.data.graph import PaddingConfig as JPadding
from ignnition_tpu.data.synthetic import make_routenet_sample
from ignnition_tpu.frontend import parser as j_parser
from ignnition_tpu.parallel import edgeshard as j_es
from ignnition_tpu.parallel import locality as j_loc
from ignnition_tpu_torch.data.dataset import AdjacencyArrays as TAdj
from ignnition_tpu_torch.data.dataset import GraphSample as TSample
from ignnition_tpu_torch.parallel import edgeshard as t_es
from ignnition_tpu_torch.parallel import locality as t_loc

from helpers import TINY_SAMPLE, qsize_description, routenet_description

DIMS = {"link_capacity": 1, "traffic": 1, "queue_sizes": 1,
        "adj_links_paths": 0, "adj_paths_links": 0}
PAD = dict(mode="multiple", multiple=32, min_size=32)
SMALL_PAD = dict(mode="multiple", multiple=8, min_size=8)


def _irs(desc, dims=DIMS):
    return (j_parser.parse_model_description(copy.deepcopy(desc), dict(dims)),
            igt.parse_model_description(copy.deepcopy(desc), dict(dims)))


def _samples(irs, raws):
    """Each package's converted samples of the same raw graphs."""
    return tuple([conv(copy.deepcopy(r), spec.from_ir(ir)) for r in raws]
                 for conv, spec, ir in ((j_convert, JSpec, irs[0]),
                                        (igt.convert_sample, igt.SampleSpec, irs[1])))


def _window_graph(cls, adj, n_links, n_paths, path_len, window, shuffle, seed):
    """`tests/test_locality.py`'s latent-local graph (scrambled ids when
    `shuffle`), as a GraphSample of the given package."""
    rng = np.random.default_rng(seed)
    anchors = np.sort(rng.integers(0, n_links, n_paths))
    offs = rng.integers(-window, window + 1, (n_paths, path_len))
    links = (anchors[:, None] + offs) % n_links
    if shuffle:
        links = rng.permutation(n_links)[links]
        links = links[rng.permutation(n_paths)]
    src_lp = links.reshape(-1).astype(np.int32)
    dst_lp = np.repeat(np.arange(n_paths, dtype=np.int32), path_len)
    seq_lp = np.tile(np.arange(path_len, dtype=np.int32), n_paths)
    order = np.argsort(src_lp, kind="stable")
    src_pl, dst_pl = dst_lp[order].copy(), src_lp[order].copy()
    counts = np.bincount(dst_pl, minlength=n_links)
    seq_pl = np.concatenate([np.arange(c, dtype=np.int32) for c in counts])
    return cls(
        num_nodes={"link": n_links, "path": n_paths},
        features={"link_capacity": rng.uniform(20, 40, (n_links, 1)).astype(np.float32),
                  "traffic": rng.uniform(0.2, 0.8, (n_paths, 1)).astype(np.float32)},
        adjacencies={"adj_links_paths": adj(src_lp, dst_lp, seq_lp),
                     "adj_paths_links": adj(src_pl, dst_pl, seq_pl)},
        label=rng.uniform(0.1, 1.0, n_paths).astype(np.float32),
    )


def _windows(**kw):
    return (_window_graph(JSample, JAdj, **kw), _window_graph(TSample, TAdj, **kw))


def _assert_samples_equal(a, b):
    assert a.num_nodes == b.num_nodes
    for field in ("features", "extras", "interleave"):
        x, y = getattr(a, field), getattr(b, field)
        assert sorted(x) == sorted(y), field
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)
    assert sorted(a.adjacencies) == sorted(b.adjacencies)
    for k, arrs in a.adjacencies.items():
        other = b.adjacencies[k]
        for f in ("src_idx", "dst_idx", "seq", "params"):
            u, v = getattr(arrs, f), getattr(other, f)
            assert (u is None) == (v is None), (k, f)
            if u is not None:
                np.testing.assert_array_equal(u, v, err_msg=f"{k}.{f}")
                assert np.asarray(u).dtype == np.asarray(v).dtype, (k, f)
    if a.label is None:
        assert b.label is None
    else:
        np.testing.assert_array_equal(np.asarray(a.label), np.asarray(b.label))


def _assert_orders_equal(a, b):
    assert sorted(a) == sorted(b)
    for ent in a:
        np.testing.assert_array_equal(a[ent], b[ent], err_msg=ent)
        assert a[ent].dtype == b[ent].dtype


# --------------------------------------------------------------------------
# locality
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [None, 2, 4])
@pytest.mark.parametrize("shuffle", [True, False])
def test_locality_order_equals_jax_on_window_graphs(m, shuffle):
    """The scrambled and the well-numbered windowed graphs of
    `tests/test_locality.py`: the orders, bit for bit, with and without
    the padded row counts, and the block-boundary fractions they give."""
    irs = _irs(routenet_description(num_iterations=2, hs=8))
    js, ts = _windows(n_links=256, n_paths=1024, path_len=8, window=16, shuffle=shuffle,
                      seed=3 if shuffle else 4)
    for node_pad in (None, {"link": 264, "path": 1040}):
        jo = j_loc.locality_order(js, irs[0], n_model=m, node_pad=node_pad)
        to = t_loc.locality_order(ts, irs[1], n_model=m, node_pad=node_pad)
        _assert_orders_equal(jo, to)
        for k in (2, 4):
            assert j_loc.boundary_edge_count(js, irs[0], jo, k, node_pad=node_pad) == \
                t_loc.boundary_edge_count(ts, irs[1], to, k, node_pad=node_pad)


@pytest.mark.parametrize("model", ["routenet", "qsize", "edge_extras"])
def test_reorder_sample_equals_jax(model):
    """`reorder_sample` on RouteNet, Q-size (three entities, interleave
    vectors) and an edge-label model with an entity-shaped extra: the
    renumbered samples and the orders equal the JAX package's."""
    rng = np.random.default_rng(13)
    if model == "qsize":
        irs = _irs(qsize_description(num_iterations=2, hs=8))
        raw = make_routenet_sample(rng, 14, 10, 4, with_nodes=True)
    else:
        desc = routenet_description(num_iterations=2, hs=8)
        raw = make_routenet_sample(rng, 16, 12, 4)
        if model == "edge_extras":
            desc["readout"] = [
                {"type": "product", "type_product": "element_wise",
                 "input": ["path", "path_weights"], "output_name": "pw"},
                {"type": "extend_adjacencies", "adj_list": "adj_links_paths",
                 "input": ["link", "pw"], "output_name_src": "esrc", "output_name_dst": "edst"},
                {"type": "product", "type_product": "element_wise",
                 "input": ["esrc", "edst"], "output_name": "pair"},
                {"type": "predict", "input": ["pair"], "label": "edge_label",
                 "nn_name": "readout_model"},
            ]
            n_edges = sum(len(v) for v in raw["adj_links_paths"].values())
            raw["edge_label"] = rng.uniform(0.1, 1.0, n_edges).round(3).tolist()
            n_paths = sum(1 for t in raw["entities"].values() if t == "path")
            raw["path_weights"] = rng.uniform(0.5, 2.0, n_paths).round(3).tolist()
        irs = _irs(desc)
    (js,), (ts,) = _samples(irs, [raw])
    for m in (2, 4):
        jr, jo = j_loc.reorder_sample(js, irs[0], n_model=m)
        tr, to = t_loc.reorder_sample(ts, irs[1], n_model=m)
        _assert_orders_equal(jo, to)
        _assert_samples_equal(jr, tr)


def test_ambiguous_extra_is_left_unordered_as_in_jax():
    """An extra whose rows match two entities' counts: both packages return
    the sample unordered with identity orders."""
    desc = routenet_description(num_iterations=1, hs=8)
    desc["readout"][0]["input"] = ["path", "extra_in"]
    irs = _irs(desc, {"link_capacity": 1, "traffic": 1, "extra_in": 1})
    rng = np.random.default_rng(0)
    raw = make_routenet_sample(rng, n_links=9, n_paths=9)
    raw["extra_in"] = rng.uniform(0, 1, 9).tolist()
    (js,), (ts,) = _samples(irs, [raw])
    jr, jo = j_loc.reorder_sample(js, irs[0], n_model=2)
    tr, to = t_loc.reorder_sample(ts, irs[1], n_model=2)
    _assert_orders_equal(jo, to)
    for o in to.values():
        np.testing.assert_array_equal(o, np.arange(len(o)))
    _assert_samples_equal(jr, tr)


# --------------------------------------------------------------------------
# the partitioner
# --------------------------------------------------------------------------


def _routenet_raws(seed, n, size=(14, 10, 4)):
    rng = np.random.default_rng(seed)
    return [make_routenet_sample(rng, *size) for _ in range(n)]


def _edge_label_raws(seed=13, n=2):
    rng = np.random.default_rng(seed)
    raws = []
    for _ in range(n):
        raw = make_routenet_sample(rng, 14, 10, 4)
        n_edges = sum(len(v) for v in raw["adj_links_paths"].values())
        raw["edge_label"] = rng.uniform(0.1, 1.0, n_edges).round(3).tolist()
        raws.append(raw)
    return raws


def _edge_label_desc():
    desc = routenet_description(num_iterations=2, hs=8)
    desc["readout"] = [
        {"type": "extend_adjacencies", "adj_list": "adj_links_paths",
         "input": ["link", "path"], "output_name_src": "esrc", "output_name_dst": "edst"},
        {"type": "product", "type_product": "element_wise",
         "input": ["esrc", "edst"], "output_name": "pair"},
        {"type": "predict", "input": ["pair"], "label": "edge_label",
         "nn_name": "readout_model"},
    ]
    return desc


def _extra_input():
    desc = routenet_description(num_iterations=2, hs=8)
    desc["readout"] = [
        {"type": "product", "type_product": "element_wise",
         "input": ["path", "path_weights"], "output_name": "weighted"},
        {"type": "predict", "input": ["weighted"], "label": "delay",
         "nn_name": "readout_model"},
    ]
    rng = np.random.default_rng(21)
    raws = []
    for _ in range(2):
        raw = make_routenet_sample(rng, 14, 10, 4)
        n_paths = sum(1 for t in raw["entities"].values() if t == "path")
        raw["path_weights"] = rng.uniform(0.5, 2.0, n_paths).round(3).tolist()
        raws.append(raw)
    return desc, raws


def _qsize_raw():
    return {
        "entities": {**{f"l{i}": "link" for i in range(4)},
                     **{f"p{i}": "path" for i in range(3)},
                     **{f"n{i}": "node" for i in range(2)}},
        "link_capacity": [1.0, 2.0, 3.0, 4.0], "traffic": [0.5, 1.5, 1.0],
        "queue_sizes": [3.0, 7.0], "delay": [0.2, 0.4, 0.3],
        "adj_links_paths": {"p0": ["l0", "l1"], "p1": ["l1", "l2"], "p2": ["l3"]},
        "adj_nodes_paths": {"p0": ["n0"], "p1": ["n1"], "p2": ["n0"]},
        "adj_paths_links": {"l0": ["p0"], "l1": ["p0", "p1"], "l2": ["p1"], "l3": ["p2"]},
        "adj_paths_nodes": {"n0": ["p0", "p2"], "n1": ["p1"]},
        "path_interleave": ["link", "node"],
    }


def _batches(desc, raws, pad=PAD):
    """(JAX ir, port ir, JAX (arrays, meta), port (arrays, meta)) of the same
    raw graphs, training batches."""
    irs = _irs(desc)
    js, ts = _samples(irs, raws)
    return (*irs, j_build_batch(js, irs[0], JPadding(**pad), training=True),
            igt.build_batch(ts, irs[1], igt.PaddingConfig(**pad), training=True))


PARTITION_CASES = {
    "routenet": lambda: _batches(routenet_description(num_iterations=2, hs=8),
                                 _routenet_raws(5, 2)),
    "routenet_one_graph": lambda: _batches(routenet_description(num_iterations=2, hs=8),
                                           _routenet_raws(7, 1, (40, 30, 5)), SMALL_PAD),
    "qsize": lambda: _batches(qsize_description(num_iterations=2, hs=8), [_qsize_raw()]),
    "edge_labels": lambda: _batches(_edge_label_desc(), _edge_label_raws()),
    "extra_input": lambda: _batches(*_extra_input()),
}


def _assert_partitions_equal(j_out, t_out):
    (ja, jm), (ta, tm) = j_out, t_out
    assert repr(jm) == repr(tm)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
        assert ja[k].dtype == ta[k].dtype, k


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", sorted(PARTITION_CASES))
def test_partition_batch_equals_jax(name, m):
    """`partition_batch` of each package's batch of the same graphs: the
    local meta, and every stacked array key for key, bit for bit; then with
    the partition dims grown by one `_HALO_MULTIPLE` (the stream's pad_to),
    again equal; `partition_dims`, `halo_fractions` and
    `comm_bytes_per_step` of the partitions equal too."""
    j_ir, t_ir, (j_arrays, j_meta), (t_arrays, t_meta) = PARTITION_CASES[name]()
    j_out = j_es.partition_batch(j_arrays, j_meta, j_ir, m)
    t_out = t_es.partition_batch(t_arrays, t_meta, t_ir, m)
    _assert_partitions_equal(j_out, t_out)
    dims = t_es.partition_dims(t_out[0])
    assert dims == j_es.partition_dims(j_out[0])
    grown = {g: {a: v + 8 for a, v in d.items()} for g, d in dims.items()}
    _assert_partitions_equal(j_es.partition_batch(j_arrays, j_meta, j_ir, m, pad_to=grown),
                             t_es.partition_batch(t_arrays, t_meta, t_ir, m, pad_to=grown))
    assert j_es.halo_fractions(j_out[0], j_ir) == t_es.halo_fractions(t_out[0], t_ir)
    jc = j_es.comm_bytes_per_step(j_ir, j_meta, j_out[0], m)
    tc = t_es.comm_bytes_per_step(t_ir, t_meta, t_out[0], m)
    assert sorted(jc) == sorted(tc)
    for adj in jc:
        for k, v in jc[adj].items():
            np.testing.assert_allclose(tc[adj][k], v, rtol=1e-12, err_msg=f"{adj} {k}")


def test_reordered_partition_equals_jax_and_shrinks_the_halo():
    """`tests/test_locality.py`'s end-to-end case: a scrambled windowed graph
    renumbered for m=2 with its padded row counts, built and partitioned by
    each package: the partitions are equal, and the boundary fractions and
    the halo heights shrink against the unrenumbered partition."""
    irs = _irs(routenet_description(num_iterations=2, hs=8))
    js, ts = _windows(n_links=128, n_paths=512, path_len=6, window=12, shuffle=True, seed=6)
    out = []
    for ir, s, loc, build, es in ((irs[0], js, j_loc, j_build_batch, j_es),
                                  (irs[1], ts, t_loc, igt.build_batch, t_es)):
        arrays0, meta0 = build([s], ir)
        node_pad = {e.name: meta0.nodes(e.name) for e in ir.entities}
        orders = loc.locality_order(s, ir, n_model=2, node_pad=node_pad)
        re, _ = loc.reorder_sample(s, ir, orders=orders)
        arrays1, meta1 = build([re], ir)
        out.append((es.partition_batch(arrays0, meta0, ir, 2),
                    es.partition_batch(arrays1, meta1, ir, 2)))
    (j0, j1), (t0, t1) = out
    _assert_partitions_equal(j0, t0)
    _assert_partitions_equal(j1, t1)
    f0, f1 = t_es.halo_fractions(t0[0], irs[1]), t_es.halo_fractions(t1[0], irs[1])
    for adj in f0:
        assert f1[adj]["boundary_frac"] < f0[adj]["boundary_frac"], adj
    h0, h1 = (sum(v["halo"].values()) for v in map(t_es.partition_dims, (t0[0], t1[0])))
    assert h1 < h0


def test_partition_rejects_what_jax_rejects():
    """A flat additional input (rows matching no entity) raises
    `EdgeShardError` naming it, as in JAX; one shard raises too."""
    desc = routenet_description(num_iterations=1, hs=8)
    desc["readout"] = [
        {"type": "product", "type_product": "element_wise",
         "input": ["path", "mystery_vec"], "output_name": "weighted"},
        {"type": "predict", "input": ["weighted"], "label": "delay",
         "nn_name": "readout_model"},
    ]
    raw = dict(TINY_SAMPLE, mystery_vec=[1.0, 2.0, 3.0, 4.0])
    raw["entities"] = dict(TINY_SAMPLE["entities"])
    j_ir, t_ir, (ja, jm), (ta, tm) = _batches(desc, [raw])
    assert dict(tm.extra_layout)["mystery_vec"] == ""
    for es, ir, arrays, meta in ((j_es, j_ir, ja, jm), (t_es, t_ir, ta, tm)):
        with pytest.raises(es.EdgeShardError, match="additional readout input 'mystery_vec'"):
            es.partition_batch(arrays, meta, ir, 2)
    with pytest.raises(t_es.EdgeShardError, match="n_model >= 2"):
        t_es.partition_batch(ta, tm, t_ir, 1)
