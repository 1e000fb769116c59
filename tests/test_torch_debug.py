"""The port's `debug` verb against the JAX package's: the structure and
parameter reports and the model graph (DOT, SVG) byte for byte, the
TensorBoard graph event, and the exported program that takes the place of
the JAX package's model.hlo.txt."""

import copy
import filecmp
import glob
import json
import os

import jax
import pytest
import torch

import ignnition_tpu as ig
import ignnition_tpu_torch as igt
from ignnition_tpu import debuggraph as j_graph
from ignnition_tpu.config import RunConfig as JRunConfig
from ignnition_tpu.debug import params_report as j_params_report
from ignnition_tpu.debug import structure_report as j_structure_report
from ignnition_tpu.debug import write_debug_artifacts as j_write_debug_artifacts
from ignnition_tpu_torch import debuggraph as t_graph
from ignnition_tpu_torch.debug import params_report, structure_report, write_debug_artifacts
from ignnition_tpu_torch.config import RunConfig
from ignnition_tpu_torch.data.synthetic import write_dataset

from helpers import qsize_description, routenet_description
from test_debug_graph import _read_tfrecord_events

# importing `ignnition_tpu.debug` bound the submodule on the JAX package
# under the name of its verb `ig.debug(model)`, which its `__getattr__`
# serves; unbind it, so that tests run later in this process call the verb
vars(ig).pop("debug", None)

DIMS_RN = {"link_capacity": 1, "traffic": 1, "adj_links_paths": 0, "adj_paths_links": 0}
DIMS_QS = {"link_capacity": 1, "traffic": 1, "queue_sizes": 1, "adj_links_paths": 0,
           "adj_nodes_paths": 0, "adj_paths_links": 0, "adj_paths_nodes": 0}


def _two_adjacencies():
    """tests/test_debug_graph.py's two sources of one entity in one pass."""
    desc = routenet_description(num_iterations=1, hs=8)
    mp = desc["message_passing"]["stages"][0]["stage_mp"][0]
    mp["source_entities"].append(dict(
        copy.deepcopy(mp["source_entities"][0]), adj_vector="adj_links_paths2"
    ))
    return desc, dict(DIMS_RN, adj_links_paths2=0)


DESCRIPTIONS = {
    "routenet": lambda: (routenet_description(num_iterations=2, hs=8), DIMS_RN),
    "qsize": lambda: (qsize_description(num_iterations=2, hs=8), DIMS_QS),
    "two_adjacencies": _two_adjacencies,
}


@pytest.mark.parametrize("name", sorted(DESCRIPTIONS))
def test_reports_and_graph_match_jax(name):
    desc, dims = DESCRIPTIONS[name]()
    j_ir = ig.parse_model_description(copy.deepcopy(desc), dict(dims))
    t_ir = igt.parse_model_description(copy.deepcopy(desc), dict(dims))
    assert structure_report(t_ir) == j_structure_report(j_ir)
    j_params = ig.build(j_ir).init(jax.random.PRNGKey(0))
    t_params = igt.build(t_ir).init(torch.Generator().manual_seed(0))
    assert params_report(t_params) == j_params_report(j_params)
    nodes, edges = t_graph.build_graph(t_ir)
    assert (nodes, edges) == j_graph.build_graph(j_ir)
    assert t_graph.to_dot(nodes, edges) == j_graph.to_dot(nodes, edges)
    assert t_graph.to_svg(nodes, edges) == j_graph.to_svg(nodes, edges)
    if name == "two_adjacencies":
        chains = [n for n in nodes if "/message/direct_assignation_0" in n and "stage1" in n]
        assert len(chains) == 2, chains


def _configs(tmp_path, name):
    """The two packages' RunConfig of one description over one dataset,
    with their own debug directories."""
    desc, _ = DESCRIPTIONS[name]()
    data = tmp_path / "data"
    write_dataset(str(data), 1, 2, seed=3, with_nodes=name == "qsize")
    (tmp_path / "model.json").write_text(json.dumps(desc))
    kw = dict(train_dataset=str(data), eval_dataset=str(data), predict_dataset=str(data),
              json_path=str(tmp_path / "model.json"), model_dir=str(tmp_path / "ck"),
              batch_size=2, train_steps=1, eval_samples=1)
    return (JRunConfig(debug_dir=str(tmp_path / "jax"), **kw),
            RunConfig(debug_dir=str(tmp_path / "torch"), **kw))


@pytest.mark.parametrize("name,b_calls", [("routenet", 2), ("qsize", 2)])
def test_debug_writes_what_the_jax_package_writes(name, b_calls, tmp_path):
    j_cfg, t_cfg = _configs(tmp_path, name)
    j_dir = j_write_debug_artifacts(ig.create_model(j_cfg))
    import ignnition_tpu_torch.debug  # noqa: F401  (the verb keeps its name)

    assert callable(igt.debug)
    t_dir = igt.debug(igt.create_model(t_cfg), device="cpu")
    assert t_dir == t_cfg.debug_dir
    for f in ("structure.txt", "params.txt", "model.dot", "model.svg"):
        assert filecmp.cmp(os.path.join(t_dir, f), os.path.join(j_dir, f), shallow=False), f
    program = open(os.path.join(t_dir, "model.export.txt")).read()
    assert program.count("torch.ops.ignnition_tpu_torch.masked_gru_scan.default(") == b_calls
    assert "ExportedProgram" in program
    assert not os.path.exists(os.path.join(t_dir, "model.hlo.txt"))


def test_tensorboard_events_load(tmp_path):
    """The debug directory's events hold the model's GraphDef, every IR node
    in it, and the two reports as text summaries."""
    pytest.importorskip("tensorboardX")
    from tensorboardX.proto import event_pb2
    from tensorboardX.proto.graph_pb2 import GraphDef

    _, t_cfg = _configs(tmp_path, "routenet")
    model = igt.create_model(t_cfg)
    out = write_debug_artifacts(model, device="cpu")
    graph_defs, tags = [], set()
    for ef in glob.glob(os.path.join(out, "events.out.*")):
        for payload in _read_tfrecord_events(ef):
            ev = event_pb2.Event.FromString(payload)
            if ev.HasField("graph_def"):
                graph_defs.append(GraphDef.FromString(ev.graph_def))
            tags |= {v.tag for v in ev.summary.value}
    nodes, edges = t_graph.build_graph(model.ir)
    assert len(graph_defs) == 1
    by_name = {n.name: n for n in graph_defs[0].node}
    assert set(by_name) == set(nodes)
    for s, d in edges:
        assert s in by_name[d].input
    assert {"model/structure/text_summary", "model/parameters/text_summary"} <= tags
