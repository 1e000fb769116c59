"""Visual model-graph artifacts for the `debug` verb.

The reference's differentiator is a browsable TensorBoard GRAPH of the
generated model, organized by tf.name_scope (hidden_states /
message_passing/<stage>/<src>s_to_<dst>s/message|aggregation|update /
readout) — framework_operations.py:262-268, readme.md:109-116. The
equivalents produced here, all derived from the IR (the exported program
itself is written separately as model.export.txt):

  * a GraphDef written into the TensorBoard event file — loads in the
    TensorBoard graph plugin with the same scope hierarchy, collapsible
    scopes and all (tensorboardX protos; no TF dependency);
  * `model.dot` — Graphviz source with one cluster per scope;
  * `model.svg` — a dependency-free layered rendering (longest-path
    layering, curved edges), viewable in any browser.
"""

from __future__ import annotations

import html
import os
from typing import Dict, List, Tuple


def build_graph(model_ir) -> Tuple[Dict[str, str], List[Tuple[str, str]]]:
    """IR -> (nodes {name: op_label}, edges [(src, dst)]).

    Node names are '/'-scoped exactly like the reference's name scopes, so
    the TensorBoard graph plugin groups them the same way."""
    nodes: Dict[str, str] = {}
    edges: List[Tuple[str, str]] = []

    def add(name: str, op: str, inputs=()) -> str:
        nodes[name] = op
        for i in inputs:
            if i is not None:
                edges.append((i, name))
        return name

    producer: Dict[str, str] = {}

    for e in model_ir.entities:
        feats = [
            add(f"inputs/{f.name}", f"Feature[{f.size}]") for f in e.features
        ]
        producer[e.name] = add(
            f"hidden_states/{e.name}_state", f"HiddenState[{e.state_dim}]",
            feats,
        )

    mproot = "message_passing"
    add(f"{mproot}/iterations", f"Loop[x{model_ir.num_iterations}]")
    for stage in model_ir.stages:
        sroot = f"{mproot}/{stage.name}"
        for mp in stage.passes:
            dst = mp.destination
            chain_outs = []
            for src in mp.sources:
                # adjacency name disambiguates two sources of the SAME
                # entity (review-found: their chains silently merged)
                broot = f"{sroot}/{src.entity}s_to_{dst}s[{src.adj_name}]"
                prev = producer[src.entity]
                ep = None
                if src.edge_param_dim:
                    ep = add(
                        f"{broot}/edge_params",
                        f"EdgeParams[{src.edge_param_dim}]",
                    )
                for oi, op in enumerate(src.ops):
                    if op.kind == "mlp":
                        ins = [prev]
                        # named inputs beyond hs_source: destination state /
                        # edge params / earlier op outputs
                        for inp in op.inputs:
                            if inp == "hs_dest":
                                ins.append(producer[dst])
                            elif inp == "edge_params" and ep is not None:
                                ins.append(ep)
                            elif inp in producer and inp != src.entity:
                                ins.append(producer[inp])
                        prev = add(
                            f"{broot}/message/{op.mlp.name}_{oi}",
                            "NeuralNetwork", ins,
                        )
                        if op.output_name:
                            producer[op.output_name] = prev
                    else:
                        prev = add(
                            f"{broot}/message/direct_assignation_{oi}",
                            "DirectAssignation", [prev],
                        )
                chain_outs.append(prev)
            agg = mp.aggregation
            detail = {
                "concat": f"[axis={agg.concat_axis}]",
                "interleave": f"[{agg.interleave_name}]",
                "convolution": f"[{agg.activation or 'relu'}]",
            }.get(agg.kind, "")
            agg_in = list(chain_outs)
            if agg.kind in ("attention", "convolution"):
                agg_in.append(producer[dst])
            agg_node = add(
                f"{sroot}/{dst}_aggregation",
                f"Aggregation:{agg.kind}{detail}", agg_in,
            )
            upd = mp.update
            upd_label = (
                f"Update:{upd.rnn.cell_type}"
                if upd.kind == "recurrent"
                else f"Update:feed_forward[{upd.mlp.name}]"
            )
            upd_node = add(
                f"{sroot}/{dst}_update", upd_label, [agg_node, producer[dst]]
            )
            producer[dst] = add(
                f"{sroot}/{dst}_state", "UpdatedState", [upd_node]
            )

    def resolve(name: str) -> str:
        if name not in producer:
            # additional dataset-provided readout input
            producer[name] = add(f"inputs/{name}", "AdditionalInput")
        return producer[name]

    for i, op in enumerate(model_ir.readout):
        if op.kind == "predict":
            node = add(
                f"readout/predict_{op.mlp.name}", "NeuralNetwork",
                [resolve(x) for x in op.inputs],
            )
            add(f"readout/{op.label}_prediction",
                f"Prediction[label={op.label}]", [node])
        elif op.kind == "neural_network":
            producer[op.output_name] = add(
                f"readout/nn_{i}_{op.mlp.name}", "NeuralNetwork",
                [resolve(x) for x in op.inputs],
            )
        elif op.kind == "pooling":
            producer[op.output_name] = add(
                f"readout/pooling_{i}", f"Pooling:{op.pooling}",
                [resolve(op.inputs[0])],
            )
        elif op.kind == "product":
            producer[op.output_name] = add(
                f"readout/product_{i}", f"Product:{op.product}",
                [resolve(op.inputs[0]), resolve(op.inputs[1])],
            )
        elif op.kind == "extend_adjacencies":
            node = add(
                f"readout/extend_adjacencies_{i}",
                f"ExtendAdjacencies[{op.adj_name}]",
                [resolve(x) for x in op.inputs],
            )
            for out in op.output_names:
                producer[out] = node
    return nodes, edges


# --------------------------------------------------------------------------
# Graphviz DOT
# --------------------------------------------------------------------------


def to_dot(nodes: Dict[str, str], edges: List[Tuple[str, str]]) -> str:
    """DOT source with one cluster per top-level scope."""
    def esc(text):
        # DOT double-quoted strings: escape backslashes and quotes
        # (review-found: a quoted entity/nn name produced unparseable DOT
        # while the SVG emitter escaped correctly)
        return str(text).replace("\\", "\\\\").replace('"', '\\"')

    def nid(name):
        return '"' + esc(name) + '"'

    scopes: Dict[str, List[str]] = {}
    for name in nodes:
        scopes.setdefault(name.split("/")[0], []).append(name)
    out = [
        "digraph model {",
        "  rankdir=TB;",
        '  node [shape=box, style="rounded,filled", fillcolor="#eef2fa",'
        ' fontname="Helvetica", fontsize=11];',
        '  edge [color="#667799", arrowsize=0.7];',
    ]
    for si, (scope, members) in enumerate(sorted(scopes.items())):
        out.append(f"  subgraph cluster_{si} {{")
        out.append(
            f'    label="{esc(scope)}"; color="#99aacc"; fontname="Helvetica";'
        )
        for m in members:
            label = m.split("/", 1)[1] if "/" in m else m
            out.append(
                f'    {nid(m)} [label="{esc(label)}\\n{esc(nodes[m])}"];'
            )
        out.append("  }")
    for s, d in edges:
        out.append(f"  {nid(s)} -> {nid(d)};")
    out.append("}")
    return "\n".join(out) + "\n"


# --------------------------------------------------------------------------
# Dependency-free SVG rendering (longest-path layering)
# --------------------------------------------------------------------------


def to_svg(nodes: Dict[str, str], edges: List[Tuple[str, str]]) -> str:
    order = list(nodes)
    idx = {n: i for i, n in enumerate(order)}
    succ: Dict[str, List[str]] = {n: [] for n in order}
    indeg = {n: 0 for n in order}
    for s, d in edges:
        succ[s].append(d)
        indeg[d] += 1
    # longest-path layering (graph is a DAG by construction)
    layer = {n: 0 for n in order}
    ready = [n for n in order if indeg[n] == 0]
    deg = dict(indeg)
    topo = []
    while ready:
        n = ready.pop()
        topo.append(n)
        for m in succ[n]:
            layer[m] = max(layer[m], layer[n] + 1)
            deg[m] -= 1
            if deg[m] == 0:
                ready.append(m)
    n_layers = max(layer.values()) + 1 if layer else 1
    rows: List[List[str]] = [[] for _ in range(n_layers)]
    for n in topo:
        rows[layer[n]].append(n)

    W, H, PADX, PADY = 190, 46, 36, 46
    width = max((len(r) for r in rows), default=1) * (W + PADX) + PADX
    height = n_layers * (H + PADY) + PADY
    pos = {}
    for li, row in enumerate(rows):
        rw = len(row) * (W + PADX) - PADX
        x0 = (width - rw) / 2
        for ci, n in enumerate(row):
            pos[n] = (x0 + ci * (W + PADX), PADY + li * (H + PADY))

    colors = {
        "inputs": "#e8f4e8", "hidden_states": "#e8eefc",
        "message_passing": "#fdf3e3", "readout": "#f6e8f4",
    }
    svg = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}">',
        "<defs><marker id='arr' markerWidth='8' markerHeight='8' refX='7' "
        "refY='3' orient='auto'><path d='M0,0 L7,3 L0,6 z' fill='#667799'/>"
        "</marker></defs>",
        f'<rect width="{width}" height="{height}" fill="white"/>',
    ]
    for s, d in edges:
        x1, y1 = pos[s][0] + W / 2, pos[s][1] + H
        x2, y2 = pos[d][0] + W / 2, pos[d][1]
        my = (y1 + y2) / 2
        svg.append(
            f'<path d="M{x1:.0f},{y1:.0f} C{x1:.0f},{my:.0f} '
            f'{x2:.0f},{my:.0f} {x2:.0f},{y2:.0f}" fill="none" '
            f'stroke="#667799" stroke-width="1.2" marker-end="url(#arr)"/>'
        )
    for n, (x, y) in pos.items():
        scope = n.split("/")[0]
        fill = colors.get(scope, "#f0f0f0")
        short = n.split("/")[-1]
        svg.append(
            f'<g><rect x="{x:.0f}" y="{y:.0f}" width="{W}" height="{H}" '
            f'rx="8" fill="{fill}" stroke="#8899bb"/>'
            f'<text x="{x + W / 2:.0f}" y="{y + 19:.0f}" text-anchor="middle" '
            f'font-family="Helvetica" font-size="11" font-weight="bold">'
            f'{html.escape(short)}</text>'
            f'<text x="{x + W / 2:.0f}" y="{y + 35:.0f}" text-anchor="middle" '
            f'font-family="Helvetica" font-size="10" fill="#445">'
            f'{html.escape(nodes[n])}</text></g>'
        )
    svg.append("</svg>")
    return "\n".join(svg) + "\n"


# --------------------------------------------------------------------------
# TensorBoard GraphDef
# --------------------------------------------------------------------------


def write_tensorboard_graph(
    out_dir: str, nodes: Dict[str, str], edges: List[Tuple[str, str]]
) -> bool:
    """Write a GraphDef event so `tensorboard --logdir <debug_dir>` shows the
    model in the GRAPH plugin (the reference's debug artifact,
    f_o.py:262-268). Returns False when tensorboardX is unavailable."""
    try:
        from tensorboardX.proto.graph_pb2 import GraphDef
        from tensorboardX.proto.node_def_pb2 import NodeDef
        from tensorboardX.proto.versions_pb2 import VersionDef
        from tensorboardX.proto import event_pb2
        from tensorboardX.writer import FileWriter
    except ImportError:
        return False

    inputs: Dict[str, List[str]] = {n: [] for n in nodes}
    for s, d in edges:
        inputs[d].append(s)
    gd = GraphDef(
        node=[
            NodeDef(name=n, op=nodes[n].replace(" ", "_"), input=inputs[n])
            for n in nodes
        ],
        versions=VersionDef(producer=22),
    )
    # a file of its own: event files are named by the second they were
    # opened in, and the debug verb's text summaries follow within it
    w = FileWriter(out_dir, filename_suffix=".graph")
    w.add_event(event_pb2.Event(graph_def=gd.SerializeToString()))
    w.close()
    return True


def write_graph_artifacts(model_ir, out_dir: str) -> List[str]:
    """Write model.dot / model.svg / TensorBoard graph event. Returns the
    list of files written."""
    nodes, edges = build_graph(model_ir)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    dot_path = os.path.join(out_dir, "model.dot")
    with open(dot_path, "w") as f:
        f.write(to_dot(nodes, edges))
    written.append(dot_path)
    svg_path = os.path.join(out_dir, "model.svg")
    with open(svg_path, "w") as f:
        f.write(to_svg(nodes, edges))
    written.append(svg_path)
    if write_tensorboard_graph(out_dir, nodes, edges):
        written.append(os.path.join(out_dir, "(tensorboard graph event)"))
    return written
