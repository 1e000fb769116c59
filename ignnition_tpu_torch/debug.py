"""The `debug` verb: inspectable artifacts of the model (counterpart of the
JAX package's `ignnition_tpu/debug.py`).

The reference's debug() writes a TensorBoard graph whose tf.name_scope
hierarchy (hidden_states / message_passing/iteration_j/<src>s_to_<dst>s/
message|aggregation|update / readout_predictions) is the documented way to
inspect a model (readme.md:109-116, generate_model.py:396-658). Written
here, as the JAX package writes them:

  * `structure.txt` — the same hierarchy as a readable tree derived from the
    IR (entities, stages, message passings, aggregations, updates, readout);
  * `params.txt`   — every parameter path with shape and size;
  * `model.export.txt` — the `torch.export` program of one forward over one
    training sample (`serving.export_program`, what `export_serving`
    freezes), the port's kernels named in it as the operators
    `torch.ops.ignnition_tpu_torch.*`; in place of the JAX package's
    `model.hlo.txt`;
  * `model.dot` / `model.svg` and a TensorBoard GRAPH event — the browsable
    visual graph (debuggraph.py), scope-for-scope matching the reference's
    name_scope hierarchy, and the two reports as TensorBoard text.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import torch


def structure_report(model_ir) -> str:
    lines = []
    add = lines.append
    add("model")
    add("├─ hidden_states")
    for e in model_ir.entities:
        feats = ", ".join(f"{f.name}[{f.size}]" for f in e.features) or "(none)"
        add(f"│  ├─ {e.name}: dim={e.state_dim} features: {feats}")
    add(f"├─ message_passing ({model_ir.num_iterations} iterations)")
    for stage in model_ir.stages:
        add(f"│  ├─ stage '{stage.name}'")
        for mp in stage.passes:
            add(f"│  │  ├─ -> {mp.destination}")
            for src in mp.sources:
                ops = " -> ".join(
                    (o.mlp.name if o.kind == "mlp" else "direct") for o in src.ops
                )
                extra = f", edge_params[{src.edge_param_dim}]" if src.edge_param_dim else ""
                add(f"│  │  │  ├─ from {src.entity} via '{src.adj_name}'{extra}: {ops}")
            agg = mp.aggregation
            detail = ""
            if agg.kind == "concat":
                detail = f"(axis={agg.concat_axis})"
            elif agg.kind == "interleave":
                detail = f"(pattern='{agg.interleave_name}')"
            elif agg.kind == "convolution":
                detail = f"(activation={agg.activation})"
            add(f"│  │  │  ├─ aggregation: {agg.kind} {detail}".rstrip())
            upd = mp.update
            upd_desc = (
                f"recurrent {upd.rnn.cell_type} '{upd.rnn.name}'"
                if upd.kind == "recurrent"
                else f"feed-forward '{upd.mlp.name}'"
            )
            add(f"│  │  │  └─ update: {upd_desc}")
    add("└─ readout")
    for op in model_ir.readout:
        if op.kind == "predict":
            add(
                f"   └─ predict({', '.join(op.inputs)}) -> label '{op.label}' "
                f"norm={op.label_normalization} nn='{op.mlp.name}'"
            )
        elif op.kind == "neural_network":
            add(f"   ├─ {op.output_name} = nn '{op.mlp.name}'({', '.join(op.inputs)})")
        elif op.kind == "pooling":
            add(f"   ├─ {op.output_name} = pooling[{op.pooling}]({op.inputs[0]})")
        elif op.kind == "product":
            add(
                f"   ├─ {op.output_name} = product[{op.product}]"
                f"({op.inputs[0]}, {op.inputs[1]})"
            )
        elif op.kind == "extend_adjacencies":
            add(
                f"   ├─ {op.output_names[0]}, {op.output_names[1]} = "
                f"extend_adjacencies[{op.adj_name}]({', '.join(op.inputs)})"
            )
    return "\n".join(lines) + "\n"


def _sorted_tree(tree: Any) -> Any:
    """The tree with every dict's keys in sorted order, the order in which a
    JAX tree flattens."""
    if isinstance(tree, Mapping):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(_sorted_tree(v) for v in tree)
    return tree


def params_report(params) -> str:
    """Every leaf's path (keys and sequence indices joined by '/'), shape
    and size, in the JAX package's order, and the total."""
    from .model.builder import flatten_params

    lines = []
    total = 0
    for name, leaf in flatten_params(_sorted_tree(params)).items():
        n = int(leaf.numel())
        total += n
        lines.append(f"{name:70s} {str(tuple(leaf.shape)):>18s} {n:>10d}")
    lines.append(f"{'TOTAL':70s} {'':>18s} {total:>10d}")
    return "\n".join(lines) + "\n"


def write_debug_artifacts(model, out_dir: Optional[str] = None, **runner_kw) -> str:
    """Write the artifacts of the module docstring for a `create_model`
    bundle into `out_dir` (default: the config's debug_dir) and return it.
    runner_kw go to `Runner` (e.g. device="cpu"): the program is exported on
    the Runner's device, with parameters drawn from seed 0."""
    from .api import Runner
    from .batch import to_device
    from .data import SampleSpec, build_batch, iter_samples
    from .debuggraph import write_graph_artifacts
    from .model.builder import map_params
    from .serving import _serving_arrays, export_program

    cfg = model.config
    runner = Runner(model, **runner_kw)  # raises before writing without a device
    out_dir = out_dir or cfg.debug_dir
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(out_dir, "structure.txt"), "w") as f:
        f.write(structure_report(model.ir))

    params = runner.gnn.init(torch.Generator().manual_seed(0))
    with open(os.path.join(out_dir, "params.txt"), "w") as f:
        f.write(params_report(params))

    spec = SampleSpec.from_ir(model.ir, training=False)
    sample = next(iter_samples(cfg.train_dataset, spec))
    arrays, meta = build_batch([sample], model.ir, training=False)
    device = runner.trainer.device
    program = export_program(
        runner.gnn, map_params(lambda v: v.to(device), params), meta,
        to_device(_serving_arrays(arrays), device),
    )
    with open(os.path.join(out_dir, "model.export.txt"), "w") as f:
        f.write(str(program))

    # visual graph artifacts: model.dot / model.svg / TensorBoard GraphDef
    # event (the reference's browsable-graph debug workflow, f_o.py:262-268)
    write_graph_artifacts(model.ir, out_dir)

    # the structure tree and parameter inventory as TensorBoard text
    # summaries (`tensorboard --logdir <debug_dir>`), where tensorboardX is
    # installed; the text files above carry the same content
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return out_dir
    writer = SummaryWriter(out_dir)
    writer.add_text("model/structure", "```\n" + structure_report(model.ir) + "```")
    writer.add_text("model/parameters", "```\n" + params_report(params) + "```")
    writer.close()
    return out_dir
