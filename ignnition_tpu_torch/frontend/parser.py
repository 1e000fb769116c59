"""Model-description front-end: JSON/YAML -> validated ModelIR.

Covers the reference's `Model_information.__init__` pipeline
(json_operations.py:128-149): read, structural validation, semantic
validation, dimension injection, NN-architecture inlining, IR construction.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Mapping, Optional

from . import ir
from .schema import ModelDescriptionError, validate_structure

_RESERVED_INPUTS = ("hs_source", "hs_dest", "edge_params")


def load_description(path) -> dict:
    """Load a model description from a .json or .yaml/.yml file."""
    p = pathlib.Path(path)
    text = p.read_text()
    if p.suffix in (".yaml", ".yml"):
        import yaml

        return yaml.safe_load(text)
    return json.loads(text)


def _validate_semantics(data: Mapping[str, Any]) -> None:
    """Cross-reference checks with friendly errors.

    Mirrors reference `__validate_model_description` (json_operations.py:184-245):
    every MP source/destination names a declared entity, every nn_name
    resolves, every message-op input was produced.
    """
    entity_names = {e["name"] for e in data["entities"]}
    nn_names = {n["nn_name"] for n in data["neural_networks"]}

    produced = set(_RESERVED_INPUTS)
    # the update model is shared per destination entity (the reference
    # stores it under setattr(dst + '_update') — generate_model.py:313/326 —
    # so later declarations silently OVERWRITE earlier ones; we make the
    # conflict a friendly error instead)
    dst_updates: dict = {}
    for stage in data["message_passing"]["stages"]:
        for mp in stage["stage_mp"]:
            dst = mp["destination_entity"]
            if dst not in entity_names:
                raise ModelDescriptionError(
                    f"the destination entity '{dst}' is used in a message passing "
                    f"but no such entity is defined; check the spelling or define it"
                )
            for src in mp["source_entities"]:
                if src["name"] not in entity_names:
                    raise ModelDescriptionError(
                        f"the source entity '{src['name']}' is used in a message "
                        f"passing but no such entity is defined"
                    )
                for op in src.get("message", []):
                    if op["type"] == "neural_network":
                        if op["nn_name"] not in nn_names:
                            raise ModelDescriptionError(
                                f"'{op['nn_name']}' is referenced as a neural network "
                                f"(nn_name) but was never defined in neural_networks"
                            )
                        for i in op["input"]:
                            if i not in produced:
                                raise ModelDescriptionError(
                                    f"'{i}' is used as an input of a message-creation "
                                    f"operation but is not one of {_RESERVED_INPUTS} "
                                    f"nor the output_name of a previous operation"
                                )
                    if "output_name" in op:
                        if op["type"] == "direct_assignation":
                            # the reference runtime executes only
                            # feed_forward ops (g_m.py:440-475), so an
                            # output_name here is dead there too; we used
                            # to register it as produced and crash later
                            # with a raw KeyError when consumed
                            raise ModelDescriptionError(
                                "'output_name' is not supported on "
                                "direct_assignation message operations (the "
                                "message IS the source hidden state — use "
                                "'hs_source' as the input of the consuming "
                                "operation instead)"
                            )
                        produced.add(op["output_name"])
            upd = mp["update"]
            if upd.get("nn_name") and upd["nn_name"] not in nn_names:
                raise ModelDescriptionError(
                    f"the update of message passing to '{dst}' references "
                    f"undefined neural network '{upd['nn_name']}'"
                )
            sig = (upd["type"], upd.get("nn_name"))
            prev = dst_updates.setdefault((dst, upd["type"]), sig)
            if prev != sig:
                raise ModelDescriptionError(
                    f"the destination entity '{dst}' is updated by multiple "
                    f"message passings with different update networks "
                    f"('{prev[1]}' vs '{sig[1]}'); the update model is shared "
                    f"per destination entity — declare the same nn_name for "
                    f"every message passing that updates '{dst}'"
                )

    for op in data["readout"]:
        if op["type"] in ("predict", "neural_network"):
            if op["nn_name"] not in nn_names:
                raise ModelDescriptionError(
                    f"readout operation of type '{op['type']}' references "
                    f"undefined neural network '{op['nn_name']}'"
                )

    predict_count = sum(1 for op in data["readout"] if op["type"] == "predict")
    if predict_count != 1:
        raise ModelDescriptionError(
            f"the readout must contain exactly one 'predict' operation, "
            f"found {predict_count}"
        )


# --------------------------------------------------------------------------
# NN parsing
# --------------------------------------------------------------------------

_LAYER_KNOWN_KEYS = {
    "type_layer",
    "name",
    "units",
    "activation",
    "use_bias",
    "kernel_regularizer",
    "rate",
}


def _parse_layer(l: Mapping[str, Any], idx: int, role: str) -> ir.LayerSpec:
    activation = l.get("activation")
    if activation == "None":
        activation = None  # reference coerces 'None' -> None (a_c.py:836-837)
    extra = {k: v for k, v in l.items() if k not in _LAYER_KNOWN_KEYS}
    return ir.LayerSpec(
        kind=l["type_layer"],
        name=l.get("name", f"layer_{idx}_{l['type_layer']}_{role}"),
        units=l.get("units"),
        activation=activation,
        use_bias=bool(l.get("use_bias", True)),
        kernel_regularizer=float(l.get("kernel_regularizer", 0.0)),
        rate=float(l.get("rate", 0.0)),
        extra=extra,
    )


def _parse_mlp(nn: Mapping[str, Any], role: str) -> ir.MLPSpec:
    layers = tuple(
        _parse_layer(l, i, role) for i, l in enumerate(nn["nn_architecture"])
    )
    return ir.MLPSpec(name=nn["nn_name"], layers=layers)


def _parse_rnn(nn: Mapping[str, Any]) -> ir.RNNSpec:
    params = {
        k: v
        for k, v in nn.items()
        if k not in ("nn_name", "nn_type", "recurrent_type")
    }
    return ir.RNNSpec(
        name=nn["nn_name"], cell_type=nn["recurrent_type"], params=params
    )


# --------------------------------------------------------------------------
# Main entry
# --------------------------------------------------------------------------


def parse_model_description(
    data: Mapping[str, Any],
    dimensions: Optional[Mapping[str, int]] = None,
) -> ir.ModelIR:
    """Build the IR from a raw model-description dict.

    `dimensions` maps dataset keys to widths, as inferred by
    `ignnition_tpu_torch.data.dataset.find_dataset_dimensions` (the reference's
    framework_operations.py:50-91): feature name -> feature width, adjacency
    name -> edge-parameter width (0 if none).
    """
    validate_structure(data)
    _validate_semantics(data)
    dimensions = dict(dimensions or {})

    nns = {n["nn_name"]: n for n in data["neural_networks"]}

    def mlp_of(name: str, role: str) -> ir.MLPSpec:
        nn = nns[name]
        if nn["nn_type"] != "feed_forward":
            raise ModelDescriptionError(
                f"neural network '{name}' is used as a feed-forward model but "
                f"has nn_type '{nn['nn_type']}'"
            )
        return _parse_mlp(nn, role)

    def rnn_of(name: str) -> ir.RNNSpec:
        nn = nns[name]
        if nn["nn_type"] != "recurrent_neural_network":
            raise ModelDescriptionError(
                f"neural network '{name}' is used as a recurrent model but "
                f"has nn_type '{nn['nn_type']}'"
            )
        return _parse_rnn(nn)

    # ---- entities ----
    entities = []
    for e in data["entities"]:
        feats = tuple(
            ir.FeatureSpec(
                name=f["name"],
                size=int(dimensions.get(f["name"], 1)),
                normalization=f.get("normalization"),
            )
            for f in e["features"]
        )
        entities.append(
            ir.EntitySpec(
                name=e["name"],
                state_dim=int(e["hidden_state_dimension"]),
                features=feats,
            )
        )

    # ---- message passing ----
    stages = []
    for stage in data["message_passing"]["stages"]:
        passes = []
        for mp in stage["stage_mp"]:
            sources = []
            for src in mp["source_entities"]:
                ops = []
                for op in src.get("message", [{"type": "direct_assignation"}]):
                    if op["type"] == "direct_assignation":
                        ops.append(ir.MessageOpSpec(kind="direct"))
                    elif op["type"] == "neural_network":
                        ops.append(
                            ir.MessageOpSpec(
                                kind="mlp",
                                inputs=tuple(op["input"]),
                                output_name=op.get("output_name"),
                                mlp=mlp_of(op["nn_name"], role="message_creation"),
                            )
                        )
                if not ops:
                    ops = [ir.MessageOpSpec(kind="direct")]
                sources.append(
                    ir.SourceSpec(
                        entity=src["name"],
                        adj_name=src["adj_vector"],
                        ops=tuple(ops),
                        edge_param_dim=int(dimensions.get(src["adj_vector"], 0)),
                    )
                )

            agg = mp["aggregation"]
            aggregation = ir.AggregationSpec(
                kind=agg["type"],
                concat_axis=int(agg.get("concat_axis", 1)),
                interleave_name=agg.get("interleave_definition"),
                activation=agg.get("activation_function", "relu"),
                # repo extension: "reference" reproduces the reference's
                # axis-0 softmax quirk (a_c.py:336; see GnnModel._attention)
                attention_softmax=agg.get("attention_softmax", "per_destination"),
            )

            upd = mp["update"]
            if upd["type"] == "recurrent_neural_network":
                update = ir.UpdateSpec(kind="recurrent", rnn=rnn_of(upd["nn_name"]))
            else:
                update = ir.UpdateSpec(kind="mlp", mlp=mlp_of(upd["nn_name"], "update"))

            passes.append(
                ir.MessagePassingSpec(
                    destination=mp["destination_entity"],
                    sources=tuple(sources),
                    aggregation=aggregation,
                    update=update,
                )
            )
        stages.append(ir.StageSpec(name=stage["stage_name"], passes=tuple(passes)))

    # ---- readout ----
    readout = []
    for op in data["readout"]:
        kind = op["type"]
        if kind == "predict":
            readout.append(
                ir.ReadoutOpSpec(
                    kind="predict",
                    inputs=tuple(op["input"]),
                    mlp=mlp_of(op["nn_name"], "readout"),
                    label=op["label"],
                    label_normalization=op.get("label_normalization"),
                    label_denormalization=op.get("label_denormalization"),
                )
            )
        elif kind == "neural_network":
            readout.append(
                ir.ReadoutOpSpec(
                    kind="neural_network",
                    inputs=tuple(op["input"]),
                    mlp=mlp_of(op["nn_name"], "readout"),
                    output_name=op["output_name"],
                )
            )
        elif kind == "pooling":
            readout.append(
                ir.ReadoutOpSpec(
                    kind="pooling",
                    inputs=tuple(op["input"]),
                    pooling=op["type_pooling"],
                    output_name=op["output_name"],
                )
            )
        elif kind == "product":
            readout.append(
                ir.ReadoutOpSpec(
                    kind="product",
                    inputs=tuple(op["input"]),
                    product=op["type_product"],
                    output_name=op["output_name"],
                )
            )
        elif kind == "extend_adjacencies":
            readout.append(
                ir.ReadoutOpSpec(
                    kind="extend_adjacencies",
                    inputs=tuple(op["input"]),
                    adj_name=op["adj_list"],
                    output_names=(op["output_name_src"], op["output_name_dst"]),
                )
            )
    # ---- learning options ----
    lo = data["learning_options"]
    opt = dict(lo["optimizer"])
    opt_kind = opt.pop("type")
    schedule = None
    if "schedule" in opt:
        sch = dict(opt.pop("schedule"))
        schedule = ir.ScheduleSpec(kind=sch.pop("type"), params=sch)
    learning = ir.LearningSpec(
        loss=lo["loss"],
        optimizer=ir.OptimizerSpec(kind=opt_kind, params=opt, schedule=schedule),
    )

    return ir.ModelIR(
        entities=tuple(entities),
        num_iterations=int(data["message_passing"]["num_iterations"]),
        stages=tuple(stages),
        readout=tuple(readout),
        learning=learning,
    )


def parse_model_file(path, dimensions=None) -> ir.ModelIR:
    return parse_model_description(load_description(path), dimensions)
