"""Structural (JSON-Schema) validation of a model description.

Re-expresses the DSL grammar the reference validates via
`code/utils/schema.json` (draft-07, 491 lines): entities, message_passing
stages, readout pipeline, neural_networks, learning_options. Authored fresh
as a Python dict; semantics match the reference's constraints (same enums,
same conditional requirements) so any model description accepted there is
accepted here.
"""

from __future__ import annotations

from typing import Any, Mapping

import jsonschema

_STRING = {"type": "string"}
_POSITIVE_NUMBER = {"type": "number", "exclusiveMinimum": 0}

_FEATURE = {
    "type": "object",
    "properties": {
        "name": _STRING,
        "normalization": _STRING,
    },
    "required": ["name"],
}

_ENTITY = {
    "type": "object",
    "properties": {
        "name": _STRING,
        "hidden_state_dimension": _POSITIVE_NUMBER,
        "features": {"type": "array", "items": _FEATURE},
    },
    "required": ["name", "hidden_state_dimension", "features"],
}

_MESSAGE_OP = {
    "type": "object",
    "properties": {
        "type": {"type": "string", "enum": ["neural_network", "direct_assignation"]},
        "nn_name": _STRING,
        "input": {"type": "array", "items": _STRING},
        "output_name": _STRING,
    },
    "required": ["type"],
    "if": {"properties": {"type": {"const": "neural_network"}}},
    "then": {"required": ["nn_name", "input"]},
}

_SOURCE_ENTITY = {
    "type": "object",
    "properties": {
        "name": _STRING,
        "adj_vector": _STRING,
        "message": {"type": "array", "items": _MESSAGE_OP},
    },
    "required": ["name", "adj_vector", "message"],
}

_AGGREGATION = {
    "type": "object",
    "properties": {
        "type": {
            "type": "string",
            "enum": ["sum", "ordered", "attention", "concat", "interleave", "convolution"],
        },
        "concat_axis": {"type": "integer", "enum": [1, 2]},
        "interleave_definition": _STRING,
        "activation_function": _STRING,
    },
    "allOf": [
        {
            "if": {"properties": {"type": {"const": "interleave"}}},
            "then": {"required": ["interleave_definition"]},
        },
        {
            "if": {"properties": {"type": {"const": "concat"}}},
            "then": {"required": ["concat_axis"]},
        },
    ],
    "required": ["type"],
}

_UPDATE = {
    "type": "object",
    "properties": {
        "type": {
            "type": "string",
            "enum": ["neural_network", "recurrent_neural_network"],
        },
        "nn_name": _STRING,
    },
    "required": ["type", "nn_name"],
}

_MESSAGE_PASSING = {
    "type": "object",
    "properties": {
        "destination_entity": _STRING,
        "source_entities": {"type": "array", "items": _SOURCE_ENTITY, "minItems": 1},
        "aggregation": _AGGREGATION,
        "update": _UPDATE,
    },
    "required": ["source_entities", "destination_entity", "aggregation", "update"],
}

_STAGE = {
    "type": "object",
    "properties": {
        "stage_name": _STRING,
        "stage_mp": {"type": "array", "items": _MESSAGE_PASSING, "minItems": 1},
    },
    "required": ["stage_name", "stage_mp"],
}

_READOUT_OP = {
    "type": "object",
    "properties": {
        "type": {
            "type": "string",
            "enum": ["predict", "pooling", "product", "neural_network", "extend_adjacencies"],
        },
        "type_pooling": {"type": "string", "enum": ["sum", "max", "mean"]},
        "type_product": {"type": "string", "enum": ["dot_product", "element_wise"]},
        "input": {"type": "array", "items": _STRING},
        "label": _STRING,
        "label_normalization": _STRING,
        "label_denormalization": _STRING,
        "nn_name": _STRING,
        "output_name": _STRING,
        "output_name_src": _STRING,
        "output_name_dst": _STRING,
        "adj_list": _STRING,
    },
    "allOf": [
        {
            "if": {"properties": {"type": {"const": "predict"}}},
            "then": {"required": ["nn_name", "label"]},
        },
        {
            "if": {"properties": {"type": {"const": "pooling"}}},
            "then": {"required": ["type_pooling", "output_name"]},
        },
        {
            "if": {"properties": {"type": {"const": "product"}}},
            "then": {"required": ["type_product", "output_name"]},
        },
        {
            "if": {"properties": {"type": {"const": "neural_network"}}},
            "then": {"required": ["nn_name", "output_name"]},
        },
        {
            "if": {"properties": {"type": {"const": "extend_adjacencies"}}},
            "then": {"required": ["adj_list", "output_name_src", "output_name_dst"]},
        },
    ],
    "required": ["input", "type"],
}

_NN_LAYER = {
    "type": "object",
    "properties": {
        "type_layer": _STRING,
        "name": _STRING,
    },
    "required": ["type_layer"],
}

_NEURAL_NETWORK = {
    "type": "object",
    "properties": {
        "nn_name": _STRING,
        "nn_type": {
            "type": "string",
            "enum": ["feed_forward", "recurrent_neural_network"],
        },
        "recurrent_type": {"type": "string", "enum": ["GRU", "LSTM"]},
        "nn_architecture": {"type": "array", "items": _NN_LAYER},
    },
    "required": ["nn_name", "nn_type"],
    "if": {"properties": {"nn_type": {"const": "feed_forward"}}},
    "then": {"required": ["nn_architecture"]},
    "else": {"required": ["recurrent_type"]},
}

_LEARNING_OPTIONS = {
    "type": "object",
    "properties": {
        "loss": _STRING,
        "optimizer": {
            "type": "object",
            "properties": {
                "type": _STRING,
                "schedule": {
                    "type": "object",
                    "properties": {"type": _STRING},
                },
            },
        },
    },
    "required": ["loss", "optimizer"],
}

MODEL_SCHEMA: Mapping[str, Any] = {
    "$schema": "http://json-schema.org/draft-07/schema#",
    "title": "ignnition_tpu model description",
    "type": "object",
    "properties": {
        "entities": {"type": "array", "items": _ENTITY, "minItems": 1},
        "message_passing": {
            "type": "object",
            "properties": {
                "num_iterations": _POSITIVE_NUMBER,
                "stages": {"type": "array", "items": _STAGE, "minItems": 1},
            },
            "required": ["num_iterations", "stages"],
        },
        "readout": {"type": "array", "items": _READOUT_OP, "minItems": 1},
        "neural_networks": {"type": "array", "items": _NEURAL_NETWORK},
        "learning_options": _LEARNING_OPTIONS,
    },
    "required": ["entities", "message_passing", "readout", "neural_networks", "learning_options"],
}


class ModelDescriptionError(ValueError):
    """A user-facing model-description error (schema or semantic).

    Replaces the reference's `IGNNITION: ...` + sys.exit(1) pattern
    (json_operations.py:243-245) with a raised exception carrying the same
    friendly message.
    """


def validate_structure(data: Mapping[str, Any]) -> None:
    try:
        jsonschema.validate(instance=data, schema=MODEL_SCHEMA)
    except jsonschema.ValidationError as e:
        path = "/".join(str(p) for p in e.absolute_path)
        raise ModelDescriptionError(
            f"model description failed schema validation at '{path}': {e.message}"
        ) from e
