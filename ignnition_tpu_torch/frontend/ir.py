"""Typed, immutable intermediate representation of a model description.

The reference framework (zhangbiqiong/ignnition) parses model_description.json
into a loose object graph (`code/utils/json_operations.py:31` `Model_information`,
`code/utils/auxilary_classes.py`) whose runtime behavior is driven by
reflection over strings and a module-global handle. Here the same declarative
surface is captured as frozen dataclasses forming a pure-data IR: the compiler
back-end (`ignnition_tpu_torch.model.builder`) walks the IR once at trace time to
emit a jittable `apply(params, graph)` function, and every query the runtime
needs (adjacency inventory, interleave tensors, additional inputs, output
info — reference `json_operations.py:384-475`) is a method on `ModelIR`.

No `eval()` anywhere: user normalization functions are resolved from an
explicit registry (see `ignnition_tpu_torch.utils.registry`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

# --------------------------------------------------------------------------
# Neural-network specs
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    """One layer of a feed-forward network.

    Mirrors the reference's reflective `Feed_forward_Layer`
    (auxilary_classes.py:799-865) which instantiates
    `tf.keras.layers.<type_layer>(**params)`. We support an explicit layer
    registry instead (see nn/layers.py).
    """

    kind: str  # e.g. "Dense", "Dropout", "Activation"
    name: str = ""
    units: Optional[int] = None
    activation: Optional[str] = None  # None means linear
    use_bias: bool = True
    kernel_regularizer: float = 0.0  # l2 coefficient (reference coerces to l2)
    rate: float = 0.0  # for Dropout
    extra: Mapping[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class MLPSpec:
    """A named feed-forward architecture (reference `Feed_forward_model`)."""

    name: str
    layers: Tuple[LayerSpec, ...]


@dataclass(frozen=True)
class RNNSpec:
    """A recurrent cell spec (reference `Recurrent_Cell`, a_c.py:702-750).

    The number of units is always the destination entity's state dim, set at
    build time (reference `get_tensorflow_object`, a_c.py:740-750).
    """

    name: str
    cell_type: str  # "GRU" | "LSTM"
    params: Mapping[str, Any] = field(default_factory=dict)


# --------------------------------------------------------------------------
# Entities
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class FeatureSpec:
    """A per-node input feature (reference `Feature`, a_c.py:28-59)."""

    name: str
    size: int = 1
    normalization: Optional[str] = None  # registry key, applied host-side


@dataclass(frozen=True)
class EntitySpec:
    """A typed node set (reference `Entity`, a_c.py:62-160)."""

    name: str
    state_dim: int
    features: Tuple[FeatureSpec, ...] = ()

    @property
    def total_feature_size(self) -> int:
        return sum(f.size for f in self.features)


# --------------------------------------------------------------------------
# Message passing
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MessageOpSpec:
    """One step of the per-edge message-formation chain.

    kind == "direct": message = gathered source states (reference
    `Operation("direct_assignation")`, a_c.py:163-174).
    kind == "mlp": message = MLP(concat(named inputs)) where inputs draw from
    {"hs_source", "hs_dest", "edge_params"} or a previous op's output_name
    (reference `Apply_nn`, a_c.py:177-205; applied at generate_model.py:440-475).
    """

    kind: str  # "direct" | "mlp"
    inputs: Tuple[str, ...] = ()
    output_name: Optional[str] = None
    mlp: Optional[MLPSpec] = None


def is_source_local(ops: Tuple["MessageOpSpec", ...]) -> bool:
    """True when the message chain is a function of the SOURCE NODE state
    alone: every op is a direct assignation or an MLP reading only
    `hs_source`, and none publishes an `output_name` (named outputs are
    edge-level values visible to other sources' ops). The model back-end then runs
    the chain once per source NODE and feeds the node-level message table
    through the fused/dense aggregation paths instead of materializing
    per-edge messages (model/builder.py _node_message_table)."""
    for op in ops:
        if op.kind == "direct":
            continue
        if op.output_name is not None:
            return False
        if any(name != "hs_source" for name in op.inputs):
            return False
    return True


# slot padding cap shared by the data layer (params_slice emission) and the
# model back-end (slot-rate sum/attention eligibility): the [max_len, n_dst] layout
# is skipped when its slot count exceeds this multiple of the edge count
SLOT_PAD_CAP = float(
    __import__("os").environ.get("IGNNITION_TPU_SLOT_SUM_CAP", 3.0)
)


def is_slot_eligible(ops: Tuple["MessageOpSpec", ...]) -> bool:
    """True when a per-edge message chain can evaluate over the in-degree-
    sliced slot layout (model/builder.py _slot_messages): exactly one MLP op,
    no published output_name (other ops may read per-edge values), inputs
    drawn only from {hs_source, hs_dest, edge_params}, and a first Dense
    layer so the input concat splits into per-part matmuls. ONE source of
    truth for the data layer (params_slice emission, graph.py
    slot_param_adjacencies), the model back-end, and the roofline's gather
    convention."""
    if len(ops) != 1 or ops[0].kind != "mlp" or ops[0].output_name:
        return False
    op = ops[0]
    if not op.inputs or any(
        n not in ("hs_source", "hs_dest", "edge_params") for n in op.inputs
    ):
        return False
    return bool(op.mlp.layers) and op.mlp.layers[0].kind == "Dense"


@dataclass(frozen=True)
class SourceSpec:
    """A source entity feeding one message passing (reference `Source_Entity`)."""

    entity: str
    adj_name: str  # dataset key of the adjacency lists
    ops: Tuple[MessageOpSpec, ...] = (MessageOpSpec(kind="direct"),)
    edge_param_dim: int = 0  # width of optional per-edge params in the dataset


@dataclass(frozen=True)
class AggregationSpec:
    """How per-edge messages combine at each destination.

    kinds: sum | ordered | attention | convolution | concat | interleave
    (reference schema.json:165 and `Aggregation` subclasses a_c.py:229-456).
    - concat requires concat_axis in {1, 2}
    - interleave requires interleave_name (dataset key of the pattern)
    - convolution takes an activation (default relu)
    - attention_softmax: "per_destination" (correct GAT) or "reference"
      (replicates the reference's softmax over axis 0 of the padded tensor,
      a_c.py:336 — kept behind a flag for bit-parity experiments).
    """

    kind: str
    concat_axis: int = 1
    interleave_name: Optional[str] = None
    activation: str = "relu"
    attention_softmax: str = "per_destination"


@dataclass(frozen=True)
class UpdateSpec:
    """Destination state update (reference create_update, a_c.py:528-540).

    kind == "recurrent": GRU/LSTM. Sequence-shaped aggregations
    (ordered/concat/interleave) run the cell over the padded, masked message
    sequence; single-vector aggregations (sum/attention/convolution) run one
    cell step (reference a_c.py:752-796, dispatch at generate_model.py:578-590).
    kind == "mlp": state = MLP(concat(aggregated, old_state)), last layer forced
    to the destination state dim (reference generate_model.py:324-346).
    """

    kind: str  # "recurrent" | "mlp"
    rnn: Optional[RNNSpec] = None
    mlp: Optional[MLPSpec] = None


@dataclass(frozen=True)
class MessagePassingSpec:
    """One message passing into a destination entity."""

    destination: str
    sources: Tuple[SourceSpec, ...]
    aggregation: AggregationSpec
    update: UpdateSpec


@dataclass(frozen=True)
class StageSpec:
    name: str
    passes: Tuple[MessagePassingSpec, ...]


# --------------------------------------------------------------------------
# Readout pipeline
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ReadoutOpSpec:
    """One readout-pipeline operation (reference Readout_operation subclasses,
    a_c.py:1033-1265; executed at generate_model.py:607-658).

    kind: predict | neural_network | pooling | product | extend_adjacencies
    """

    kind: str
    inputs: Tuple[str, ...] = ()
    # predict / neural_network
    mlp: Optional[MLPSpec] = None
    label: Optional[str] = None
    label_normalization: Optional[str] = None
    label_denormalization: Optional[str] = None
    output_name: Optional[str] = None
    # pooling
    pooling: Optional[str] = None  # sum | mean | max
    # product
    product: Optional[str] = None  # dot_product | element_wise
    # extend_adjacencies
    adj_name: Optional[str] = None
    output_names: Tuple[str, ...] = ()


# --------------------------------------------------------------------------
# Learning options
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ScheduleSpec:
    kind: str  # e.g. "ExponentialDecay"
    params: Mapping[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class OptimizerSpec:
    kind: str  # e.g. "Adam"
    params: Mapping[str, Any] = field(default_factory=dict)
    schedule: Optional[ScheduleSpec] = None


@dataclass(frozen=True)
class LearningSpec:
    loss: str  # keras-style loss class name, mapped in training/losses.py
    optimizer: OptimizerSpec


# --------------------------------------------------------------------------
# The full model IR
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AdjacencyInfo:
    """One adjacency the dataset must provide.

    Matches the reference's `get_instance_info` quadruple
    [adj_vector, src, dst, has_params] (auxilary_classes.py:690-698).
    """

    name: str
    src: str
    dst: str
    edge_param_dim: int

    @property
    def has_params(self) -> bool:
        return self.edge_param_dim > 0


@dataclass(frozen=True)
class ModelIR:
    entities: Tuple[EntitySpec, ...]
    num_iterations: int
    stages: Tuple[StageSpec, ...]
    readout: Tuple[ReadoutOpSpec, ...]
    learning: LearningSpec

    # ---- queries (reference json_operations.py:384-475) ----

    def entity(self, name: str) -> EntitySpec:
        for e in self.entities:
            if e.name == name:
                return e
        raise KeyError(f"unknown entity {name!r}")

    @property
    def entity_names(self) -> Tuple[str, ...]:
        return tuple(e.name for e in self.entities)

    def state_dims(self) -> dict:
        return {e.name: e.state_dim for e in self.entities}

    def all_passes(self):
        for stage in self.stages:
            for mp in stage.passes:
                yield mp

    def all_features(self) -> Tuple[FeatureSpec, ...]:
        out = []
        for e in self.entities:
            out.extend(e.features)
        return tuple(out)

    def adjacency_info(self) -> Tuple[AdjacencyInfo, ...]:
        """All adjacencies referenced by message passings, in stage order."""
        out = []
        seen = set()
        for mp in self.all_passes():
            for src in mp.sources:
                key = (src.adj_name, src.entity, mp.destination)
                if key not in seen:
                    seen.add(key)
                    out.append(
                        AdjacencyInfo(
                            name=src.adj_name,
                            src=src.entity,
                            dst=mp.destination,
                            edge_param_dim=src.edge_param_dim,
                        )
                    )
        return tuple(out)

    def readout_adjacencies(self) -> Tuple[str, ...]:
        """Adjacency names used by extend_adjacencies readout ops."""
        return tuple(
            op.adj_name for op in self.readout if op.kind == "extend_adjacencies"
        )

    def interleave_specs(self) -> Tuple[Tuple[str, str], ...]:
        """(pattern dataset key, destination entity) per interleave aggregation
        (reference get_interleave_tensors, json_operations.py:420-421)."""
        return tuple(
            (mp.aggregation.interleave_name, mp.destination)
            for mp in self.all_passes()
            if mp.aggregation.kind == "interleave"
        )

    def interleave_sources(self) -> Tuple[Tuple[str, str], ...]:
        """(source entity, destination entity) pairs needing per-sample
        interleave index vectors (reference get_interleave_sources,
        json_operations.py:412-414)."""
        out = []
        for mp in self.all_passes():
            if mp.aggregation.kind == "interleave":
                for src in mp.sources:
                    out.append((src.entity, mp.destination))
        return tuple(out)

    def predict_op(self) -> ReadoutOpSpec:
        preds = [op for op in self.readout if op.kind == "predict"]
        if len(preds) != 1:
            raise ValueError(
                f"model must define exactly one 'predict' readout op, found {len(preds)}"
            )
        return preds[0]

    def output_info(self) -> Tuple[str, Optional[str], Optional[str]]:
        """(label name, label_normalization, label_denormalization)."""
        op = self.predict_op()
        return op.label, op.label_normalization, op.label_denormalization

    def stochastic_layer_kinds(self) -> Tuple[str, ...]:
        """Layer kinds in this model that draw randomness during training
        (Dropout family / GaussianNoise). Parallel step constructors use this to
        warn when a caller omits the per-step rng — a constant default key
        would silently degrade dropout to a static mask."""
        stochastic = {"Dropout", "AlphaDropout", "GaussianNoise"}
        found = []

        def scan_mlp(mlp):
            if mlp is None:
                return
            for layer in mlp.layers:
                if layer.kind in stochastic:
                    found.append(layer.kind)

        for mp in self.all_passes():
            for src in mp.sources:
                for op in src.ops:
                    scan_mlp(op.mlp)
            scan_mlp(mp.update.mlp)
        for op in self.readout:
            scan_mlp(op.mlp)
        return tuple(sorted(set(found)))

    def additional_inputs(self) -> Tuple[str, ...]:
        """Readout inputs that are neither an entity's states nor a produced
        output (reference get_additional_input_names, j_o.py:458-475). These
        come straight from the dataset."""
        produced = set(self.entity_names)
        needed = set()
        for op in self.readout:
            for i in op.inputs:
                needed.add(i)
            if op.kind == "extend_adjacencies":
                produced.update(op.output_names)
            elif op.output_name:
                produced.add(op.output_name)
        feature_names = {f.name for f in self.all_features()}
        return tuple(sorted(needed - produced - feature_names))


def freeze_mapping(m: Optional[Mapping[str, Any]]) -> Mapping[str, Any]:
    """Return a plain dict copy (dataclasses are frozen; contents treated as
    immutable by convention)."""
    return dict(m or {})


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)
