"""Dataset reading: tar.gz archives of JSON graph samples.

Format-compatible with the reference framework's datasets: each `*.tar.gz`
under a directory contains a `data.json` holding a list of samples; each
sample is a dict with an `entities` map (node name -> entity type), adjacency
dicts (`{dst_node: [src_node, ...]}` or `{dst_node: [[src_node, params], ...]}`),
feature lists, optional interleave pattern lists, and label lists
(reference generator_std_to_framework.py:53-224).

This module converts raw samples into flat numpy `GraphSample`s exactly as the
reference generator does (contiguous per-entity indices, destination-ordered
edge arrays with per-destination sequence positions, tiled interleave index
vectors) — but as reusable host-side data, decoupled from any TF/graph layer.
"""

from __future__ import annotations

import glob
import json
import math
import os
import random
import tarfile
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np


class DatasetError(ValueError):
    """User-facing dataset format error."""


# Exception classes a malformed/truncated archive can legitimately raise.
# skip-and-log catches exactly these (a bare
# `except Exception` also swallowed programming errors — KeyError/TypeError
# in convert paths — silently shrinking the training set).
_ARCHIVE_ERRORS = (
    DatasetError,
    OSError,  # includes gzip truncation (EOFError is not an OSError — listed)
    EOFError,
    json.JSONDecodeError,
    tarfile.TarError,
    UnicodeDecodeError,
)


# --------------------------------------------------------------------------
# Dimension inference (reference framework_operations.py:50-91)
# --------------------------------------------------------------------------


def find_dataset_dimensions(path: str) -> Dict[str, int]:
    """Open the first archive of `path`, read one sample, and infer the width
    of every dataset key: features -> element width, adjacencies -> width of
    the per-edge parameter vector (0 if none)."""
    archives = sorted(glob.glob(os.path.join(str(path), "*.tar.gz")))
    if not archives:
        raise DatasetError(f"no *.tar.gz archives found under '{path}'")
    sample = _read_archive(archives[0])[0]
    return infer_dimensions(sample)


def infer_dimensions(sample: Mapping[str, Any]) -> Dict[str, int]:
    dims: Dict[str, int] = {}
    for k, v in sample.items():
        if not isinstance(v, dict):
            if isinstance(v, list) and v and isinstance(v[0], list):
                dims[k] = len(v[0])
            else:
                dims[k] = 1
        elif v:  # entities map or an adjacency dict
            # first NON-empty source list decides (a leading
            # destination with no sources used to infer width 0 and
            # silently drop every other destination's edge params)
            first = next((x for x in v.values() if x), None)
            if (
                first is not None
                and isinstance(first[0], list)
                and not isinstance(first[0], str)
            ):
                # element [src_node, param_vector]
                dims[k] = len(first[0][1])
            else:
                dims[k] = 0
    return dims


def _read_archive(path: str) -> List[dict]:
    return json.loads(_read_archive_bytes(path))


# --------------------------------------------------------------------------
# Raw sample -> flat arrays
# --------------------------------------------------------------------------


def make_indices(entities: Mapping[str, str]) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Assign per-entity contiguous indices to nodes, in the sample's
    insertion order (reference generator_std_to_framework.py:32-50)."""
    counter: Dict[str, int] = {}
    indices: Dict[str, int] = {}
    for node, entity in entities.items():
        if entity not in counter:
            counter[entity] = 0
        indices[node] = counter[entity]
        counter[entity] += 1
    return counter, indices


@dataclass
class AdjacencyArrays:
    src_idx: np.ndarray  # [E] int32, source node index (per-entity numbering)
    dst_idx: np.ndarray  # [E] int32
    seq: np.ndarray  # [E] int32, position of the edge within its destination
    params: Optional[np.ndarray] = None  # [E, P] float32 edge parameters


@dataclass
class GraphSample:
    """One graph, converted to flat arrays."""

    num_nodes: Dict[str, int]
    features: Dict[str, np.ndarray]  # feature name -> [N_entity, size] float32
    adjacencies: Dict[str, AdjacencyArrays]  # adj name -> arrays
    # (src_entity, dst_entity) -> local-slot -> global interleave slot
    interleave: Dict[Tuple[str, str], np.ndarray] = field(default_factory=dict)
    label: Optional[np.ndarray] = None  # [num_labels] float32
    extras: Dict[str, np.ndarray] = field(default_factory=dict)


@dataclass(frozen=True)
class SampleSpec:
    """What to extract from each raw sample; derived from the ModelIR."""

    feature_names: Tuple[str, ...]
    feature_sizes: Mapping[str, int]
    feature_entities: Mapping[str, str]  # feature name -> owning entity
    # (adj name, src entity, dst entity, has_params)
    adjacencies: Tuple[Tuple[str, str, str, bool], ...]
    entity_names: Tuple[str, ...]
    # (pattern key, dst entity)
    interleave: Tuple[Tuple[str, str], ...] = ()
    label_name: Optional[str] = None
    extra_names: Tuple[str, ...] = ()

    @staticmethod
    def from_ir(model_ir, training: bool = True) -> "SampleSpec":
        feats = model_ir.all_features()
        feature_entities = {}
        for e in model_ir.entities:
            for f in e.features:
                feature_entities[f.name] = e.name
        adjacencies = [
            (a.name, a.src, a.dst, a.has_params) for a in model_ir.adjacency_info()
        ]
        label = model_ir.output_info()[0] if training else None
        return SampleSpec(
            feature_names=tuple(f.name for f in feats),
            feature_sizes={f.name: f.size for f in feats},
            feature_entities=feature_entities,
            adjacencies=tuple(adjacencies),
            entity_names=model_ir.entity_names,
            interleave=model_ir.interleave_specs(),
            label_name=label,
            extra_names=model_ir.additional_inputs(),
        )


def convert_sample(raw: Mapping[str, Any], spec: SampleSpec) -> GraphSample:
    """Convert one raw JSON sample to a GraphSample.

    Reproduces the reference generator semantics
    (generator_std_to_framework.py:97-224): destination-ordered edges, per-dst
    sequence positions, tiled interleave patterns.

    Malformed sample CONTENT (ragged feature lists, unknown node names,
    wrong-typed values) is reported as DatasetError so the archive-level
    skip-and-log catches it; exceptions raised anywhere else propagate
    (a blanket `except Exception` at the archive level
    also swallowed programming errors in the pipeline machinery)."""
    try:
        return _convert_sample_impl(raw, spec)
    except DatasetError:
        raise
    except (ValueError, KeyError, TypeError, IndexError) as e:
        raise DatasetError(f"malformed sample: {e!r}") from e


def _convert_sample_impl(raw: Mapping[str, Any], spec: SampleSpec) -> GraphSample:
    if "entities" not in raw:
        raise DatasetError("sample is missing the 'entities' map")
    entities = raw["entities"]
    num_nodes, node_index = make_indices(entities)

    for e in spec.entity_names:
        num_nodes.setdefault(e, 0)

    # features
    features: Dict[str, np.ndarray] = {}
    for name in spec.feature_names:
        if name not in raw:
            raise DatasetError(
                f"a list for feature '{name}' was expected in the sample but not found"
            )
        size = spec.feature_sizes.get(name, 1)
        n = num_nodes[spec.feature_entities[name]]
        arr = np.asarray(raw[name], dtype=np.float32).reshape(n, size)
        features[name] = arr

    # adjacencies
    adjacencies: Dict[str, AdjacencyArrays] = {}
    seq_by_pair: Dict[Tuple[str, str], np.ndarray] = {}
    for adj_name, src_entity, dst_entity, has_params in spec.adjacencies:
        if adj_name not in raw:
            raise DatasetError(
                f"an adjacency list named '{adj_name}' was expected but not found"
            )
        adj_lists = raw[adj_name]
        src_idx: List[int] = []
        dst_idx: List[int] = []
        seq: List[int] = []
        params: List[Any] = []
        for destination, sources in adj_lists.items():
            if entities.get(destination) != dst_entity:
                raise DatasetError(
                    f"adjacency '{adj_name}' should map to destination entity "
                    f"'{dst_entity}' but node '{destination}' has type "
                    f"'{entities.get(destination)}'"
                )
            seq.extend(range(len(sources)))
            if sources and isinstance(sources[0], list):
                for s in sources:
                    if entities.get(s[0]) != src_entity:
                        raise DatasetError(
                            f"adjacency '{adj_name}' should have sources of entity "
                            f"'{src_entity}' but node '{s[0]}' has type "
                            f"'{entities.get(s[0])}'"
                        )
                    src_idx.append(node_index[s[0]])
                    dst_idx.append(node_index[destination])
                    if has_params:
                        params.append(s[1])
            else:
                for s in sources:
                    if entities.get(s) != src_entity:
                        raise DatasetError(
                            f"adjacency '{adj_name}' should have sources of entity "
                            f"'{src_entity}' but node '{s}' has type '{entities.get(s)}'"
                        )
                    src_idx.append(node_index[s])
                    dst_idx.append(node_index[destination])
        arrays = AdjacencyArrays(
            src_idx=np.asarray(src_idx, dtype=np.int32),
            dst_idx=np.asarray(dst_idx, dtype=np.int32),
            seq=np.asarray(seq, dtype=np.int32),
            params=(
                np.asarray(params, dtype=np.float32).reshape(len(src_idx), -1)
                if has_params
                else None
            ),
        )
        adjacencies[adj_name] = arrays
        seq_by_pair[(src_entity, dst_entity)] = arrays.seq

    # interleave patterns (reference gen_std.py:192-219): the pattern is a
    # list of entity names; tile it to cover n_total = sum of per-source
    # max_len slots, then each source's index vector is the positions of its
    # own slots in the tiled pattern.
    interleave: Dict[Tuple[str, str], np.ndarray] = {}
    for pattern_key, dst_entity in spec.interleave:
        if pattern_key not in raw:
            raise DatasetError(
                f"an interleave pattern named '{pattern_key}' was expected but not found"
            )
        pattern: Sequence[str] = raw[pattern_key]
        involved: Dict[str, int] = {}
        total_sequence: List[int] = []
        n_total = 0
        for entity in pattern:
            if entity not in involved:
                involved[entity] = len(involved)
                seq = seq_by_pair.get((entity, dst_entity))
                if seq is None or len(seq) == 0:
                    raise DatasetError(
                        f"interleave pattern '{pattern_key}' references entity "
                        f"'{entity}' but no ({entity} -> {dst_entity}) adjacency data exists"
                    )
                n_total += int(seq.max()) + 1
            total_sequence.append(involved[entity])
        reps = math.ceil(float(n_total) / len(pattern))
        tiled = np.asarray((total_sequence * reps)[:n_total], dtype=np.int32)
        for entity, ident in involved.items():
            interleave[(entity, dst_entity)] = np.where(tiled == ident)[0].astype(
                np.int32
            )

    # label
    label = None
    if spec.label_name is not None:
        if spec.label_name not in raw:
            raise DatasetError(
                f"a list for the output '{spec.label_name}' was expected but not found"
            )
        value = raw[spec.label_name]
        if not isinstance(value, list):
            value = [value]
        label = np.asarray(value, dtype=np.float32).reshape(-1)

    # additional inputs
    extras: Dict[str, np.ndarray] = {}
    for name in spec.extra_names:
        if name not in raw:
            raise DatasetError(
                f"the input '{name}' was expected in the sample but not found"
            )
        extras[name] = np.asarray(raw[name])

    return GraphSample(
        num_nodes=dict(num_nodes),
        features=features,
        adjacencies=adjacencies,
        interleave=interleave,
        label=label,
        extras=extras,
    )


# --------------------------------------------------------------------------
# Streaming iteration
# --------------------------------------------------------------------------


def _read_archive_bytes(path: str) -> bytes:
    try:
        with tarfile.open(path, "r:gz") as tar:
            member = tar.extractfile("data.json")
            if member is None:
                raise DatasetError(f"the file data.json was not found in {path}")
            return member.read()
    except tarfile.TarError as e:
        raise DatasetError(f"could not read archive {path}: {e}") from e


def iter_samples(
    directory: str,
    spec: SampleSpec,
    shuffle: bool = False,
    seed: Optional[int] = None,
    repeat: bool = False,
    use_native: str = "auto",
    readers: int = 1,
) -> Iterator[GraphSample]:
    """Walk `directory/*.tar.gz` and yield converted samples.

    use_native: "auto" uses the port's C++ loading core (native/loader.cpp,
    built at first use; a failed build raises), falling back to python per
    sample on format quirks; "never" forces pure python.

    readers > 1 parses/converts that many ARCHIVES concurrently (the gunzip
    and the native JSON parse release the GIL, so reader threads scale);
    sample order across archives then becomes nondeterministic — use with
    shuffle. Within an archive, order is preserved (or shuffled as asked).

    Per-sample conversion errors are reported and the offending archive is
    skipped, matching the reference generator's resilience
    (generator_std_to_framework.py:226-230).
    """
    native = None
    if use_native != "never":
        from . import native_loader

        if native_loader.available():
            native = native_loader

    if readers > 1:
        yield from _iter_samples_parallel(
            directory, spec, shuffle, seed, repeat, readers, native
        )
        return

    rng = random.Random(seed)
    while True:
        archives = sorted(glob.glob(os.path.join(str(directory), "*.tar.gz")))
        if not archives:
            raise DatasetError(f"no *.tar.gz archives found under '{directory}'")
        if shuffle:
            rng.shuffle(archives)
        for archive in archives:
            try:
                if native is not None:
                    samples = native.convert_archive(
                        _read_archive_bytes(archive), spec
                    )
                    if shuffle:
                        rng.shuffle(samples)
                    yield from samples
                else:
                    raw_samples = _read_archive(archive)
                    if shuffle:
                        rng.shuffle(raw_samples)
                    for raw in raw_samples:
                        yield convert_sample(raw, spec)
            except _ARCHIVE_ERRORS as e:
                import logging

                logging.getLogger("ignnition_tpu_torch").error(
                    "skipping %s: %r", archive, e
                )
        if not repeat:
            return


def _iter_samples_parallel(
    directory: str,
    spec: SampleSpec,
    shuffle: bool,
    seed: Optional[int],
    repeat: bool,
    readers: int,
    native,
) -> Iterator[GraphSample]:
    """`readers` threads each gunzip+parse+convert whole archives (those
    stages release the GIL: zlib, and the ctypes calls into
    native/loader.cpp), feeding a bounded queue of per-archive sample lists.
    Archive -> reader assignment is dynamic (work stealing via a task
    queue); bounded queues cap memory at ~2 archives per reader."""
    import logging
    import queue as _queue
    import threading

    rng = random.Random(seed)
    task_q: _queue.Queue = _queue.Queue(maxsize=readers * 2)
    out_q: _queue.Queue = _queue.Queue(maxsize=readers * 2)

    def feeder():
        try:
            while True:
                archives = sorted(glob.glob(os.path.join(str(directory), "*.tar.gz")))
                if not archives:
                    raise DatasetError(
                        f"no *.tar.gz archives found under '{directory}'"
                    )
                if shuffle:
                    rng.shuffle(archives)
                for a in archives:
                    task_q.put(a)
                if not repeat:
                    break
        except BaseException as e:  # surface to the consumer
            out_q.put(e)
        for _ in range(readers):
            task_q.put(None)

    def reader(worker_seed):
        wrng = random.Random(worker_seed)
        while True:
            a = task_q.get()
            if a is None:
                break
            try:
                if native is not None:
                    samples = native.convert_archive(_read_archive_bytes(a), spec)
                else:
                    samples = [
                        convert_sample(r, spec) for r in _read_archive(a)
                    ]
                if shuffle:
                    wrng.shuffle(samples)
                out_q.put(samples)
            except _ARCHIVE_ERRORS as e:
                logging.getLogger("ignnition_tpu_torch").error("skipping %s: %r", a, e)
            except BaseException as e:
                out_q.put(e)
                break
        out_q.put(None)

    threading.Thread(target=feeder, daemon=True).start()
    for k in range(readers):
        threading.Thread(
            target=reader, args=(None if seed is None else seed + 1 + k,),
            daemon=True,
        ).start()

    done = 0
    while done < readers:
        item = out_q.get()
        if item is None:
            done += 1
            continue
        if isinstance(item, BaseException):
            raise item
        yield from item
