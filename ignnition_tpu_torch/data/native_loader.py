"""ctypes wrapper for the native (C++) data-loading core.

The shared library (the port's `native/loader.cpp` and `native/aux.cpp`,
compiled with g++ at first use into `ignnition_tpu_torch/_build/` by
`native_build`) parses `data.json` buffers and performs the index-building
hot loops natively. This wrapper exposes it as
`convert_archive(json_bytes, spec) -> list[GraphSample]` with identical
semantics to the pure-python `dataset.convert_sample`; on any per-sample
format problem it falls back to the python path so users still get the
friendly error messages.

The library is built, not looked for: when the compiler is missing or the
build fails, the first call raises with the compiler's output rather than
leaving the caller on the numpy routines unseen. `available()` is True once
the library is loaded. `IGNNITION_TPU_NATIVE_AUX=0` keeps `build_batch` on
its numpy routines (`data.graph`), and `iter_samples(use_native="never")`
keeps the loader in Python.
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import List, Optional

import numpy as np

from . import native_build
from .dataset import AdjacencyArrays, GraphSample, SampleSpec, convert_sample

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    """The path of the library this module loaded (built on first use)."""
    return _load()._name


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(native_build.build())))
    return _lib


def _bind(lib):
    """Declare the C entries' signatures on a freshly loaded library."""
    lib.ign_parse.restype = ctypes.c_void_p
    lib.ign_parse.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.ign_free.argtypes = [ctypes.c_void_p]
    lib.ign_num_samples.restype = ctypes.c_long
    lib.ign_num_samples.argtypes = [ctypes.c_void_p]
    lib.ign_entity_count.restype = ctypes.c_long
    lib.ign_entity_count.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p]
    lib.ign_feature_len.restype = ctypes.c_long
    lib.ign_feature_len.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p]
    lib.ign_feature.restype = ctypes.c_long
    lib.ign_feature.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
    ]
    lib.ign_adjacency_size.restype = ctypes.c_long
    lib.ign_adjacency_size.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_char_p,
    ]
    lib.ign_adjacency.restype = ctypes.c_long
    lib.ign_adjacency.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.c_long,
    ]
    lib.ign_string_list.restype = ctypes.c_long
    lib.ign_string_list.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_long,
    ]
    lib.ign_has_key.restype = ctypes.c_int
    lib.ign_has_key.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p]
    I32P = ctypes.POINTER(ctypes.c_int32)
    F32P = ctypes.POINTER(ctypes.c_float)
    lib.ign_slice_sort.restype = ctypes.c_long
    lib.ign_slice_sort.argtypes = [I32P] + [ctypes.c_long] * 3 + [I32P, I32P, I32P]
    lib.ign_adjacency_aux.restype = ctypes.c_long
    lib.ign_adjacency_aux.argtypes = (
        [I32P, I32P, F32P]
        + [ctypes.c_long] * 7
        + [I32P, F32P, I32P, I32P, I32P, I32P, F32P, F32P, I32P, I32P,
           I32P, I32P, I32P]
    )
    return lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def convert_archive(json_bytes: bytes, spec: SampleSpec) -> List[GraphSample]:
    """Parse one data.json payload and convert all samples natively.

    Any sample the native path can't handle (unexpected shape, entity
    mismatch, interleave patterns) is re-converted through the python path
    (which produces the friendly diagnostics)."""
    lib = _load()
    handle = lib.ign_parse(json_bytes, len(json_bytes))
    if not handle:
        # unparseable by the native parser: let python raise properly
        raw = json.loads(json_bytes)
        return [convert_sample(r, spec) for r in raw]
    try:
        n = lib.ign_num_samples(handle)
        out: List[GraphSample] = []
        raw_cache = None
        for i in range(n):
            s = _convert_one(lib, handle, i, spec)
            if s is None:  # fall back for this sample
                if raw_cache is None:
                    raw_cache = json.loads(json_bytes)
                s = convert_sample(raw_cache[i], spec)
            out.append(s)
        return out
    finally:
        lib.ign_free(handle)


def _convert_one(lib, handle, i, spec: SampleSpec) -> Optional[GraphSample]:
    num_nodes = {}
    for ent in spec.entity_names:
        c = lib.ign_entity_count(handle, i, ent.encode())
        if c < 0:
            return None
        num_nodes[ent] = int(c)

    features = {}
    for name in spec.feature_names:
        size = spec.feature_sizes.get(name, 1)
        n_ent = num_nodes[spec.feature_entities[name]]
        buf = np.empty(n_ent * size, np.float32)
        got = lib.ign_feature(handle, i, name.encode(), _fptr(buf), buf.size)
        if got != n_ent * size:
            return None
        features[name] = buf.reshape(n_ent, size)

    adjacencies = {}
    for adj_name, src_e, dst_e, has_params in spec.adjacencies:
        n_edges = lib.ign_adjacency_size(handle, i, adj_name.encode())
        if n_edges < 0:
            return None
        src = np.empty(n_edges, np.int32)
        dst = np.empty(n_edges, np.int32)
        seq = np.empty(n_edges, np.int32)
        pdim = spec.feature_sizes.get(adj_name, 0)
        if has_params and pdim <= 0:
            pdim = 1
        params = np.empty((n_edges, pdim), np.float32) if has_params else np.empty(0, np.float32)
        got = lib.ign_adjacency(
            handle,
            i,
            adj_name.encode(),
            src_e.encode(),
            dst_e.encode(),
            _iptr(src),
            _iptr(dst),
            _iptr(seq),
            _fptr(params),
            pdim if has_params else 0,
            n_edges,
        )
        if got != n_edges:
            return None
        adjacencies[adj_name] = AdjacencyArrays(
            src_idx=src, dst_idx=dst, seq=seq, params=params if has_params else None
        )

    # interleave patterns: python path (string handling; rare + tiny)
    interleave = {}
    if spec.interleave:
        import math

        for pattern_key, dst_entity in spec.interleave:
            buf = ctypes.create_string_buffer(1 << 16)
            got = lib.ign_string_list(handle, i, pattern_key.encode(), buf, len(buf))
            if got < 0:
                return None
            pattern = buf.raw[:got].decode().split("\n")[:-1]
            involved, total_sequence, n_total = {}, [], 0
            for entity in pattern:
                if entity not in involved:
                    involved[entity] = len(involved)
                    seq_arr = None
                    for a_name, s_e, d_e, _hp in spec.adjacencies:
                        if s_e == entity and d_e == dst_entity:
                            seq_arr = adjacencies[a_name].seq
                            break
                    if seq_arr is None or len(seq_arr) == 0:
                        return None
                    n_total += int(seq_arr.max()) + 1
                total_sequence.append(involved[entity])
            reps = math.ceil(float(n_total) / len(pattern))
            tiled = np.asarray((total_sequence * reps)[:n_total], np.int32)
            for entity, ident in involved.items():
                interleave[(entity, dst_entity)] = np.where(tiled == ident)[0].astype(
                    np.int32
                )

    label = None
    if spec.label_name is not None:
        ln = lib.ign_feature_len(handle, i, spec.label_name.encode())
        if ln < 0:
            return None
        buf = np.empty(ln, np.float32)
        got = lib.ign_feature(handle, i, spec.label_name.encode(), _fptr(buf), ln)
        if got != ln:
            return None
        label = buf

    extras = {}
    for name in spec.extra_names:
        ln = lib.ign_feature_len(handle, i, name.encode())
        if ln < 0:
            return None
        buf = np.empty(ln, np.float32)
        if lib.ign_feature(handle, i, name.encode(), _fptr(buf), ln) != ln:
            return None
        extras[name] = buf.astype(np.int64)

    return GraphSample(
        num_nodes=num_nodes,
        features=features,
        adjacencies=adjacencies,
        interleave=interleave,
        label=label,
        extras=extras,
    )


def adjacency_aux_native(
    src: np.ndarray,
    dst: np.ndarray,
    emask: np.ndarray,
    n_src_pad: int,
    n_dst_pad: int,
    max_len: int,
    bwd_cap: int,  # -1 auto, else fixed row count (0 = skip)
    slice_chunk: int,
):
    """Native adjacency index-companion precompute (native/aux.cpp).

    Returns the same dict as the numpy path of
    data.graph.adjacency_aux_arrays (minus dense_inc, which stays in
    python), or None if the library rejects the input.
    """
    lib = _load()
    e = int(len(src))
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    emask = np.ascontiguousarray(emask, np.float32)
    bwd_rows = max(64, bwd_cap if bwd_cap > 0 else 0)
    n_slots = int(max_len) * n_dst_pad
    n_chunks = max(1, -(-n_slots // slice_chunk))
    row_ptr = np.empty(n_dst_pad + 1, np.int32)
    lens = np.empty(n_dst_pad, np.float32)
    src_perm = np.empty(e, np.int32)
    src_sorted = np.empty(e, np.int32)
    src_row_ptr = np.empty(n_src_pad + 1, np.int32)
    dst_in_src_order = np.empty(e, np.int32)
    emask_src_order = np.empty(e, np.float32)
    out_lens = np.empty(n_src_pad, np.float32)
    bwd_slice = np.empty((bwd_rows, n_src_pad), np.int32)
    slice_src = np.empty((int(max_len), n_dst_pad), np.int32)
    slice_sort_perm = np.empty(n_slots, np.int32)
    slice_sort_ids = np.empty(n_slots, np.int32)
    slice_sort_row_ptr = np.empty(n_chunks * n_src_pad + 1, np.int32)
    l_out = lib.ign_adjacency_aux(
        _iptr(src), _iptr(dst), _fptr(emask),
        e, n_src_pad, n_dst_pad, int(max_len), int(bwd_cap),
        int(slice_chunk), int(bwd_rows),
        _iptr(row_ptr), _fptr(lens), _iptr(src_perm), _iptr(src_sorted),
        _iptr(src_row_ptr), _iptr(dst_in_src_order), _fptr(emask_src_order),
        _fptr(out_lens), _iptr(bwd_slice), _iptr(slice_src),
        _iptr(slice_sort_perm), _iptr(slice_sort_ids),
        _iptr(slice_sort_row_ptr),
    )
    if l_out < 0:
        return None
    out = {
        "row_ptr": row_ptr,
        "lens": lens,
        "src_perm": src_perm,
        "src_sorted": src_sorted,
        "src_row_ptr": src_row_ptr,
        "dst_in_src_order": dst_in_src_order,
        "emask_src_order": emask_src_order,
    }
    if l_out > 0:
        out["bwd_slice_dst"] = bwd_slice[:l_out]
        out["out_lens"] = out_lens
    out["slice_src"] = slice_src
    out["slice_sort_perm"] = slice_sort_perm
    out["slice_sort_ids"] = slice_sort_ids
    out["slice_sort_row_ptr"] = slice_sort_row_ptr
    return out


def slice_sort_native(slice_src: np.ndarray, n_src_pad: int, slice_chunk: int):
    """Native windowed slice sort (native/aux.cpp ign_slice_sort).

    Returns the slice_sort_{perm,ids,row_ptr} dict of
    data.graph.slice_sort_companions, or None if the library rejects the
    input."""
    lib = _load()
    flat = np.ascontiguousarray(slice_src, np.int32).reshape(-1)
    n_slots = int(flat.size)
    n_chunks = max(1, -(-n_slots // slice_chunk))
    perm = np.empty(n_slots, np.int32)
    ids = np.empty(n_slots, np.int32)
    row_ptr = np.empty(n_chunks * int(n_src_pad) + 1, np.int32)
    if lib.ign_slice_sort(
        _iptr(flat), n_slots, int(n_src_pad), int(slice_chunk),
        _iptr(perm), _iptr(ids), _iptr(row_ptr),
    ) < 0:
        return None
    return {
        "slice_sort_perm": perm,
        "slice_sort_ids": ids,
        "slice_sort_row_ptr": row_ptr,
    }
