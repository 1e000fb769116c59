"""Serving at fixed batch shapes: in process (`ServingModel`) and through a
reloadable artifact (`export_serving`, `load_serving`, `LoadedServingModel`);
the counterpart of the JAX package's `ignnition_tpu/serving.py`.

`ServingModel` holds the model, its parameters on one device and the
`BatchMeta` its shapes are pinned to. `build_batch` pads raw samples to that
meta, `predict` runs the forward and applies the registered
denormalization, `trim` drops padding rows. The forward runs under
`torch.inference_mode` and records no autograd graph. On the card both
serving models' forwards are one CUDA graph for their meta
(`training.capture`: the first request runs eagerly, the second captures,
every later one replays; `capture.eager()` runs each op by op); on the CPU
they run eagerly.

`export_serving` freezes `GnnModel.apply` at one meta's shapes with
`torch.export` (non-strict, under `torch.no_grad`): the parameters and the
batch are the program's inputs, nothing is baked in, and the port's
kernels stay in the graph as the operators `torch.ops.ignnition_tpu_torch.*`
(`ops/cuda/_build.op_library`), whose CUDA bodies launch them. The program is
specialized to the device it was exported on; `load_serving` refuses another
device type. It reloads the artifact without the model builder: the program
is the executable, and the denormalization runs on the host by registry
name, as in the JAX package.

Artifact directory, as the JAX package writes it but for the program:
  MANIFEST.json    format version, label and denormalization names, label
                   domain, compute dtype, input signature (name -> numpy
                   shape and dtype), `torch_version`, `platforms` (the
                   device type it was exported on: ["cuda"] or ["cpu"])
  forward.pt2      the `torch.export.save`d program (the JAX package writes
                   forward.bin, a serialized StableHLO program: the two
                   packages' artifacts do not cross)
  params.npz       parameter leaves (p00000, p00001, ...)
  params_tree.json nested structure with leaf indices (dict/list/tuple)
  meta.json        the BatchMeta the shapes were specialized to
  model_description.json  the description and its dimensions, when given
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .batch import resolve_device, to_device
from .data.graph import BatchMeta, infer_label_domain
from .data.graph import build_batch as _build_batch
from .training.capture import Graphs

FORMAT_VERSION = 1
FORWARD_FILE = "forward.pt2"

_NON_INPUT_KEYS = ("label", "label_mask", "label_perm")


def _resolve_denorm(name) -> Optional[Callable]:
    if not name:
        return None
    from .utils.registry import normalizations

    fn = normalizations().get(name)
    if fn is None:
        logging.getLogger("ignnition_tpu_torch").warning(
            "denormalization '%s' is not registered in this process; "
            "serving outputs stay normalized",
            name,
        )
    return fn


class _Served:
    """What the two serving models share: `trim`, `build_batch` and
    `predict_samples` over `self.meta`, `self.ir`, `self.label_domain` and
    `self.predict`."""

    def trim(self, preds: np.ndarray, arrays: Mapping[str, np.ndarray]) -> np.ndarray:
        kind, name = self.label_domain
        if kind == "entity":
            return preds[np.asarray(arrays[f"node_mask_{name}"]) > 0]
        if kind == "edge":
            perm = arrays.get("label_perm")
            if perm is not None:  # original insertion-order edge order
                preds = preds[np.asarray(perm)]
            n = int(np.sum(np.asarray(arrays[f"edge_mask_{name}"]) > 0))
            return preds[:n]
        return preds

    def build_batch(self, samples) -> dict:
        """Batch raw GraphSamples to the pinned shapes
        (`build_batch(target=meta)`)."""
        if self.ir is None:
            raise ValueError(
                "this artifact was exported without its model description; "
                "batch inputs externally with build_batch(target=meta)"
            )
        arrays, _ = _build_batch(samples, self.ir, training=False, target=self.meta)
        return arrays

    def predict_samples(self, samples, denormalize: bool = True) -> np.ndarray:
        """Batch raw samples, run the model, trim padding rows (edge-domain
        outputs come back in the samples' original edge order)."""
        arrays = self.build_batch(samples)
        return self.trim(self.predict(arrays, denormalize=denormalize), arrays)


class ServingModel(_Served):
    def __init__(
        self,
        model,
        params,
        meta: BatchMeta,
        ir,
        compute_dtype: Optional[torch.dtype] = torch.bfloat16,
        device=None,
    ):
        """`params`: the model's parameter tree (JAX layout, tensors or
        arrays). `device`: where the model runs; by default the current CUDA
        device (pass device="cpu" for the CPU; without a CUDA device the
        default raises). `compute_dtype=None` computes in float32."""
        self.device = resolve_device(device)
        self.model = model
        self.model.load_params(params, device=self.device)
        self.meta = meta
        self.ir = ir
        self.compute_dtype = compute_dtype
        self.label_name, _, denorm = ir.output_info()
        self.label_domain = tuple(infer_label_domain(ir))
        self._denorm = _resolve_denorm(denorm)
        self.graphs = Graphs(self.device)
        self._forward = self.graphs.step(
            lambda params, batch: self.model.apply(
                params, batch, self.meta, compute_dtype=self.compute_dtype),
            meta, "the served forward")

    def forward_device(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The forward on a batch already on `self.device` (the replayed graph
        of this meta on the card); returns the float32 predictions on the
        device, without synchronizing."""
        with torch.inference_mode():
            return self._forward(self.model.param_tree(), batch)

    def predict(
        self, arrays: Mapping[str, np.ndarray], denormalize: bool = True
    ) -> np.ndarray:
        inputs = {k: v for k, v in arrays.items() if k not in _NON_INPUT_KEYS}
        preds = self.forward_device(to_device(inputs, self.device)).cpu().numpy()
        if denormalize and self._denorm is not None:
            preds = np.asarray(self._denorm(preds, self.label_name))
        return preds


# --------------------------------------------------------------------------
# parameter trees <-> (leaves, json structure), as the JAX package writes them
# --------------------------------------------------------------------------


def _encode_tree(tree: Any, leaves: List[np.ndarray]) -> Any:
    """Replace array leaves with {"__leaf__": idx} (the leaf appended to
    `leaves` as a float32 numpy array); keep dict/list/tuple structure
    JSON-encodable (tuple tagged to round-trip exactly). Dict keys go in
    sorted order, as a JAX tree flattens."""
    if isinstance(tree, Mapping):
        return {k: _encode_tree(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return {"__tuple__": [_encode_tree(v, leaves) for v in tree]}
    if isinstance(tree, list):
        return [_encode_tree(v, leaves) for v in tree]
    leaves.append(_host_leaf(tree))
    return {"__leaf__": len(leaves) - 1}


def _decode_tree(node: Any, leaves: Sequence[Any]) -> Any:
    if isinstance(node, dict):
        if "__leaf__" in node:
            return leaves[node["__leaf__"]]
        if "__tuple__" in node:
            return tuple(_decode_tree(v, leaves) for v in node["__tuple__"])
        return {k: _decode_tree(v, leaves) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode_tree(v, leaves) for v in node]
    raise ValueError(f"corrupt params_tree node: {node!r}")


def _host_leaf(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, dtype=np.float32)


def _meta_to_json(meta: BatchMeta) -> Dict[str, Any]:
    return {
        "num_graphs": meta.num_graphs,
        "node_pad": list(map(list, meta.node_pad)),
        "edge_pad": list(map(list, meta.edge_pad)),
        "max_len": list(map(list, meta.max_len)),
        "interleave_len": list(map(list, meta.interleave_len)),
        "label_pad": meta.label_pad,
        "bwd_len": list(map(list, meta.bwd_len)),
        "inc_blocks": [[k, list(v)] for k, v in meta.inc_blocks],
        "extra_layout": list(map(list, meta.extra_layout)),
        "extra_pad": list(map(list, meta.extra_pad)),
    }


def _meta_from_json(d: Mapping[str, Any]) -> BatchMeta:
    pairs = lambda rows: tuple((k, int(v)) for k, v in rows)
    return BatchMeta(
        num_graphs=int(d["num_graphs"]),
        node_pad=pairs(d["node_pad"]),
        edge_pad=pairs(d["edge_pad"]),
        max_len=pairs(d["max_len"]),
        interleave_len=pairs(d.get("interleave_len", ())),
        label_pad=int(d.get("label_pad", 0)),
        bwd_len=pairs(d.get("bwd_len", ())),
        inc_blocks=tuple(
            (k, tuple(int(x) for x in v)) for k, v in d.get("inc_blocks", ())
        ),
        extra_layout=tuple((k, str(v)) for k, v in d.get("extra_layout", ())),
        extra_pad=pairs(d.get("extra_pad", ())),
    )


def _serving_arrays(arrays: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The forward pass never reads labels; drop them from the signature."""
    return {k: v for k, v in arrays.items() if k not in _NON_INPUT_KEYS}


def _params_on(tree: Any, leaves: Sequence[np.ndarray], device) -> Any:
    return _decode_tree(tree, [torch.from_numpy(np.asarray(a)).to(device) for a in leaves])


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------


class _Forward(torch.nn.Module):
    """`GnnModel.apply` at one meta and compute dtype, taking (params,
    batch). It holds the model's bound method and not the model, so that the
    model's own parameters are no part of the exported program."""

    def __init__(self, gnn, meta: BatchMeta, compute_dtype):
        super().__init__()
        self._apply = gnn.apply
        self._meta = meta
        self._compute_dtype = compute_dtype

    def forward(self, params, batch):
        return self._apply(params, batch, self._meta, compute_dtype=self._compute_dtype)


def export_program(gnn, params, meta: BatchMeta, batch: Mapping[str, torch.Tensor],
                   compute_dtype=None) -> torch.export.ExportedProgram:
    """`torch.export` of `gnn.apply(params, batch, meta)` (non-strict, static
    shapes) on the device of `batch`'s tensors."""
    with torch.no_grad():
        return torch.export.export(
            _Forward(gnn, meta, compute_dtype), (params, dict(batch)), strict=False
        )


def kernel_ops(program: torch.export.ExportedProgram) -> List[str]:
    """The port's kernel operators that the program calls, one entry a call,
    in graph order (e.g. `masked_gru_scan` eight times at 8 iterations)."""
    return [
        node.target.name().split("::", 1)[1].split(".", 1)[0]
        for node in program.graph.nodes
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload)
        and node.target.namespace == "ignnition_tpu_torch"
    ]


def export_serving(
    gnn,
    params,
    meta: BatchMeta,
    arrays: Mapping[str, np.ndarray],
    out_dir: str,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    description: Optional[Mapping[str, Any]] = None,
    device=None,
) -> str:
    """Export `gnn.apply` at `meta`'s shapes and write the artifact
    directory; returns it.

    arrays: one batch at `meta` (its shapes and dtypes make the input
    signature; labels are dropped). description: the raw model-description
    dict, stored so that the loaded model can batch raw samples. device:
    where the program is exported and will run, by default the current CUDA
    device (device="cpu" for the CPU; without a CUDA device the default
    raises).

    The program records the ops that the kernel switches (`ops.cuda`) pick
    while it is traced: under 'auto' and 'always' the kernels' operators,
    whose CUDA bodies launch the kernels where the artifact runs; under
    'never' the plain versions' own ops, and no kernel. Kernel A's plain sum
    reads a row pointer back to the host, which `torch.export` refuses (a
    data-dependent size): a model whose forward reaches it (a sum past the
    dense-incidence cap) exports under 'auto' or 'always' only."""
    device = resolve_device(device)
    inputs = _serving_arrays(arrays)
    model_ir = gnn.ir

    leaves: List[np.ndarray] = []
    tree = _encode_tree(params, leaves)
    program = export_program(
        gnn, _params_on(tree, leaves, device), meta, to_device(inputs, device), compute_dtype
    )

    # the program keeps the batch it was traced on; the artifact holds no batch
    program.example_inputs = None
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, FORWARD_FILE))
    np.savez(
        os.path.join(out_dir, "params.npz"),
        **{f"p{i:05d}": a for i, a in enumerate(leaves)},
    )
    with open(os.path.join(out_dir, "params_tree.json"), "w") as f:
        json.dump(tree, f)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(_meta_to_json(meta), f, indent=1)

    if description is not None:
        dims = {f.name: f.size for e in model_ir.entities for f in e.features}
        dims.update({a.name: a.edge_param_dim for a in model_ir.adjacency_info()})
        with open(os.path.join(out_dir, "model_description.json"), "w") as f:
            json.dump({"description": dict(description), "dimensions": dims}, f)

    label_name, _, denorm = model_ir.output_info()
    manifest = {
        "format": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "platforms": [device.type],
        "label_name": label_name,
        "denormalization": denorm,
        "label_domain": list(infer_label_domain(model_ir)),
        "compute_dtype": str(compute_dtype) if compute_dtype is not None else None,
        "inputs": {
            k: {"shape": list(np.shape(v)), "dtype": str(np.asarray(v).dtype)}
            for k, v in inputs.items()
        },
    }
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


# --------------------------------------------------------------------------
# load / run
# --------------------------------------------------------------------------


def _device_for(manifest: Mapping, device) -> torch.device:
    """`resolve_device(device)`, refused unless the artifact was exported on
    that device type."""
    device = resolve_device(device)
    platforms = manifest.get("platforms", [])
    if device.type not in platforms:
        raise ValueError(
            f"this serving artifact was exported for {platforms} and cannot run on "
            f"{device.type}: export it again on {device.type}"
        )
    return device


class LoadedServingModel(_Served):
    """A reloaded artifact (the JAX package's loaded `ServingModel`):
    `predict(arrays)` runs the exported program and applies the registered
    denormalization; `trim(preds, arrays)` drops padding rows of the
    prediction domain; `build_batch` and `predict_samples` batch raw samples
    to the exported shapes through the stored description. device: as for
    `load_serving` (the card by default, of the artifact's device type)."""

    def __init__(
        self,
        program: torch.export.ExportedProgram,
        params,
        meta: BatchMeta,
        manifest: Mapping,
        description: Optional[Mapping[str, Any]] = None,
        device=None,
    ):
        self.device = _device_for(manifest, device)
        self.program = program
        self.params = params
        self.graphs = Graphs(self.device)
        self._forward = self.graphs.step(program.module(), meta, "the artifact's forward")
        self.meta = meta
        self.manifest = dict(manifest)
        self.label_name = manifest["label_name"]
        self.label_domain = tuple(manifest["label_domain"])
        self._denorm = _resolve_denorm(manifest.get("denormalization"))
        self._description = description
        self._ir = None

    @property
    def ir(self):
        """The model IR re-parsed from the stored description (None when the
        artifact was exported without one)."""
        if self._ir is None and self._description is not None:
            from .frontend import parse_model_description

            self._ir = parse_model_description(
                self._description["description"], self._description["dimensions"]
            )
        return self._ir

    def expected_inputs(self) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        return {
            k: (tuple(v["shape"]), v["dtype"]) for k, v in self.manifest["inputs"].items()
        }

    def _check(self, arrays: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        want = self.expected_inputs()
        batch = {}
        for k, (shape, dtype) in want.items():
            if k not in arrays:
                raise ValueError(f"serving batch is missing input '{k}'")
            a = np.asarray(arrays[k])
            if tuple(a.shape) != shape:
                raise ValueError(
                    f"input '{k}' has shape {tuple(a.shape)}, artifact was "
                    f"exported for {shape}; rebuild the batch to the exported "
                    "meta (repad_to_meta) or re-export at the new shape"
                )
            # numpy reads the name "bfloat16" only where ml_dtypes registered it
            batch[k] = a if a.dtype.name == dtype else a.astype(dtype, copy=False)
        return batch

    def forward_device(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The program on a batch already on `self.device` (the exported
        inputs, in the manifest's order; the replayed graph of this meta on
        the card); returns the float32 predictions on the device, without
        synchronizing."""
        with torch.inference_mode():
            return self._forward(self.params, batch)

    def predict(
        self, arrays: Mapping[str, np.ndarray], denormalize: bool = True
    ) -> np.ndarray:
        batch = to_device(self._check(arrays), self.device)
        preds = self.forward_device(batch).cpu().numpy()
        if denormalize and self._denorm is not None:
            preds = np.asarray(self._denorm(preds, self.label_name))
        return preds


def load_serving(out_dir: str, device=None) -> LoadedServingModel:
    """Reload an artifact of `export_serving`. device: where it runs, by
    default the current CUDA device (device="cpu" for the CPU; without a
    CUDA device the default raises); it must be of the device type the
    artifact was exported on."""
    # the kernels' operators must be registered before the program loads
    from .ops.cuda import attention_kernels, rnn_kernels, segment_kernels  # noqa: F401

    with open(os.path.join(out_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(f"unsupported serving artifact format {manifest.get('format')}")
    forward = os.path.join(out_dir, FORWARD_FILE)
    if not os.path.exists(forward):
        raise ValueError(
            f"{out_dir} holds no {FORWARD_FILE}: not an artifact of ignnition_tpu_torch "
            "(the JAX package's artifacts load with ignnition_tpu.load_serving)"
        )
    device = _device_for(manifest, device)
    program = torch.export.load(forward)
    with np.load(os.path.join(out_dir, "params.npz")) as z:
        leaves = [z[f"p{i:05d}"] for i in range(len(z.files))]
    with open(os.path.join(out_dir, "params_tree.json")) as f:
        params = _params_on(json.load(f), leaves, device)
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = _meta_from_json(json.load(f))
    description = None
    desc_path = os.path.join(out_dir, "model_description.json")
    if os.path.exists(desc_path):
        with open(desc_path) as f:
            description = json.load(f)
    return LoadedServingModel(program, params, meta, manifest, description, device)
