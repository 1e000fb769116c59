"""In-process serving of a model at fixed batch shapes (counterpart of the
JAX package's `ServingModel`, `ignnition_tpu/serving.py`).

`ServingModel` holds the model, its parameters on one device and the
`BatchMeta` its shapes are pinned to. `build_batch` pads raw samples to that
meta, `predict` runs the forward and applies the registered
denormalization, `trim` drops padding rows. The forward runs under
`torch.inference_mode` and records no graph. Exporting and loading an
artifact are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .batch import resolve_device, to_device
from .data.graph import BatchMeta, infer_label_domain
from .data.graph import build_batch as _build_batch

_NON_INPUT_KEYS = ("label", "label_mask", "label_perm")


class ServingModel:
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
        self._denorm = self._resolve_denorm(denorm)

    @staticmethod
    def _resolve_denorm(name) -> Optional[Callable]:
        if not name:
            return None
        from .utils.registry import normalizations

        fn = normalizations().get(name)
        if fn is None:
            import logging

            logging.getLogger("ignnition_tpu_torch").warning(
                "denormalization '%s' is not registered in this process; "
                "serving outputs stay normalized",
                name,
            )
        return fn

    def forward_device(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The forward on a batch already on `self.device`; returns the
        float32 predictions on the device, without synchronizing."""
        with torch.inference_mode():
            return self.model(batch, self.meta, compute_dtype=self.compute_dtype)

    def predict(
        self, arrays: Mapping[str, np.ndarray], denormalize: bool = True
    ) -> np.ndarray:
        inputs = {k: v for k, v in arrays.items() if k not in _NON_INPUT_KEYS}
        preds = self.forward_device(to_device(inputs, self.device)).cpu().numpy()
        if denormalize and self._denorm is not None:
            preds = np.asarray(self._denorm(preds, self.label_name))
        return preds

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
        arrays, _ = _build_batch(samples, self.ir, training=False, target=self.meta)
        return arrays

    def predict_samples(self, samples, denormalize: bool = True) -> np.ndarray:
        """Batch raw samples, run the model, trim padding rows."""
        arrays = self.build_batch(samples)
        return self.trim(self.predict(arrays, denormalize=denormalize), arrays)

