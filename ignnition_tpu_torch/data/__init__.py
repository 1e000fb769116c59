"""Dataset reading and batch building. `build_batch` returns numpy arrays;
`ignnition_tpu_torch.batch.to_device` moves them to tensors."""

from .dataset import (
    DatasetError,
    GraphSample,
    SampleSpec,
    convert_sample,
    find_dataset_dimensions,
    infer_dimensions,
    iter_samples,
    make_indices,
)
from .graph import BatchMeta, PaddingConfig, build_batch, infer_label_domain

__all__ = [
    "DatasetError",
    "GraphSample",
    "SampleSpec",
    "convert_sample",
    "find_dataset_dimensions",
    "infer_dimensions",
    "iter_samples",
    "make_indices",
    "BatchMeta",
    "PaddingConfig",
    "build_batch",
    "infer_label_domain",
]
