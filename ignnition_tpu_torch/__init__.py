"""ignnition_tpu_torch — the PyTorch and CUDA port of ignnition_tpu.

It runs beside the JAX package, which stays the reference. The port imports
torch and never JAX, and nothing of the JAX package: its host code (the
model-description front end, dataset reading and batch building, the
normalization registry, the evaluation metrics) is its own.

Ported so far: the flagship RouteNet path. Serving: `build` a `GnnModel`
from a parsed description, move a `build_batch` result to the device with
`batch.to_device`, and serve it with `ServingModel`. Training: `Trainer`
(`init_state`, `train_step_fn`, `eval_step_fn`) with the losses, Adam/SGD
and the learning-rate schedules. The entry points run on the current CUDA
device unless `device="cpu"` is passed. The three hand-written Hopper
kernels (CSR segment sum, masked GRU scan forward and backward) are in
`ops/cuda/`.
"""

from .data import BatchMeta, PaddingConfig, SampleSpec, build_batch, convert_sample
from .frontend import ModelDescriptionError, parse_model_description
from .model import GnnModel, build, params_from_jax
from .serving import ServingModel
from .training import Trainer, TrainState, build_optimizer, build_schedule, get_loss
from .utils import register_normalization

__version__ = "0.1.0"

__all__ = [
    "BatchMeta",
    "GnnModel",
    "ModelDescriptionError",
    "PaddingConfig",
    "SampleSpec",
    "ServingModel",
    "TrainState",
    "Trainer",
    "build",
    "build_batch",
    "build_optimizer",
    "build_schedule",
    "convert_sample",
    "get_loss",
    "params_from_jax",
    "parse_model_description",
    "register_normalization",
    "__version__",
]
