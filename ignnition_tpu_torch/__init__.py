"""ignnition_tpu_torch — the PyTorch and CUDA port of ignnition_tpu.

It runs beside the JAX package, which stays the reference. The port imports
torch and never JAX, and nothing of the JAX package: its host code (the
model-description front end, dataset reading and batch building, the
normalization registry, the evaluation metrics) is its own.

Ported so far: every model under `examples/` (the flagship RouteNet path,
its attention family, the Q-size model, and the homogeneous-graph models:
multi-source message passing; direct messages and message networks;
ordered, interleave, concat, sum, attention and convolution aggregations;
recurrent and feed-forward updates; the neural_network, pooling, product,
extend_adjacencies and predict readouts; every built-in layer kind of the
description language and custom kinds through `register_layer`, the
readout's dropout-style layers drawing from the trainer's generator in
training; both attention softmax modes and attention over several
sources). Serving: `build` a
`GnnModel` from a parsed description, move a `build_batch` result to the
device with `batch.to_device`, and serve it with `ServingModel`; or freeze
it into an artifact with `export_serving` (`torch.export`, the kernels in
the program as `torch.ops.ignnition_tpu_torch.*` operators) and serve the
reloaded `LoadedServingModel` of `load_serving`. Training:
`Trainer` (`init_state`, `train_step_fn`, `accum_train_step_fn`,
`eval_step_fn`, `train`, `evaluate`, `predict`, checkpoints) with the
losses, every optimizer of the JAX package (Adam with or without amsgrad,
AdamW, SGD, RMSprop, Adagrad, Adadelta, Adamax, Nadam) and the
learning-rate schedules. The user's verbs, as in
the JAX package: `create_model(config)`, `train_and_evaluate(model)`,
`Runner(model).evaluate(state)`, `predict(model, state)`,
`Runner(model).export_serving(out_dir)` and `debug(model)`, with the run
configuration of `config.RunConfig` (`train_options.ini`). The entry points
run on the current CUDA device unless `device="cpu"` is passed. Over a
mesh of ranks (`parallel`: `distributed.initialize`, `make_mesh`) training
runs data-parallel, edge-partitioned (v1) or destination-sharded with a
halo exchange (v2, `model_strategy="dest_shard"`). The hand-written Hopper
kernels (CSR and id-keyed segment sums, masked GRU scan forward and
backward, flash-GAT forward and backward) are in `csrc/`, their wrappers in
`ops/cuda/`; `build_batch` runs on the port's native C++ helpers
(`native/`, built with g++ at first use).
"""

from .data import (
    BatchMeta,
    PaddingConfig,
    SampleSpec,
    build_batch,
    convert_sample,
    find_dataset_dimensions,
    iter_samples,
)
from .frontend import (
    ModelDescriptionError,
    load_description,
    parse_model_description,
    parse_model_file,
)
from .frontend import ir
from .model import GnnModel, build, params_from_jax
from .nn.layers import register_layer
from .serving import ServingModel
from .training import Trainer, TrainState, build_optimizer, build_schedule, get_loss
from .utils import get_normalization, register_normalization

from . import debug as _debug_module  # noqa: F401,E402

# importing the submodule bound `debug` on the package; that name is the
# user's verb `debug(model)` (`api.debug`, through `__getattr__`), and a
# module already imported is not bound again
del debug

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
    "find_dataset_dimensions",
    "get_loss",
    "get_normalization",
    "ir",
    "iter_samples",
    "load_description",
    "params_from_jax",
    "parse_model_description",
    "parse_model_file",
    "register_layer",
    "register_normalization",
    "__version__",
]


def __getattr__(name):
    # the verbs live in .api, which sets up the package's logger; import it
    # lazily so that light-weight uses stay light
    if name in ("create_model", "train_and_evaluate", "predict", "debug", "Runner", "Model"):
        from . import api

        return getattr(api, name)
    if name in ("export_serving", "load_serving", "LoadedServingModel"):
        from . import serving

        return getattr(serving, name)
    raise AttributeError(name)
