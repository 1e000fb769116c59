"""The four user-facing verbs (counterpart of `ignnition_tpu/api.py`).

Mirrors the reference API surface (framework_operations.py):
`create_model` (f_o.py:42), `train_and_evaluate` (f_o.py:108), `predict`
(f_o.py:169), `debug` (f_o.py:239). A `Model` bundle (IR + config) replaces
the reference's module-global `model_info` handle (generate_model.py:34-43).

Every entry point runs on the current CUDA device unless `device="cpu"` is
passed (`Runner(..., device="cpu")`, or `device=` through the module verbs'
keywords). `Runner.export_serving` freezes the forward into a serving
artifact (`serving.export_serving`). `Runner(mesh=...)` trains over a
`parallel.Mesh` of ranks: data- and edge-parallel (v1), or destination
sharding with `model_strategy="dest_shard"` (v2).
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config import RunConfig
from .data import find_dataset_dimensions
from .data.graph import PaddingConfig, infer_label_domain
from .frontend import parse_model_file
from .frontend.ir import ModelIR
from .model import build
from .training.trainer import Trainer, TrainState, check_mesh, warm_start
from .utils.registry import normalizations

log = logging.getLogger("ignnition_tpu_torch")
if not log.handlers:  # configure only our logger, never the root logger
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(levelname)s ignnition_tpu_torch: %(message)s"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)
    log.propagate = False


@dataclass
class Model:
    """What `create_model` returns: the parsed IR plus the run config."""

    ir: ModelIR
    config: RunConfig


_cache_noted = False


def _note_compilation_cache(cfg: RunConfig) -> None:
    """`compilation_cache_dir` is accepted so that the JAX package's ini
    files load; the port keeps no compiled program on disk (its CUDA graphs,
    one per batch shape, live in the process), so it has no effect. Said
    once per process when it is set."""
    global _cache_noted
    if getattr(cfg, "compilation_cache_dir", None) and not _cache_noted:
        _cache_noted = True
        log.info(
            "compilation_cache_dir (%s) has no effect in ignnition_tpu_torch: "
            "its steps' CUDA graphs live in the process (its CUDA kernels are "
            "built once, at first use, into ignnition_tpu_torch/_build/)",
            cfg.compilation_cache_dir,
        )


def create_model(config: str | RunConfig = "./train_options.ini") -> Model:
    """Parse and validate the model description named by the config
    (reference create_model, f_o.py:42-47): infers dataset dimensions from
    the first training archive, then builds the IR."""
    cfg = config if isinstance(config, RunConfig) else RunConfig.from_ini(config)
    _note_compilation_cache(cfg)
    dims = find_dataset_dimensions(cfg.train_dataset)
    model_ir = parse_model_file(cfg.json_path, dims)
    return Model(ir=model_ir, config=cfg)


class Runner:
    """Programmatic driver around Trainer for one Model."""

    def __init__(
        self,
        model: Model,
        padding: Optional[PaddingConfig] = None,
        seed: int = 0,
        mesh=None,
        model_strategy: str = "replicated",
        tensorboard_dir: Optional[str] = None,
        device=None,
    ):
        """device: where the model trains and predicts; by default the
        current CUDA device, and without one this raises (pass device="cpu"
        for the CPU).
        mesh: an optional `parallel.Mesh` ('data' x 'model' ranks):
        train_and_evaluate then runs the data- and edge-parallel step on
        every rank of it, consuming mesh.shape['data'] merged batches a step
        (`Trainer.train`'s mesh). model_strategy: 'replicated' (v1, edges
        split over the model axis) or 'dest_shard' (v2, node state sharded
        by destination with a halo exchange), passed to `Trainer.train`."""
        check_mesh(mesh, model_strategy)
        self.model = model
        _note_compilation_cache(model.config)  # the programmatic-config path
        self.gnn = build(model.ir)
        if padding is None and getattr(model.config, "per_graph_padding", False):
            padding = PaddingConfig(per_graph=True)
        self.trainer = Trainer(self.gnn, padding=padding, device=device)
        self.seed = seed
        self.mesh = mesh
        self.model_strategy = model_strategy
        self.tensorboard_dir = tensorboard_dir

    def _init_state(self) -> TrainState:
        return self.trainer.init_state(torch.Generator().manual_seed(self.seed))

    def _denorm_fn(self) -> Optional[Callable]:
        _, _, denorm = self.model.ir.output_info()
        if denorm is None:
            log.warning(
                "a denormalization function for the output was not defined; "
                "outputs and eval statistics use normalized values"
            )
            return None
        fn = normalizations().get(denorm)
        if fn is None:
            log.warning(
                "label_denormalization '%s' is declared in the model "
                "description but no function with that name is registered "
                "(igt.register_normalization): outputs and eval statistics "
                "use normalized values",
                denorm,
            )
        return fn

    def train_and_evaluate(self, run_dir: Optional[str] = None) -> TrainState:
        """Train with periodic eval and checkpoints (reference
        train_and_evaluate, framework_operations.py:108-166).

        run_dir: checkpoint directory override. Default mints a fresh
        timestamped `experiment_<now>` under model_dir (reference
        f_o.py:123-124); pass a previous run's directory to resume it from
        its latest checkpoint."""
        cfg = self.model.config
        state = self._init_state()
        if cfg.warm_start_path:
            state = warm_start(state, cfg.warm_start_path)
            log.info("warm-started parameters from %s", cfg.warm_start_path)
        run_dir = run_dir or os.path.join(
            cfg.model_dir,
            "experiment_" + datetime.datetime.now().strftime("%Y%m%d_%H%M%S"),
        )
        if self.mesh is not None:
            # one run directory for the mesh: its first rank's
            import torch.distributed as dist

            shared = [run_dir]
            dist.broadcast_object_list(shared, src=0, group=self.mesh.group)
            run_dir = shared[0]
        label_name = self.model.ir.output_info()[0]
        denorm = self._denorm_fn()

        def eval_fn(st):
            return self.trainer.evaluate(
                st,
                cfg.eval_dataset,
                num_batches=cfg.eval_samples,
                batch_size=cfg.eval_batch_size,
                denormalization=denorm,
                label_name=label_name,
                cache=True,  # periodic evals reuse the built batches
                shuffle=cfg.shuffle_eval_samples,
            )

        return self.trainer.train(
            state,
            cfg.train_dataset,
            max_steps=cfg.train_steps,
            batch_size=cfg.batch_size,
            shuffle=cfg.shuffle_train_samples,
            log_every=cfg.log_every,
            checkpoint_dir=run_dir,
            save_secs=cfg.save_checkpoints_secs,
            keep_max=cfg.keep_checkpoint_max,
            eval_fn=eval_fn,
            eval_secs=cfg.throttle_secs,
            mesh=self.mesh,
            model_strategy=self.model_strategy,
            accumulate_steps=cfg.accumulate_steps,
            input_workers=cfg.input_workers,
            cache_batches=cfg.cache_batches,
            device_prefetch=cfg.device_prefetch,
            tensorboard_dir=self.tensorboard_dir,
        )

    def evaluate(self, state: TrainState) -> Dict[str, float]:
        cfg = self.model.config
        return self.trainer.evaluate(
            state,
            cfg.eval_dataset,
            num_batches=cfg.eval_samples,
            batch_size=cfg.eval_batch_size,
            denormalization=self._denorm_fn(),
            label_name=self.model.ir.output_info()[0],
            shuffle=cfg.shuffle_eval_samples,
        )

    def predict(self, state: Optional[TrainState] = None) -> List[np.ndarray]:
        """One array of predictions a sample of predict_dataset, padding
        removed: an entity's real rows, an edge label's real edges in the
        sample's own edge order, or the graph's value."""
        cfg = self.model.config
        if cfg.predict_dataset is None:
            raise ValueError(
                "the path of the dataset to use for prediction is unspecified; "
                "add predict_dataset to the config"
            )
        if state is None:
            if not cfg.warm_start_path:
                raise ValueError(
                    "the path of the model to use for predictions is unspecified; "
                    "add warm_start_path to the config"
                )
            state = warm_start(self._init_state(), cfg.warm_start_path)
        label_name = self.model.ir.output_info()[0]
        denorm = self._denorm_fn()
        outputs: List[np.ndarray] = []
        domain = infer_label_domain(self.model.ir)
        for preds, arrays in self.trainer.predict(
            state,
            cfg.predict_dataset,
            denormalization=denorm,
            label_name=label_name,
        ):
            if domain[0] == "entity":
                mask = arrays[f"node_mask_{domain[1]}"] > 0
                outputs.append(preds[mask])
            elif domain[0] == "edge":
                # back to the sample's original (insertion-order) edge order:
                # the merged batch destination-sorts edge lists
                perm = arrays.get("label_perm")
                p = preds[np.asarray(perm)] if perm is not None else preds
                n = int(np.sum(np.asarray(arrays[f"edge_mask_{domain[1]}"]) > 0))
                outputs.append(p[:n])
            else:
                outputs.append(preds)
        return outputs

    def export_serving(
        self,
        out_dir: str,
        state: Optional[TrainState] = None,
        dataset: Optional[str] = None,
        batch_size: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> str:
        """Freeze the forward pass into a reloadable serving artifact
        (`serving.export_serving`) on the Runner's device. Shapes come from
        the first batch of `dataset` (default: predict_dataset, else
        train_dataset) at `batch_size` (default: the config's batch_size);
        parameters from `state` or the config's warm_start_path."""
        cfg = self.model.config
        dataset = dataset or cfg.predict_dataset or cfg.train_dataset
        batch_size = batch_size or cfg.batch_size
        if state is None:
            if not cfg.warm_start_path:
                raise ValueError(
                    "the path of the model to export is unspecified; pass a "
                    "TrainState or add warm_start_path to the config"
                )
            state = warm_start(self._init_state(), cfg.warm_start_path)
        arrays, meta = next(
            iter(
                self.trainer.batches(
                    dataset, batch_size, shuffle=False, repeat=False, training=False
                )
            )
        )
        from .frontend import load_description
        from .serving import export_serving as _export

        path = _export(
            self.gnn, state.params, meta, arrays, out_dir,
            compute_dtype=compute_dtype, description=load_description(cfg.json_path),
            device=self.trainer.device,
        )
        log.info("serving artifact written to %s", path)
        return path


# --------------------------------------------------------------------------
# module-level verbs (reference-style)
# --------------------------------------------------------------------------


def train_and_evaluate(
    model: Model, run_dir: Optional[str] = None, **runner_kw
) -> TrainState:
    """run_dir: pass a previous run's experiment directory to resume it."""
    log.info("starting the training and evaluation process\n" + "-" * 75)
    return Runner(model, **runner_kw).train_and_evaluate(run_dir)


def predict(model: Model, state: Optional[TrainState] = None, **runner_kw):
    log.info("starting to make the predictions\n" + "-" * 55)
    return Runner(model, **runner_kw).predict(state)


def debug(model: Model, **runner_kw) -> str:
    """Write the debug artifacts to config.debug_dir (`debug.write_debug_artifacts`:
    the structure and parameter reports, the model graph as DOT, SVG and a
    TensorBoard graph, and the exported program of one forward; the
    reference writes a TensorBoard graph, f_o.py:239-268); returns the
    directory."""
    log.info("generating the debug model\n" + "-" * 55)
    from .debug import write_debug_artifacts

    return write_debug_artifacts(model, **runner_kw)
