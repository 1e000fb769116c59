#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ignnition_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which raises on failure (the exit code is then non-zero):
  1. print the card's name and power limit, build the port's CUDA kernels
     from the checkout's sources and print the build time; build and load the
     port's native batch helpers (g++, `ignnition_tpu_torch/native/*.cpp`) and
     check that the library loaded is the one in `ignnition_tpu_torch/_build/`;
  2. hold each kernel (A: CSR segment sum, with its windowed entry; the
     id-keyed segment sum; B: masked GRU scan, C: its backward, D and E:
     flash-GAT attention forward and backward) against its plain PyTorch
     version on the card at the main paths' shapes, in bf16 and f32. The two
     segment kernels also at widths 8, 20, 48, 128 and 256, with empty rows,
     with a quarter or all of the edges in one row, with one row and with
     65,536 rows of 2 edges, by int32 and int64 ids, each twice and compared
     bitwise; the windowed entry against the loop of one launch per window
     that it replaces; one call of the id-keyed sum is one device launch
     (profiler). B's instance for each dtype (bf16 on tensor cores, f32 on
     the CUDA cores: the rule of `rnn_kernels.forward_instance`, held to the
     kernel that the profiler saw run), every instance's ptxas registers (no
     spills; a build log without them fails), twice and bitwise, also at
     N=1,000, D=20, u=48 in bf16, and timed at the x4 shape too. C likewise:
     its sweep's instance (bf16 on tensor cores, f32 on the CUDA cores:
     `rnn_kernels.backward_instance`) held to the profiler, its ptxas
     registers, twice and bitwise, its sweep, weight-gradient and finalize
     device time, timed at the x4 shape too (cuDNN's GRU backward beside it
     at both shapes); its bf16 reference rounds where the TPU kernel rounds
     (`masked_gru_scan_bwd_kernel_plain`). D and E also with a bf16
     incidence matrix, over 4 graph blocks and at a ragged shape; E twice,
     compared bitwise, its two kernels (strips, row sums) the only device
     launches of a call (profiler) with their device times, and their ptxas
     registers (no spills). Each kernel and,
     where there is one, one PyTorch library call of the same function (a
     yardstick only, never on the port's path) is timed three ways: 20 calls
     made from Python between CUDA events (host launch cost included), the
     same calls in a replayed CUDA graph (device time), and a replayed graph
     over rotated copies of the inputs that exceed the L2 (device time from
     device memory); each kernel's bound on this card comes from the bytes
     and operations of this run's inputs;
  3. serve the flagship RouteNet (hs=32, 8 message-passing iterations,
     256-256-1 selu readout, random weights from a seed, bf16 compute)
     through `ServingModel.predict_samples`: three requests at the flagship
     size (2,048 links, 16,384 paths of length 8) and one at 4x that
     (8,192 links, 65,536 paths). Check that the predictions are finite and
     of the right shape, that kernels A and B ran on that path (launch
     counts), and that the kernel path agrees with the plain path (the same
     model on the CPU) in f32 and in bf16; then time the requests and
     `build_batch` alone, through the native helpers and through numpy;
  4. train it through `Trainer` (bf16 compute over f32 masters, MSE + L2,
     Adam with ExponentialDecay): 5 steps on one batch at the flagship size
     and 2 at 4x. Check that every loss is finite; at the flagship size that
     each bf16 step's loss agrees with the plain path's (the same model and
     batch on the CPU) at that step's parameters, and that 5 f32 steps of
     the kernel path and of the plain path agree step by step and end below
     their start; at 4x that the last loss is below the first; that the
     step-0 gradients of the kernel path agree leaf by leaf with the plain
     path (f32), that
     kernels A, B and C all ran in every step (launch counts: at 4x kernel A
     15 times, 7 of them through the windowed entry), and the evaluation
     step; then time the step (median of 20, CUDA events), print
     edge-messages per second and profile one step by kernel;
  5. the attention family (stage 2 aggregating by attention): serve three
     requests at the flagship size (dense attention over the int8 incidence
     matrix: kernel D 8 times per forward) and train 3 steps (D 8 and E 7
     times per step: the last iteration's link states reach no prediction;
     a falling L2 term, step-0 gradients against the plain
     path leaf by leaf in f32), one request at 4x (per-edge attention:
     kernel A 16 times per forward) and one of a small model at hs=48 (the
     id-keyed kernel 8 times per forward), each against the plain path, and
     the small model's step-0 gradients (the per-edge backward through kernel
     A and the id-keyed kernel);
  6. the Q-size model of `examples/qsize` (link, node and path states; stage
     1 interleaves link and node states into each path's sequence, stage 2
     sums paths into links and nodes) at the shapes of `tools/bench_qsize.py`:
     2,048 links, 2,048 nodes, 16,384 paths of 4 hops (8 interleaved steps),
     hs=32, 8 iterations. Serve three requests (kernel B 8 times per forward,
     through the combined slice map), hold the predictions to the plain path
     in f32 and bf16, time the forward, the request and `build_batch`; train
     5 bf16 steps (B 8, C 8 and A 7 times per step: A is the interleave
     gather's backward, which iteration 1 does not need), with the step-0
     gradients against the plain path in f32, then time the step;
  7. the mlp_message family (the flagship with a message network of 32 relu
     units, then 32 linear, over [hs_source, hs_dest] on both stages;
     `bench._mutate_mlp_message`) at the flagship size, 8 iterations. Print
     each stage's lowering (stage 1: one slice gather of `link_states @
     Ksrc` plus the destination part, the network's tail over the [8, n, 32]
     slot tensor, then kernel B; stage 2: the slot-rate sum while its slots
     stay under 3 x the edges). Serve three requests (kernel B 8 times per
     forward, nothing else of the port's), time the forward, the request and
     `build_batch`; hold kernel A on the stage-2 slot map's own sort against
     its plain version and time it; train 5 bf16 steps (B 8, C 8 and A 15
     times per step: stage 1's slot map at every iteration, since `Ksrc`
     needs its gradient, stage 2's but for the last, 7 of them windowed),
     then time the step. The kernel path is held to the plain path (f32 and
     bf16 predictions, step-0 loss and gradients in f32) at 2 iterations:
     at 8 this random-weight model amplifies f32 rounding past the limits,
     which the phase measures against the plain path in f64 and prints;
  8. the homogeneous-graph models, `examples/graphprop` (attention with a
     feed-forward update, convolution with a GRU, mean pooling to a
     graph-level label; hs=32, 3 iterations) and `examples/linkpred` (a sum,
     then `extend_adjacencies` and an element-wise product to an edge-level
     label; hs=16, 2 iterations), read from their yaml files, over 1,024
     graphs a batch of `data/synthetic.py` (out-degree 3): graphprop on a
     CSR batch (graph sizes 96-160: the convolution's sum, the per-edge
     attention through kernel A, mean pooling through the id-keyed kernel)
     and on a block batch (every graph of 128 nodes: attention through D and
     E over the [1024, 128, 128] blocks, the convolution a batched product),
     linkpred on a CSR batch (the sum gather + kernel A, both readout
     gathers transposed by kernel A). Each serves 2 requests (one prediction
     per graph, or per real edge in the samples' edge order), is held to the
     plain path (f32 and bf16 predictions, step-0 loss and every gradient
     leaf in f32), trains 5 bf16 steps (finite, the last loss below the
     first), with the launch counts of every forward and step, and is timed
     (forward, request, `build_batch`, step; edge-messages per second,
     device busy, peak memory). Then the flagship at `bench.py`'s blocks_g4
     (4 graphs padded per graph, stage 2 a block product) and flagship_x8
     (131,072 paths: gather + kernel A, the windowed backward): one request
     and 2 bf16 steps each, finite, the loss falling, the launch counts.
     Phase 2 also times the id-keyed kernel at the pooling shapes. At
     blocks_g4 the step-0 f32 gradients at 8 iterations are held to a
     control read in the same run: no further from the plain path's f64
     than 8 times the plain f32's own distance (the block product's library
     f32 rounding carries most of the gap: `spread_by_operation`);
  9. the user's entry points on the examples' RouteNet
     (`examples/routenet/model_description.yaml`, hs=32, 8 iterations,
     256-256-1 selu readout) over synthetic data of the port's
     `write_dataset` in a temporary directory (64 training samples of 256
     links and 2,048 paths, 16 eval samples): (a) `create_model` from a
     train_options.ini, `train_and_evaluate` (32 f32 steps of batch 8),
     `Runner.evaluate`, a run of 16 steps resumed to 32 on one run directory
     (held to the single run at 1e-6 of each leaf's largest entry,
     parameters and optimizer state) and `predict` from the run's checkpoint
     (one array a sample, as many values as its paths), each verb's kernel
     launches counted (B x8 a forward; B x8, C x8, A x7 a step); (e) the
     first 3 f32 steps of `train()` on the card against the CPU plain path
     (losses at 1e-4; each leaf held against a plain f64 run as the
     control); a profile of one step and one forward; (b) 40 bf16 steps of
     `train()` on the default batch stream, with 4 input workers, with the
     batches cached on the device and with pinned packed batches staged on
     a side stream, the median step interval beside phase 4's step and
     `build_batch` (the runs in the default stream's order end with its
     parameters); (c) 32 graphs an optimizer step as
     `_auto_accumulate`'s microbatches against one merged batch past the
     dense cap, in edge-messages per second; (d) bf16 and f32 trained 600
     steps on docs/ab_convergence_flagship.json's configuration and
     evaluated, R² within 0.03 of that record's and bf16's last-50 loss
     within 10% of f32's;
 10. the rest of the description language: (a) the flagship with its
     readout rewritten to use every built-in layer kind and the registered
     `ChipScale` (Dense selu, LayerNormalization, Dropout, Dense, PReLU,
     BatchNormalization, ChipScale, Activation, AlphaDropout, GaussianNoise,
     ReLU(6), ELU, LeakyReLU, Dense), served (3 requests, B x8 each, against
     the plain path on the CPU in f32 and bf16) and trained (the step-0 f32
     gradients against the plain path on the card from one generator state,
     `plain_on_card`, so that both draw the same masks; training=False
     output independent of the generator; 5 bf16 steps of B x8, C x8, A x7;
     step time, device busy, edge-messages/s); (b) every optimizer kind under
     ExponentialDecay, 3 f32 steps of (a)'s model: the optimizer's f32
     arithmetic held against an f64 copy on the same gradients, the moving
     statistics exact (AdamW's decay alone moves them), phase 9 (e)'s rule
     against a plain f64 run printed; (c) the attention flagship with the
     `reference` softmax (a forward B x8, A x8, no D or E; a step A x29),
     served and trained against the plain path; (d) Q-size with stage 1's
     interleave replaced by attention over its two sources (the library's
     softmax and sum; A x14 a step); (e) `Trainer.train` with a TensorBoard
     directory, the event file read back;
 11. serving artifacts: the flagship (kernel B 8 times a forward), the
     attention flagship (B 8, D 8), flagship_x4 (A 8, B 8), graphprop CSR
     and linkpred (phase 8's first request of 1,024 graphs: A and the
     id-keyed kernel; an edge-level label trimmed through `label_perm`),
     each exported in bf16 (linkpred in f32 too) on the card through
     `igt.export_serving` (`torch.export` of the forward, the kernels in the
     program as the operators `torch.ops.ignnition_tpu_torch.*`), reloaded
     with `igt.load_serving` and served through `predict_samples`. Held: each
     request's launch counts; one artifact forward launches what the
     in-process `ServingModel` forward launches (the wrappers' counts and
     the port's kernels by name in torch.profiler); the predictions against
     the in-process ones on the same weights and batch (f32 within 1e-6, bf16
     within 2^-8 of the largest |prediction|; the difference printed).
     Printed: the device forward and the whole request against the in-process
     ones, export and load seconds, the artifact's size. Then `igt.debug` on
     the card for `examples/routenet`'s description (its `model.export.txt`
     calls kernel B's operator once an iteration) and `Runner.export_serving`
     reloaded against `Runner.predict`;
 12. the roofline, the memory model and the sharded step: (a) the floors
     of `utils/roofline.HardwareSpec` computed again from this run's phase-2
     graph-replay times (the row gather's: its byte bound, beside the
     library's gathers timed here) and printed beside the held constants,
     then `roofline_report` for the flagship, flagship_x4 and attention
     bf16 steps over each step's wall time and its device-busy time
     (profiler); (b) `estimate_train_hbm` against the device memory that
     the first captured bf16 step of the flagship, x4 and x8 allocates at
     its peak, in a process of its own (this script run with
     `--memory-model`), which the estimate must not fall below nor pass 1.5
     times; (c) the flagship at full
     width stepped 3 times in f32 and bf16 over 1x2, 2x1 and 2x2 meshes of a
     gloo world of 4 processes on the card and a 1x1 mesh of an NCCL world
     of one (this script run with `--parallel-rank` per rank), each held to
     the single-device steps on the card (f32 losses at rtol 1e-5 and
     parameters by `tests/test_torch_train.py`'s rule, bf16 losses within
     3e-2), every rank's parameters alike, each rank's launches of B, C and
     the id-keyed kernel (edge sharding) or A (data parallel) counted; the
     step time and the all-reduce's share of a profiled step printed;
 13. destination sharding (`destshard_steps`): the flagship at full width on
     one graph of 2,048 links and 16,384 paths of length 8 a data row
     (locality latent, ids scrambled: `make_local_sample`), partitioned over
     1x2, 1x4 and 2x2 meshes of a gloo world of 4 on the card (this script
     run with `--destshard-rank` per rank) in the dataset's order and
     renumbered by `parallel.locality`, 3 steps each in f32 and bf16, held
     as (c) holds its steps, and `make_edgeshard_apply`'s f32 forward within
     1e-5 of the single-device forward; each rank's launches of A, B and C
     counted (A 8, B 8, C 8 a step); each adjacency's halo height and
     boundary fraction, `comm_bytes_per_step` v2 against v1, the
     all_to_all's share of a profiled step, the gathers' scatter-add
     backward on the device and each rank's peak memory against the
     single-device step's printed;
 14. the compiled steps (`training/capture.py`: each step captured into a
     CUDA graph at its second call and replayed, the first running eagerly):
     (a) 3 bf16 training steps over 3 batches of one meta, from one initial
     state, eagerly (`capture.eager()`) and replayed, for the flagship, x4,
     attention, Q-size, mlp_message, graphprop CSR, graphprop blocks (1,024
     graphs) and linkpred: held step by step (the loss and every leaf
     within 1e-6 of its largest entry, bitwise equality printed; the
     wrappers' counters), then each way's step time, edge-messages per
     second, device busy and idle share, host launches a step and the port's
     kernels by name (the replayed step's held to the eager one's), the
     capture's seconds, graph pool and static inputs against the eager
     step's peak; (b) phase 11's in-process and artifact forwards, two
     requests each, the replayed predictions against the eager ones (bf16
     2^-8, f32 1e-6 of the largest), the port's kernels by name (held as in
     (a)) and the forward and request times both ways; (c) phase 10 (a)'s random layers: successive
     replays draw other masks, and the replayed trajectory from one
     generator state against the eager one; (d) the accumulation step (3
     microbatches) and the evaluation step in f32 against eager (1e-6), and
     phase 9 (b)'s device-cached `train()` loop eager against replayed;
 15. the compiled sharded steps (`compiled_mesh`, run inside phase 12's
     NCCL world of one): the data-parallel and destination-sharded steps and
     forwards of a 1x1 mesh, eager against replayed;
 16. the rest of the JAX package's surface (`rest_of_surface`): (a) the
     plain path of phase 10 goes through the kernel switches
     (`plain_on_card`: `set_pallas_mode("never")`, `rnn_kernels.set_mode
     ("never")`); (b) the flagship bf16 step under 'auto' (replayed), every
     switch at 'never' (eagerly, saying why; no launch from Python and none
     of the port's kernels in a profile) and 'auto' again (the graph
     captured before replays), then the fused-rnn switch alone at 'never'
     (flagship) and the flash-attn switch alone (attention flagship), each
     captured and replayed without its kernels; (c) slot-rate attention
     (`_SLOT_ATTN` on: the JAX package's default, off in the port) where the
     JAX package takes it, the attention family at x4 and the mlp_message
     family's 32-32 network into attention at the flagship size: kernel A
     on each batch's slice-sort companions exactly against its plain
     version, the step-0 f32 gradients against the per-edge form's within
     1e-5 of each leaf's largest entry or the per-edge form's own f32
     distance from f64 (2 iterations), each form's bf16 step replayed
     (time, device busy, kernel-A launches); (d) flagship_x8's bf16 step with and
     without iteration remat (peak MiB, pool, time) and 3 f32 steps of each,
     the parameters within 1e-6; (e) phase 12 (b)'s memory hold, read in a
     fresh process, within 1-1.5 at every size.

Phases 3-13 call the public steps and forwards, which on the card replay
their CUDA graphs from a key's second call on (the mesh steps of phases 12
and 13 stay eager). A wrapper's launch counter counts the launches made
from Python (eagerly or while a capture records), and only these are the
`launches` of the kernels line. A replay runs no wrapper: each hold of a
call's launches reads, for a replay, the counters over its capture
(`Counts.held`), and phase 14 holds each replayed step's and forward's
kernels, counted by name by the profiler, to the eager call's; the other
holds that name the profiler count device kernels by name too. The plain
path on the card (`plain_on_card`, the kernel switches at 'never') runs
eagerly. Phase 5's request at 4x and its hs=48 model take the per-edge
attention form, the port's default (`_SLOT_ATTN` off); phase 16 (c) runs
the slot-rate form, the JAX package's default, at 4x beside it.

The line before the last is one JSON object describing the kernels; the
last line is `{"ok": true, "device": {...}}`. Needs one CUDA device and
nvcc; it never continues on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(n_links=2048, n_paths=16384, path_len=8)
FLAGSHIP_X4 = dict(n_links=8192, n_paths=65536, path_len=8)
N_FLAGSHIP_REQUESTS = 3
TRAIN_STEPS = {"flagship": 5, "flagship_x4": 2}
ATTENTION_TRAIN_STEPS = 3
# under the data layer's floor of 16,384 edges for a dense incidence matrix,
# so the model takes per-edge attention
SMALL_PER_EDGE = dict(n_links=256, n_paths=2000, path_len=8)
ITERATIONS = 8
HS = 32
# device launches of one training step while `_gss_bwd` made a gather, a
# launch of kernel A and an add per slice-sort window (torch.profiler, H100)
EARLIER_LAUNCHES_PER_STEP = {"flagship": 640, "flagship_x4": 1035}


def flagship_description(num_iterations: int = ITERATIONS, hs: int = HS) -> dict:
    """The flagship RouteNet description, copied from `_flagship` in
    `__graft_entry__.py` (that module imports the JAX package)."""
    return {
        "entities": [
            {"name": "link", "hidden_state_dimension": hs,
             "features": [{"name": "link_capacity"}]},
            {"name": "path", "hidden_state_dimension": hs,
             "features": [{"name": "traffic"}]},
        ],
        "message_passing": {
            "num_iterations": num_iterations,
            "stages": [
                {
                    "stage_name": "stage1",
                    "stage_mp": [{
                        "destination_entity": "path",
                        "source_entities": [{
                            "name": "link",
                            "adj_vector": "adj_links_paths",
                            "message": [{"type": "direct_assignation"}],
                        }],
                        "aggregation": {"type": "ordered"},
                        "update": {"type": "recurrent_neural_network", "nn_name": "gru"},
                    }],
                },
                {
                    "stage_name": "stage2",
                    "stage_mp": [{
                        "destination_entity": "link",
                        "source_entities": [{
                            "name": "path",
                            "adj_vector": "adj_paths_links",
                            "message": [{"type": "direct_assignation"}],
                        }],
                        "aggregation": {"type": "sum"},
                        "update": {"type": "recurrent_neural_network", "nn_name": "gru"},
                    }],
                },
            ],
        },
        "readout": [{
            "type": "predict",
            "input": ["path"],
            "label": "delay",
            "label_normalization": "log",
            "nn_name": "readout",
        }],
        "neural_networks": [
            {
                "nn_name": "readout",
                "nn_type": "feed_forward",
                "nn_architecture": [
                    {"type_layer": "Dense", "units": 256, "activation": "selu",
                     "kernel_regularizer": 0.1},
                    {"type_layer": "Dense", "units": 256, "activation": "selu",
                     "kernel_regularizer": 0.1},
                    {"type_layer": "Dense", "units": 1, "activation": "None",
                     "kernel_regularizer": 0.01},
                ],
            },
            {"nn_name": "gru", "nn_type": "recurrent_neural_network",
             "recurrent_type": "GRU"},
        ],
        "learning_options": {
            "loss": "MeanSquaredError",
            "optimizer": {
                "type": "Adam",
                "schedule": {
                    "type": "ExponentialDecay",
                    "initial_learning_rate": 0.001,
                    "decay_steps": 80000,
                    "decay_rate": 0.6,
                },
            },
        },
    }


def attention_description(num_iterations: int = ITERATIONS, hs: int = HS) -> dict:
    """The flagship with stage 2 aggregating by attention (`_mutate_attention`
    in `bench.py`)."""
    desc = flagship_description(num_iterations, hs)
    desc["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"] = {"type": "attention"}
    return desc


def mlp_message_description(num_iterations: int = ITERATIONS, hs: int = HS) -> dict:
    """The flagship with a message network on both stages: 32 relu units,
    then 32 linear, over [hs_source, hs_dest] (`_mutate_mlp_message` in
    `bench.py`)."""
    desc = flagship_description(num_iterations, hs)
    desc["neural_networks"].append({
        "nn_name": "bench_msg",
        "nn_type": "feed_forward",
        "nn_architecture": [
            {"type_layer": "Dense", "units": 32, "activation": "relu"},
            {"type_layer": "Dense", "units": 32, "activation": "None"},
        ],
    })
    for stage in desc["message_passing"]["stages"]:
        for mp in stage["stage_mp"]:
            for se in mp["source_entities"]:
                se["message"] = [{"type": "neural_network", "nn_name": "bench_msg",
                                  "input": ["hs_source", "hs_dest"]}]
    return desc


MLP_MESSAGE_REQUESTS = 3
MLP_MESSAGE_TRAIN_STEPS = 5
FEATURE_DIMS = {"link_capacity": 1, "traffic": 1}

# the Q-size model at the shapes of `tools/bench_qsize.py`: each path visits
# `hops` links and `hops` nodes, interleaved link, node, ... (8 steps)
QSIZE = dict(n_links=2048, n_nodes=2048, n_paths=16384, hops=4)
QSIZE_FEATURE_DIMS = {"link_capacity": 1, "traffic": 1, "queue_sizes": 1}
QSIZE_REQUESTS = 3
QSIZE_TRAIN_STEPS = 5


def normalization_queue_size(feature, name):
    """The Q-size example's normalization (`examples/qsize/main.py`)."""
    if name == "delay":
        return (np.log(feature) + 1.78) / 0.93
    if name == "traffic":
        return (feature - 0.28) / 0.15
    if name == "jitter":
        return (feature - 1.5) / 1.5
    if name == "link_capacity":
        return (feature - 27.0) / 14.86
    if name == "queue_sizes":
        return (feature - 16.5) / 15.5
    return feature


def qsize_description(num_iterations: int = ITERATIONS, hs: int = HS) -> dict:
    """The Q-size model of `examples/qsize/model_description.yaml` (three
    entities; stage 1 interleaves link and node states into each path's
    sequence, stage 2 sums paths into links and into nodes; a 256-256-1 selu
    readout), as a dict: this script reads no file of the repo."""
    state = {"type": "recurrent_neural_network", "nn_name": "state_gru"}
    direct = [{"type": "direct_assignation"}]

    def entity(name, feature):
        return {"name": name, "hidden_state_dimension": hs,
                "features": [{"name": feature, "normalization": "normalization_queue_size"}]}

    def from_paths(dst, adj):
        return {"destination_entity": dst,
                "source_entities": [{"name": "path", "adj_vector": adj, "message": direct}],
                "aggregation": {"type": "sum"}, "update": state}

    dense = lambda units, act, reg: {"type_layer": "Dense", "units": units,
                                     "activation": act, "kernel_regularizer": reg}
    return {
        "entities": [entity("link", "link_capacity"), entity("path", "traffic"),
                     entity("node", "queue_sizes")],
        "message_passing": {
            "num_iterations": num_iterations,
            "stages": [
                {"stage_name": "paths_collect", "stage_mp": [{
                    "destination_entity": "path",
                    "source_entities": [
                        {"name": "link", "adj_vector": "adj_links_paths", "message": direct},
                        {"name": "node", "adj_vector": "adj_nodes_paths", "message": direct},
                    ],
                    "aggregation": {"type": "interleave",
                                    "interleave_definition": "path_interleave"},
                    "update": state,
                }]},
                {"stage_name": "links_and_nodes_collect", "stage_mp": [
                    from_paths("link", "adj_paths_links"),
                    from_paths("node", "adj_paths_nodes"),
                ]},
            ],
        },
        "readout": [{"type": "predict", "input": ["path"], "label": "delay",
                     "label_normalization": "normalization_queue_size",
                     "nn_name": "delay_readout"}],
        "neural_networks": [
            {"nn_name": "delay_readout", "nn_type": "feed_forward",
             "nn_architecture": [dense(256, "selu", 0.1), dense(256, "selu", 0.1),
                                 dense(1, "None", 0.01)]},
            {"nn_name": "state_gru", "nn_type": "recurrent_neural_network",
             "recurrent_type": "GRU"},
        ],
        "learning_options": {
            "loss": "MeanSquaredError",
            "optimizer": {"type": "Adam", "schedule": {
                "type": "ExponentialDecay", "initial_learning_rate": 0.001,
                "decay_steps": 82000, "decay_rate": 0.8, "staircase": "True"}},
        },
    }


def make_sample(rng, n_links, n_paths, path_len):
    """One random RouteNet graph built straight as arrays, as
    `bench.build_case.one_sample` builds it (`bench.py`)."""
    from ignnition_tpu_torch.data.dataset import AdjacencyArrays, GraphSample

    links = rng.integers(0, n_links, size=(n_paths, path_len))
    src_lp = links.reshape(-1).astype(np.int32)
    dst_lp = np.repeat(np.arange(n_paths, dtype=np.int32), path_len)
    seq_lp = np.tile(np.arange(path_len, dtype=np.int32), n_paths)
    src_pl, dst_pl, seq_pl = _reverse(src_lp, dst_lp, n_links)
    return GraphSample(
        num_nodes={"link": n_links, "path": n_paths},
        features={
            "link_capacity": rng.uniform(20, 40, (n_links, 1)).astype(np.float32),
            "traffic": rng.uniform(0.2, 0.8, (n_paths, 1)).astype(np.float32),
        },
        adjacencies={
            "adj_links_paths": AdjacencyArrays(src_lp, dst_lp, seq_lp),
            "adj_paths_links": AdjacencyArrays(src_pl, dst_pl, seq_pl),
        },
        label=rng.uniform(0.1, 1.0, n_paths).astype(np.float32),
    )


def _reverse(src, dst, n_dst):
    """The reverse adjacency of a destination-sorted edge list, sorted by its
    new destination, with each destination's sequence positions."""
    order = np.argsort(src, kind="stable")
    rsrc, rdst = dst[order].copy(), src[order].copy()
    counts = np.bincount(rdst, minlength=n_dst)
    rseq = (np.concatenate([np.arange(c, dtype=np.int32) for c in counts])
            if counts.sum() else np.zeros(0, np.int32))
    return rsrc, rdst, rseq


def make_qsize_sample(rng, n_links, n_nodes, n_paths, hops):
    """One random Q-size graph built straight as arrays, as
    `tools/bench_qsize.py` builds it: each path takes `hops` random links and
    `hops` random nodes, interleaved link, node, ...; stage 2 runs over the
    reverse adjacencies."""
    from ignnition_tpu_torch.data.dataset import AdjacencyArrays, GraphSample

    def stage1(n_src):
        picks = rng.integers(0, n_src, size=(n_paths, hops))
        return (picks.reshape(-1).astype(np.int32),
                np.repeat(np.arange(n_paths, dtype=np.int32), hops),
                np.tile(np.arange(hops, dtype=np.int32), n_paths))

    lp, np_ = stage1(n_links), stage1(n_nodes)
    return GraphSample(
        num_nodes={"link": n_links, "node": n_nodes, "path": n_paths},
        features={
            "link_capacity": rng.uniform(20, 40, (n_links, 1)).astype(np.float32),
            "queue_sizes": rng.uniform(1, 8, (n_nodes, 1)).astype(np.float32),
            "traffic": rng.uniform(0.2, 0.8, (n_paths, 1)).astype(np.float32),
        },
        adjacencies={
            "adj_links_paths": AdjacencyArrays(*lp),
            "adj_nodes_paths": AdjacencyArrays(*np_),
            "adj_paths_links": AdjacencyArrays(*_reverse(lp[0], lp[1], n_links)),
            "adj_paths_nodes": AdjacencyArrays(*_reverse(np_[0], np_[1], n_nodes)),
        },
        interleave={
            ("link", "path"): (2 * np.arange(hops)).astype(np.int64),
            ("node", "path"): (2 * np.arange(hops) + 1).astype(np.int64),
        },
        label=rng.uniform(0.1, 1.0, n_paths).astype(np.float32),
    )


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): device
# memory 3.35 TB/s; 989 TFLOP/s bf16 in the tensor cores; 67 TFLOP/s f32
# outside them. A bound is the larger of bytes / memory rate and operations
# / peak rate of the operands' type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound(n_bytes: float, n_ops: float, dtype) -> tuple:
    """(bound_ms, "bytes" | "operations") for a call that must move
    `n_bytes` and do `n_ops` floating-point operations on `dtype` operands."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_side_stream = None


def side_stream():
    """The stream every graph capture of this script runs on."""
    global _side_stream
    if _side_stream is None:
        _side_stream = torch.cuda.Stream()
    return _side_stream


def graph_ms(calls, replays: int = 7) -> float:
    """Median milliseconds per call over `replays` replays of one CUDA graph
    that holds `calls` in order: device time free of the host's launch cost
    (a replay hands the device the whole graph at once; the gaps between its nodes are
    the device's own)."""
    s = side_stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for fn in calls:
            fn()
    s.synchronize()
    from ignnition_tpu_torch.training.capture import paused_gc

    graph = torch.cuda.CUDAGraph()
    with paused_gc(), torch.cuda.graph(graph, stream=s):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return float(np.median(times))


COLD_WORKING_SET = 120e6  # bytes of rotated inputs: past twice the 50 MB L2


def clone_args(args):
    """A deep copy of a call's arguments: tensors cloned, dicts and tuples
    walked, everything else shared."""
    if isinstance(args, torch.Tensor):
        return args.clone()
    if isinstance(args, dict):
        return {k: clone_args(v) for k, v in args.items()}
    if isinstance(args, (tuple, list)):
        return tuple(clone_args(a) for a in args)
    return args


def arg_bytes(args) -> int:
    if isinstance(args, torch.Tensor):
        return args.numel() * args.element_size()
    if isinstance(args, dict):
        return sum(arg_bytes(v) for v in args.values())
    if isinstance(args, (tuple, list)):
        return sum(arg_bytes(a) for a in args)
    return 0


def rotations(args) -> list:
    """`args` and enough copies of it that one pass over all of them reads
    more than `COLD_WORKING_SET` bytes: a call on the next copy finds none
    of its inputs in the L2."""
    n = min(64, max(2, int(COLD_WORKING_SET // max(1, arg_bytes(args))) + 1))
    return [args] + [clone_args(args) for _ in range(n - 1)]


def device_times(call, arg_sets, guarded: bool = False, what: str = "") -> dict:
    """Three times of `call(*args)` in milliseconds: `ms`, the mean of 20 calls
    made from Python between two CUDA events (host launch cost included, the
    inputs in L2);
    `graph_ms`, the same call 20 times in a replayed CUDA graph (device time,
    inputs in L2); `cold_ms`, a replayed graph that walks `arg_sets`, copies
    of the inputs that together exceed the L2 (device time, every call reading
    device memory). `guarded`: a library call that cannot be captured gives
    None for the graph times instead of raising."""
    hot = arg_sets[0]
    out = dict(ms=cuda_ms(lambda: call(*hot)), graph_ms=None, cold_ms=None)
    try:
        out["graph_ms"] = graph_ms([lambda: call(*hot)] * 20)
        reps = max(1, -(-12 // len(arg_sets)))
        out["cold_ms"] = graph_ms([(lambda a=a: call(*a)) for a in arg_sets] * reps)
    except Exception as err:  # noqa: BLE001 - a yardstick may refuse capture
        if not guarded:
            raise
        torch.cuda.synchronize()
        print(f"    {what}: not captured in a CUDA graph ({type(err).__name__}: "
              f"{str(err).splitlines()[0][:120]}); graph and cold times not measured")
    return out


def fmt_times(t: dict) -> str:
    f = lambda v: "not measured" if v is None else f"{v:.4f}"
    return f"{f(t['ms'])} ms (graph replay {f(t['graph_ms'])}, cold {f(t['cold_ms'])})"


def forward_ms(server, batch, runs: int = 20, warmup: int = 3) -> list:
    """Milliseconds of each of `runs` forwards on a device-resident batch,
    from CUDA events, after `warmup` untimed forwards."""
    out = []
    for i in range(warmup + runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        server.forward_device(batch)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            out.append(start.elapsed_time(end))
    return out


def build_batch_ms(what: str, build, card: str, runs: int = 5, numpy_runs: int = 3) -> dict:
    """Host milliseconds of `build()` (a `build_batch` call) through the
    port's native helpers, median of `runs`, and for the record through its
    numpy routines (the data layer's module flag off), median of
    `numpy_runs`. Both give the same arrays."""
    from ignnition_tpu_torch.data import graph as t_graph

    def timed(n):
        times, arrays = [], None
        for _ in range(n):
            t1 = time.perf_counter()
            arrays = build()
            times.append((time.perf_counter() - t1) * 1e3)
        return float(np.median(times)), arrays

    native_ms, native = timed(runs)
    t_graph._USE_NATIVE_AUX = False
    try:
        numpy_ms, plain = timed(numpy_runs)
    finally:
        t_graph._USE_NATIVE_AUX = True
    if sorted(native) != sorted(plain) or not all(
            native[k].dtype == plain[k].dtype and np.array_equal(native[k], plain[k])
            for k in native):
        raise AssertionError(f"{what}: build_batch through the native helpers and through "
                             "numpy gave different arrays")
    print(f"[latency] {what}: build_batch median {native_ms:.1f} ms through the native "
          f"helpers ({runs} runs), {numpy_ms:.1f} ms through numpy ({numpy_runs} runs), the same "
          f"arrays; host clock on {card}")
    return dict(build_batch_ms=native_ms, build_batch_numpy_ms=numpy_ms)


def profiled_events(fn, runs: int = 5, want: tuple = ()) -> list:
    """torch.profiler's events (host and device) over `runs` calls of `fn`,
    after one untimed call. The profiler has missed the first kernels of a
    profile now and then, once a whole profile, and once every launch of one
    kernel of five calls (kernel C's sweep, beside its other two kernels): a
    short sleep kernel opens each profile, and a profile without any device
    activity, or with fewer than `runs` device records of a kernel whose name
    holds a part in `want` (each launched once a call), is taken again, up to
    6 times a second apart. The last profile is returned either way: the
    caller's hold says what is missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = list(prof.events())
        device = [e.name for e in events
                  if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name]
        if device and all(sum(part in n for n in device) >= runs for part in want):
            break
        if attempt < 5:
            print(f"    torch.profiler lost device records ({len(device)} seen over {runs} "
                  f"calls; expected at least {runs} of each of {list(want)}): profiled again")
    return events


def device_time_by_kernel(fn, runs: int = 5, want: tuple = ()) -> tuple:
    """({kernel name: device ms per call of `fn`}, kernels launched per call)
    from torch.profiler's CUDA activity over `runs` calls (`profiled_events`,
    which profiles again while a kernel named by a part in `want` is short of
    a record; the sleep kernel not counted)."""
    from torch.autograd import DeviceType

    per_name, count = {}, 0
    for e in profiled_events(fn, runs, want):
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / runs
            count += 1
    return per_name, count / runs


def yardstick_diff(name: str, lib: torch.Tensor, ref: torch.Tensor) -> None:
    """Print how far a library call's result lies from the port's: the call
    is timed as a yardstick and is not the port's code, so only its shape and
    finiteness are held (it must compute the same function, not round alike)."""
    lib = lib.detach().to("cpu", torch.float32)
    ref = ref.detach().to("cpu", torch.float32)
    if lib.shape != ref.shape or not torch.isfinite(lib).all():
        raise AssertionError(f"{name}: shape {tuple(lib.shape)} or non-finite values")
    print(f"    {name}: max abs difference from the port {float((lib - ref).abs().max()):.3e}"
          f" (max |value| {float(ref.abs().max()):.3e})")


def print_profile(what: str, fn, wall_ms: float) -> dict:
    """Profile `fn` by kernel, print the ten largest, and return the busy
    time, launches per call and idle share of `wall_ms` (empty when the
    profiler saw no device activity)."""
    per_kernel, n_kernels = device_time_by_kernel(fn)
    busy = sum(per_kernel.values())
    if busy == 0.0:
        print(f"[profile] {what}: the profiler saw no device activity; "
              "device busy share not measured")
        return {}
    print(f"[profile] {what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"({busy / wall_ms:.1%}), {n_kernels:.0f} kernel launches per call "
          f"(torch.profiler, 5 calls)")
    for kname, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {ms:8.4f} ms {ms / busy:6.1%}  {kname[:90]}")
    return dict(device_busy_ms=busy, kernels_per_call=n_kernels,
                device_idle_share=max(0.0, 1.0 - busy / wall_ms))


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float,
            why: str) -> float:
    """Print the max abs/rel error and raise unless |got - want| <=
    atol + rtol * |want| holds everywhere."""
    got = got.detach().to("cpu", torch.float32)
    want = want.detach().to("cpu", torch.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / want.abs().clamp_min(1e-6)).max()) if err.numel() else 0.0
    ok = bool((err <= atol + rtol * want.abs()).all())
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"tol atol={atol:g} rtol={rtol:g} ({why}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its reference beyond the tolerance")
    return max_abs


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def segment_case(rng, kind: str, e: int, n: int) -> tuple:
    """(row_ptr [n + 1] int32, ids [e] int32, real edges) of a sorted edge
    list. `uniform`: 5% of the rows empty, the last 1,000 edges padding (past
    row_ptr[-1]; their id is n, which the id-keyed sum does not count);
    `skewed`: one row holds a quarter of the edges, the rest are short;
    `one_of_many`: every edge in one row of n; `even`: e / n edges a row."""
    if kind == "uniform":
        e_real = e - 1_000
        live = np.sort(rng.choice(n, size=n - n // 20, replace=False))
        real = np.sort(rng.choice(live, size=e_real))
    elif kind == "skewed":
        e_real = e - 1_000
        real = np.sort(np.concatenate([
            np.full(e // 4, n // 3), rng.integers(0, n, size=e_real - e // 4)]))
    elif kind == "one_of_many":
        e_real, real = e, np.full(e, n // 2)
    else:
        e_real, real = e, np.repeat(np.arange(n), e // n)
    ids = np.concatenate([real, np.full(e - e_real, n)]).astype(np.int32)
    row_ptr = np.searchsorted(real, np.arange(n + 1)).astype(np.int32)
    return row_ptr, ids, e_real


def case_of_row_ptr(row_ptr: np.ndarray, e: int) -> tuple:
    """`segment_case`'s triple for a batch's own row pointers over e edge
    rows (those past row_ptr[-1] are padding, keyed n)."""
    n, e_real = row_ptr.shape[0] - 1, int(row_ptr[-1])
    ids = np.concatenate([np.repeat(np.arange(n), np.diff(row_ptr)), np.full(e - e_real, n)])
    return row_ptr.astype(np.int32), ids.astype(np.int32), e_real


def case_of_ids(ids: np.ndarray, n: int) -> tuple:
    """`segment_case`'s triple for ids that never decrease, those past the
    last segment (n) trailing."""
    if not np.all(np.diff(ids) >= 0) or ids.min() < 0 or ids.max() > n:
        raise AssertionError("the ids are not sorted within [0, n]")
    e_real = int(np.sum(ids < n))
    real = ids[:e_real]
    return np.searchsorted(real, np.arange(n + 1)).astype(np.int32), ids.astype(np.int32), e_real


def check_segment_sums(dev, rng, what: str, e: int, n: int, d: int, kind: str = "uniform",
                       gathered: bool = False, timed: bool = False, case=None,
                       perm=None) -> dict:
    """Kernel A (row pointers) and the id-keyed kernel (the same edges by
    their sorted ids, int32 and int64) on [e, d] rows into n segments, in bf16
    and f32, against the plain versions, each twice and compared bitwise.
    `case`: the (row_ptr, ids, real edges) of a batch, else `segment_case`'s
    `kind`. `gathered`: the rows come through a row gather by a permutation
    first (`perm`, else a random one), as `_gss_bwd` and `gather_rows`'s
    backward feed kernel A. `timed`: the three times of each kernel beside
    its library call (`torch.segment_reduce`, `index_add_`) and bound.
    Returns {"csr": {dtype: {...}}, "ids": {dtype: {...}}}."""
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    row_ptr, ids_np, e_real = segment_case(rng, kind, e, n) if case is None else case
    if ids_np.shape[0] != e or row_ptr.shape[0] != n + 1:
        raise AssertionError(f"{what}: the case is not [{e}] ids into {n} rows")
    kind = kind if case is None else "the batch's own"
    longest = int(np.diff(row_ptr).max())
    rp = torch.from_numpy(row_ptr).to(dev)
    ids = torch.from_numpy(ids_np).to(dev)
    ids64 = ids.to(torch.int64)
    offsets = rp.to(torch.int64)
    perm = torch.from_numpy(rng.permutation(e) if perm is None
                            else perm.astype(np.int64)).to(dev)
    # rows of more than 4,096 edges: small integers, whose f32 sums are exact
    # in any order, so the limits below hold whatever the length
    exact = longest > 4096
    values = (rng.integers(-4, 5, size=(e, d)) if exact
              else rng.standard_normal((e, d))).astype(np.float32)
    why = (f"exact: sums of small integers over up to {longest} rows" if exact
           else f"f32 sums of up to {longest} rows in another order (plain uses atomics)")
    out = {"csr": {}, "ids": {}}
    for dtype in (torch.bfloat16, torch.float32):
        data = torch.from_numpy(values).to(dev, dtype)
        if gathered:
            data = data[perm]
        tag = f"({what}, {kind}) [{e}x{d}] -> [{n}x{d}] {str(dtype)[6:]}"
        want = sk.sorted_segment_sum_csr_plain(data, rp)
        before = (sk.launch_count, sk.ids_launch_count)
        got = {"csr": (sk.sorted_segment_sum_csr(data, rp), sk.sorted_segment_sum_csr(data, rp)),
               "ids": (sk.sorted_segment_sum_ids(data, ids, n),
                       sk.sorted_segment_sum_ids(data, ids, n)),
               "ids int64": (sk.sorted_segment_sum_ids(data, ids64, n),) * 2}
        torch.cuda.synchronize()
        if (sk.launch_count, sk.ids_launch_count) != (before[0] + 2, before[1] + 3):
            raise AssertionError("the segment-sum wrappers did not launch their kernels")
        errs = {}
        for which, (first, second) in got.items():
            if first.dtype != torch.float32:
                raise AssertionError(f"{which} returned {first.dtype}, the contract is f32")
            if not torch.equal(first, second):
                raise AssertionError(f"{which} {tag}: two calls differ bitwise")
            errs[which] = compare(f"segment sum by {which} {tag}, bitwise repeatable",
                                  first, want, atol=1e-4, rtol=1e-5, why=why)
        if not torch.equal(got["ids"][0], got["ids int64"][0]):
            raise AssertionError(f"{tag}: int32 and int64 ids give different sums")
        real, real_ids = data[:e_real], ids64[:e_real]
        if not timed:
            for which in out:
                out[which][dtype] = dict(max_abs_err=errs[which])
            t_csr = graph_ms([lambda: sk.sorted_segment_sum_csr(data, rp)] * 20)
            t_ids = graph_ms([lambda: sk.sorted_segment_sum_ids(data, ids, n)] * 20)
            t_lib = graph_ms([lambda: torch.segment_reduce(
                real, "sum", offsets=offsets, axis=0, unsafe=True)] * 20)
            print(f"    graph replay: kernel A {t_csr:.4f} ms, id-keyed kernel {t_ids:.4f} ms, "
                  f"torch.segment_reduce {t_lib:.4f} ms")
            continue
        es = data.element_size()
        plain_ids = sk.sorted_segment_sum_ids_plain(data, ids, n)
        compare(f"the two plain versions {tag}", plain_ids, want, atol=1e-4, rtol=1e-5, why=why)
        # the library's calls on the same real rows (sums in the data's type)
        lib = torch.segment_reduce(real, "sum", offsets=offsets, axis=0, unsafe=True)
        yardstick_diff(f"library torch.segment_reduce {str(dtype)[6:]} (sums in the data's "
                       f"type)", lib, want)
        lib = torch.zeros((n, d), dtype=dtype, device=dev).index_add_(0, real_ids, real)
        yardstick_diff(f"library index_add_ {str(dtype)[6:]} (sums in the data's type)",
                       lib, want)
        rows = [
            ("csr", lambda x, r: sk.sorted_segment_sum_csr(x, r), (data, rp),
             lambda x, r: sk.sorted_segment_sum_csr_plain(x, r), "torch.segment_reduce",
             lambda x, o: torch.segment_reduce(x, "sum", offsets=o, axis=0, unsafe=True),
             (real, offsets), (n + 1) * 4),
            ("ids", lambda x, i: sk.sorted_segment_sum_ids(x, i, n), (data, ids),
             lambda x, i: sk.sorted_segment_sum_ids_plain(x, i, n), "index_add_",
             lambda x, i: torch.zeros((n, d), dtype=dtype, device=dev).index_add_(0, i, x),
             (real, real_ids), e * ids.element_size()),
        ]
        for which, call, args, plain, lib_name, lib_call, lib_args, index_bytes in rows:
            t = device_times(call, rotations(args))
            plain_ms = cuda_ms(lambda: plain(*args))
            t_lib = device_times(lib_call, rotations(lib_args), guarded=True, what=lib_name)
            n_bytes = e_real * d * es + index_bytes + n * d * 4
            bound_ms, bound_by = bound(n_bytes, e_real * d, torch.float32)  # f32 adds
            print(f"    time {which}: kernel {fmt_times(t)}, plain {plain_ms:.4f} ms, "
                  f"{lib_name} {fmt_times(t_lib)}, bound {bound_ms:.4f} ms by {bound_by} "
                  f"({n_bytes / t['cold_ms'] / 1e6:.0f} GB/s moved by the cold kernel)")
            out[which][dtype] = dict(
                max_abs_err=errs[which], **t, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=t_lib["ms"], library_graph_ms=t_lib["graph_ms"],
                library_cold_ms=t_lib["cold_ms"])
    return out


def time_segment_kernels(package_root: str) -> None:
    """Print the three times of kernel A and the id-keyed sum of the
    `ignnition_tpu_torch` package under `package_root` at the timed shapes of
    phase 2. For holding two trees against each other on one card: unpack the
    other commit into a directory, then in one command run, once per tree and
    in turns (parent, change, change, parent),

        python3 -c "import chip_smoke as c; c.time_segment_kernels('DIR')"

    from the checkout whose timing method is to be used. `main` never calls
    it."""
    sys.path.insert(0, os.path.abspath(package_root))
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    dev, rng = torch.device("cuda", 0), np.random.default_rng(SEED)
    print(f"segment kernels of {os.path.dirname(os.path.dirname(os.path.dirname(sk.__file__)))}")
    for e, n, d in ((131_072, 2048, 32), (524_288, 8192, 32), (524_288, 8192, 8),
                    (131_072, 2048, 48)):
        row_ptr, ids_np, _ = segment_case(rng, "uniform", e, n)
        rp = torch.from_numpy(row_ptr).to(dev)
        ids = torch.from_numpy(ids_np).to(dev).to(torch.int64)
        for dtype in (torch.bfloat16, torch.float32):
            data = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(dev, dtype)
            t_csr = device_times(lambda x, r: sk.sorted_segment_sum_csr(x, r),
                                 rotations((data, rp)))
            t_ids = device_times(lambda x, i: sk.sorted_segment_sum_ids(x, i, n),
                                 rotations((data, ids)))
            print(f"  [{e}x{d}] -> [{n}x{d}] {str(dtype)[6:]}: kernel A {fmt_times(t_csr)}; "
                  f"id-keyed {fmt_times(t_ids)}")


def check_segment_sum_windows(dev, rng, n_paths: int, path_len: int, n_src: int,
                              d: int = HS, comp=None) -> dict:
    """Kernel A over several windows at the shape `_gss_bwd` gives it: the
    cotangent rows of [path_len, n_paths] slots gathered into source order by
    the data layer's windowed slice sort (`comp`, a batch's own
    `slice_sort_row_ptr` and `slice_sort_perm`, else that of random slices),
    summed into n_src rows in one launch; against the plain windowed version
    and the loop of one launch per window that it replaces; timed beside
    `index_add_` over the whole ids (each row's source, whatever its window),
    as the id-keyed rows are measured."""
    from ignnition_tpu_torch.data.graph import slice_sort_companions
    from ignnition_tpu_torch.ops import segment as seg
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    if comp is None:
        slice_src = rng.integers(0, n_src, size=(path_len, n_paths)).astype(np.int32)
        comp = slice_sort_companions(slice_src, n_src)
    rp = torch.from_numpy(comp["slice_sort_row_ptr"]).to(dev)
    local = torch.from_numpy(comp["slice_sort_perm"]).to(dev)
    n_slots = path_len * n_paths
    windows = (rp.shape[0] - 1) // n_src
    w = -(-n_slots // windows)
    whole = seg._whole_sort_perm(local, windows)
    if seg._whole_sort_perm(local, windows) is not whole:
        raise AssertionError("the whole permutation is not kept on its tensor")
    # the library's yardstick: every summed row keyed by its source
    rp_np = comp["slice_sort_row_ptr"].astype(np.int64)
    lo, hi = int(rp_np[0]), int(rp_np[-1])
    lib_ids = torch.from_numpy(np.repeat(np.arange(windows * n_src) % n_src,
                                         np.diff(rp_np))).to(dev)

    def per_window_loop(flat):
        total = None
        for c in range(windows):
            lo, hi = c * w, min((c + 1) * w, n_slots)
            part = flat[lo:hi][local[lo:hi]]
            s = sk.sorted_segment_sum_csr(part, rp[c * n_src: c * n_src + n_src + 1] - lo)
            total = s if total is None else total + s
        return total

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        flat = torch.from_numpy(
            rng.standard_normal((n_slots, d)).astype(np.float32)).to(dev, dtype)
        data = flat[whole]
        tag = f"[{n_slots}x{d}], {windows} windows -> [{n_src}x{d}] {str(dtype)[6:]}"
        before = (sk.launch_count, sk.windows_launch_count)
        got = sk.sorted_segment_sum_csr_windows(data, rp, n_src)
        again = sk.sorted_segment_sum_csr_windows(data, rp, n_src)
        torch.cuda.synchronize()
        if (sk.launch_count, sk.windows_launch_count) != (before[0] + 2, before[1] + 2):
            raise AssertionError("the windowed sum is not one launch of kernel A per call")
        if got.dtype != torch.float32 or not torch.equal(got, again):
            raise AssertionError(f"windowed sum {tag}: {got.dtype}, or two calls differ")
        why = f"f32 sums of ~{n_slots // n_src} rows in another order"
        err = compare(f"kernel A windowed {tag} vs plain, bitwise repeatable", got,
                      sk.sorted_segment_sum_csr_windows_plain(data, rp, n_src),
                      atol=1e-4, rtol=1e-5, why=why)
        compare(f"kernel A windowed {tag} vs one launch per window", got,
                per_window_loop(flat), atol=1e-4, rtol=1e-5, why=why)
        t = device_times(lambda x, r: sk.sorted_segment_sum_csr_windows(x, r, n_src),
                         rotations((data, rp)))
        loop_ms = cuda_ms(lambda: per_window_loop(flat))
        both_ms = cuda_ms(
            lambda: sk.sorted_segment_sum_csr_windows(flat[whole], rp, n_src))
        plain_ms = cuda_ms(lambda: sk.sorted_segment_sum_csr_windows_plain(data, rp, n_src),
                           iters=5)
        index_add = lambda x, i: torch.zeros(  # noqa: E731
            (n_src, d), dtype=dtype, device=dev).index_add_(0, i, x)
        yardstick_diff(f"library index_add_ {str(dtype)[6:]} over the whole ids (sums in the "
                       f"data's type)", index_add(data[lo:hi], lib_ids), got)
        t_lib = device_times(index_add, rotations((data[lo:hi], lib_ids)), guarded=True,
                             what="index_add_")
        n_bytes = n_slots * d * data.element_size() + rp.shape[0] * 4 + n_src * d * 4
        bound_ms, bound_by = bound(n_bytes, n_slots * d, torch.float32)
        print(f"    time: kernel {fmt_times(t)}, with its gather {both_ms:.4f} ms; the loop of "
              f"{windows} gathers, launches and adds it replaces {loop_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms; index_add_ over the whole ids {fmt_times(t_lib)}; bound "
              f"{bound_ms:.4f} ms by {bound_by}")
        out[dtype] = dict(max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=t_lib["ms"],
                          library_graph_ms=t_lib["graph_ms"], library_cold_ms=t_lib["cold_ms"],
                          with_gather_ms=both_ms, per_window_loop_ms=loop_ms)
    return out


def check_ids_call_is_one_launch(dev, rng) -> None:
    """Device kernels per call of `sorted_segment_sum_ids`, from the profiler:
    one (the earlier wrapper made three and a cast)."""
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    e, n, d = 131_072, FLAGSHIP["n_links"], 48
    ids = torch.from_numpy(np.sort(rng.integers(0, n, size=e)).astype(np.int32)).to(dev)
    data = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)).to(dev)
    per_kernel, launches = device_time_by_kernel(lambda: sk.sorted_segment_sum_ids(data, ids, n),
                                                 want=("segment_sum_kernel",))
    if not per_kernel:
        print("[kernels] id-keyed call: the profiler saw no device activity; device "
              "launches per call not measured")
        return
    print(f"[kernels] one call of sorted_segment_sum_ids: {launches:.0f} device launch "
          f"(torch.profiler; 3 and a cast before): "
          + ", ".join(f"{k[:60]} {v:.4f} ms" for k, v in per_kernel.items()))
    if launches != 1:
        raise AssertionError(f"sorted_segment_sum_ids made {launches} device launches a call")


def _gru_inputs(dev, rng, L, n, d, u):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    lens_np = rng.integers(0, L + 1, size=n).astype(np.int32)
    lens_np[:2] = (0, L)
    lens = torch.from_numpy(lens_np).to(dev)
    p32 = {"kernel": 0.2 * f(d, 3 * u), "recurrent_kernel": 0.2 * f(u, 3 * u),
           "bias": 0.1 * f(2, 3 * u)}
    return f(L, n, d), lens, torch.full_like(lens, L), 0.5 * f(n, u), p32, f(n, u)


def _library_gru(params, d, u, dtype, dev) -> torch.nn.GRU:
    """`torch.nn.GRU` (cuDNN's reset-after GRU) holding the Keras params: the
    gate columns go from Keras's z, r, h to PyTorch's r, z, n."""
    gru = torch.nn.GRU(d, u, num_layers=1, bias=True).to(dev, dtype)
    order = lambda w: torch.cat([w[..., u:2 * u], w[..., :u], w[..., 2 * u:]], dim=-1)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(order(params["kernel"]).T)
        gru.weight_hh_l0.copy_(order(params["recurrent_kernel"]).T)
        gru.bias_ih_l0.copy_(order(params["bias"][0]))
        gru.bias_hh_l0.copy_(order(params["bias"][1]))
    gru.flatten_parameters()
    return gru


def _gru_bytes(L, n, d, u, es):
    """Bytes of the scan's inputs (xs, lens, h0, weights) and of one [n, u]
    state in the working type."""
    return L * n * d * es + n * 4 + n * u * es + (d + u + 2) * 3 * u * es, n * u * es


def _ptxas_of(what: str, pattern: str) -> str:
    """What `-Xptxas=-v` reported for every kernel whose (mangled) name
    matches `pattern`; raises if the build log reports none, so that spills
    cannot go unread, or if ptxas spilled."""
    from ignnition_tpu_torch.ops.cuda import _build

    found = []
    for name, used, spill in ptxas_entries(_build.build_log):
        at = re.search(pattern, name)
        if at is None:
            continue
        if re.search(r"[1-9]\d* bytes spill", spill):
            raise AssertionError(f"{what}: ptxas spilled in {name}: {spill}")
        found.append(f"{at.group(0)} {used.split(',')[0]}")
    if not found:
        raise AssertionError(f"the build log holds no ptxas report of {what}")
    return "; ".join(found) + "; no spills"


def _b_ptxas() -> str:
    """Every instance of kernel B (each template instantiation in
    `csrc/gru_scan.cu`)."""
    return _ptxas_of("kernel B", r"masked_gru_scan_(mma_)?kernelI\w*?E(?=Ev)")


def _c_ptxas() -> str:
    """Every kernel of `csrc/gru_scan_bwd.cu`: both sweeps' instances, the
    weight-gradient kernel and the finalize pass."""
    return _ptxas_of("kernel C", r"gru_bwd_(?:sweep_mma|sweep|wgrad|finalize)_kernel"
                                 r"(?:I\w*?E(?=Ev))?")


def _b_ran(rk, args) -> str:
    """The instance of kernel B that served one call on `args`: the name of
    the kernel that torch.profiler saw run, in `forward_instance`'s terms."""
    per_kernel, _ = device_time_by_kernel(lambda: rk.masked_gru_scan(*args), runs=1,
                                          want=("masked_gru_scan",))
    ran = {rk.profiled_instance(k) for k in per_kernel if "masked_gru_scan" in k}
    if len(ran) != 1:
        raise AssertionError(f"the profiler saw kernel B instances {sorted(ran)} in one call "
                             f"(kernels {sorted(per_kernel)})")
    return ran.pop()


def _time_gru_forward(rk, dev, rng, L, n, d, u, dtype, library: bool = True) -> dict:
    """Kernel B's three times at [L, n, d] u (all lengths L), with
    `torch.nn.GRU`'s beside them when `library`."""
    xs32, _, full, h032, p32, _ = _gru_inputs(dev, rng, L, n, d, u)
    xs, h0 = xs32.to(dtype), h032.to(dtype)
    p = {k: v.to(dtype) for k, v in p32.items()}
    with torch.no_grad():
        t = device_times(rk.masked_gru_scan, rotations((xs, full, h0, p)))
        if not library:
            return dict(kernel=t)
        gru = _library_gru(p, d, u, dtype, dev)
        yardstick_diff(f"library torch.nn.GRU (cuDNN) [{L},{n},{d}] u={u} at full lengths "
                       f"{str(dtype)[6:]}", gru(xs, h0[None])[1][0],
                       rk.masked_gru_scan(xs, full, h0, p))
        t_lib = device_times(lambda x, h: gru(x, h), rotations((xs, h0[None])),
                             guarded=True, what="torch.nn.GRU")
    return dict(kernel=t, library=t_lib, inputs=(xs, full, h0, p))


# kernels B and C against their plain versions: (atol, rtol, why) of B's
# output; (atol of d_xs and d_h0, of the weight and bias gradients relative to
# the leaf's largest entry, why) of C's gradients
B_TOLS = {
    torch.float32: (1e-5, 1e-5, "f32 dot products of 32 terms in another order"),
    torch.bfloat16: (3e-2, 0.0, "a 1-ulp flip of the bf16-rounded carry at one "
                                "step propagates through later steps"),
}
# d_xs and d_h0 are per-row values of order 1: absolute limits. The weight and
# bias gradients sum L * n row-steps: limits relative to the leaf's largest entry.
C_TOLS = {
    torch.float32: (1e-4, 1e-5, "f32 sums in another order"),
    torch.bfloat16: (3e-2, 2e-2, "f32 sums in another order flip the bf16 "
                                 "rounding of a gate gradient or the carry"),
}


def _hold_b(rk, xs, lens, h0, p, tag: str) -> float:
    """Kernel B twice (compared bitwise) against its plain version, with
    `B_TOLS`; returns the largest error."""
    dtype = xs.dtype
    got = rk.masked_gru_scan(xs, lens, h0, p)
    again = rk.masked_gru_scan(xs, lens, h0, p)
    want = rk.masked_gru_scan_plain(xs, lens, h0, p)
    torch.cuda.synchronize()
    if got.dtype != dtype or not torch.equal(got, again):
        raise AssertionError(f"kernel B returned {got.dtype} for {dtype} input, or two calls "
                             f"differ")
    atol, rtol, why = B_TOLS[dtype]
    return compare(f"kernel B {tag} {str(dtype)[6:]}, bitwise repeatable", got, want,
                   atol=atol, rtol=rtol, why=why)


def _hold_c(rk, xs, lens, h0, p, ct, tag: str) -> float:
    """Kernel C through `masked_gru_scan`'s autograd, twice (compared
    bitwise), against the plain gradients (bf16: the reference with the TPU
    kernel's rounding places; f32: autograd's, the same function), with
    `C_TOLS`; returns the largest error of d_xs and d_h0."""
    dtype, names = xs.dtype, ("kernel", "recurrent_kernel", "bias")
    row_tol, sum_tol, why = C_TOLS[dtype]
    reference = (rk.masked_gru_scan_bwd_kernel_plain if dtype == torch.bfloat16
                 else rk.masked_gru_scan_bwd_plain)
    leaves = [xs.clone().requires_grad_(True), h0.clone().requires_grad_(True)]
    leaves += [p[k].clone().requires_grad_(True) for k in names]
    before = rk.bwd_launch_count
    runs = []
    for _ in range(2):
        h = rk.masked_gru_scan(leaves[0], lens, leaves[1], dict(zip(names, leaves[2:])))
        runs.append(torch.autograd.grad(h, leaves, ct))
    torch.cuda.synchronize()
    if rk.bwd_launch_count != before + 2:
        raise AssertionError("the backward did not launch kernel C once a call")
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"kernel C {tag} {str(dtype)[6:]}: two identical calls differ")
    err = 0.0
    for name, g, w in zip(GRAD_NAMES, runs[0], reference(xs, lens, h0, p, ct)):
        if g.dtype != dtype:
            raise AssertionError(f"kernel C returned {name} in {g.dtype}")
        per_row = name in ("d_xs", "d_h0")
        atol = row_tol if per_row else sum_tol * float(w.float().abs().max())
        e = compare(f"kernel C {name} {tag} {str(dtype)[6:]}, bitwise repeatable", g, w,
                    atol=atol, rtol=0.0,
                    why=why + ("" if per_row else f"; {sum_tol:g} of the leaf's largest entry"))
        if per_row:
            err = max(err, e)
    return err


def check_gru_at(dev, rng, what: str, L: int, n: int, d: int, u: int) -> dict:
    """Kernels B and C at [L, n, d] u (random lengths 0..L) against their
    plain versions in bf16 and f32, with phase 2's limits. Returns
    {kernel name: {dtype: largest error}}."""
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk

    xs32, lens, _, h032, p32, ct32 = _gru_inputs(dev, rng, L, n, d, u)
    out = {"masked_gru_scan": {}, "masked_gru_scan_bwd": {}}
    for dtype in (torch.bfloat16, torch.float32):
        xs, h0, ct = xs32.to(dtype), h032.to(dtype), ct32.to(dtype)
        p = {k: v.to(dtype) for k, v in p32.items()}
        tag = f"[{L},{n},{d}] u={u} ({what})"
        out["masked_gru_scan"][dtype] = _hold_b(rk, xs, lens, h0, p, tag)
        out["masked_gru_scan_bwd"][dtype] = _hold_c(rk, xs, lens, h0, p, ct,
                                                    tag + ", random lengths")
    return out


def check_gru_scan(dev, rng) -> dict:
    """Kernel B's instance for each dtype against the plain version at the
    flagship shape (and in bf16 at N=1,000, D=20, u=48), then its times at
    the flagship and x4 shapes beside cuDNN's GRU and the bound."""
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk

    L, n, d, u = FLAGSHIP["path_len"], FLAGSHIP["n_paths"], HS, HS
    shapes = {torch.bfloat16: [(L, n, d, u), (L, 1000, 20, 48)], torch.float32: [(L, n, d, u)]}
    print(f"  kernel B instances, ptxas: {_b_ptxas()}")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs = []
        for Ls, ns, ds, us in shapes[dtype]:
            xs32, lens, _, h032, p32, _ = _gru_inputs(dev, rng, Ls, ns, ds, us)
            xs, h0 = xs32.to(dtype), h032.to(dtype)
            p = {k: v.to(dtype) for k, v in p32.items()}
            instance, ran = rk.forward_instance(dtype, us), _b_ran(rk, (xs, lens, h0, p))
            print(f"  kernel B instance for {str(dtype)[6:]} u={us}: {ran} ran (profiler), "
                  f"the rule says {instance}")
            if ran != instance:
                raise AssertionError(f"kernel B ran {ran} for {dtype} u={us}, the rule says "
                                     f"{instance}")
            errs.append(_hold_b(rk, xs, lens, h0, p, f"{instance} [{Ls},{ns},{ds}] u={us}"))
        # timed at full lengths: every flagship path has path_len links
        timed = _time_gru_forward(rk, dev, rng, L, n, d, u, dtype)
        t, t_lib = timed["kernel"], timed["library"]
        xs, full, h0, p = timed["inputs"]
        plain_ms = cuda_ms(lambda: rk.masked_gru_scan_plain(xs, full, h0, p))
        flops = 2 * L * n * (d + u) * 3 * u
        in_bytes, state_bytes = _gru_bytes(L, n, d, u, xs.element_size())
        bound_ms, bound_by = bound(in_bytes + state_bytes, flops, dtype)
        print(f"    time at full lengths: kernel {fmt_times(t)}, plain {plain_ms:.4f} ms, "
              f"torch.nn.GRU {fmt_times(t_lib)}, bound {bound_ms:.4f} ms by {bound_by} "
              f"({flops / t['graph_ms'] / 1e9:.1f} TFLOP/s by the kernel in graph replay)")
        n4 = FLAGSHIP_X4["n_paths"]
        x4 = _time_gru_forward(rk, dev, rng, L, n4, d, u, dtype)
        x4_bound = bound(sum(_gru_bytes(L, n4, d, u, xs.element_size())),
                         2 * L * n4 * (d + u) * 3 * u, dtype)
        x4_plain = cuda_ms(lambda: rk.masked_gru_scan_plain(*x4["inputs"]), iters=3, warmup=1)
        print(f"    time at the x4 shape [{L},{n4},{d}]: kernel {fmt_times(x4['kernel'])}, "
              f"plain {x4_plain:.4f} ms, torch.nn.GRU {fmt_times(x4['library'])}, bound "
              f"{x4_bound[0]:.4f} ms by {x4_bound[1]}")
        out[dtype] = dict(max_abs_err=max(errs), **t, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=t_lib["ms"],
                          library_graph_ms=t_lib["graph_ms"], library_cold_ms=t_lib["cold_ms"],
                          instance=rk.forward_instance(dtype, u),
                          at_x4_shape=dict(**x4["kernel"], bound_ms=x4_bound[0],
                                           plain_ms=x4_plain, library_ms=x4["library"]["ms"],
                                           library_graph_ms=x4["library"]["graph_ms"],
                                           library_cold_ms=x4["library"]["cold_ms"]))
    return out


def time_gru_kernels(package_root: str) -> None:
    """Print the three times of kernels B and C of the `ignnition_tpu_torch`
    package under `package_root` at the flagship and x4 shapes (all lengths
    8), bf16 and f32. For holding two trees against each other on one card:
    unpack the other commit into a directory, then in one command run, once
    per tree and in turns (parent, change, change, parent),

        python3 -c "import chip_smoke as c; c.time_gru_kernels('DIR')"

    from the checkout whose timing method is to be used. `main` never calls
    it."""
    sys.path.insert(0, os.path.abspath(package_root))
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk

    dev, rng = torch.device("cuda", 0), np.random.default_rng(SEED)
    print(f"GRU kernels of {os.path.dirname(os.path.dirname(os.path.dirname(rk.__file__)))}")
    L, d, u = FLAGSHIP["path_len"], HS, HS
    for n in (FLAGSHIP["n_paths"], FLAGSHIP_X4["n_paths"]):
        for dtype in (torch.bfloat16, torch.float32):
            fwd = _time_gru_forward(rk, dev, rng, L, n, d, u, dtype, library=False)["kernel"]
            xs32, _, full, h032, p32, ct32 = _gru_inputs(dev, rng, L, n, d, u)
            args = (xs32.to(dtype), full, h032.to(dtype),
                    *(p32[k].to(dtype) for k in ("kernel", "recurrent_kernel", "bias")),
                    ct32.to(dtype))
            bwd = device_times(rk._launch_backward, rotations(args))
            print(f"  [{L},{n},{d}] u={u} {str(dtype)[6:]}: kernel B {fmt_times(fwd)}; "
                  f"kernel C {fmt_times(bwd)}")


def time_attention_kernels(package_root: str) -> None:
    """Print the three times of kernels D and E of the `ignnition_tpu_torch`
    package under `package_root` at the flagship's int8 incidence
    [1, 2048, 16384] (D=32, bf16 and f32) and over 4 graph blocks
    [4, 512, 4096] (bf16), the same inputs (seed 0) for every tree. Hold two
    trees against each other as `time_gru_kernels` says:

        python3 -c "import chip_smoke as c; c.time_attention_kernels('DIR')"

    `main` never calls it."""
    sys.path.insert(0, os.path.abspath(package_root))
    from ignnition_tpu_torch.ops import segment as seg
    from ignnition_tpu_torch.ops.cuda import attention_kernels as ak

    dev, rng = torch.device("cuda", 0), np.random.default_rng(SEED)
    print(f"attention kernels of "
          f"{os.path.dirname(os.path.dirname(os.path.dirname(ak.__file__)))}")
    size = FLAGSHIP
    flagship = incidence_of(make_sample(rng, **size), size["n_links"], size["n_paths"])
    blocks = np.stack([incidence_of(make_sample(rng, 512, 4096, 8), 512, 4096)
                       for _ in range(4)])
    cases = (("flagship", flagship[None], (torch.bfloat16, torch.float32)),
             ("4 graph blocks", blocks, (torch.bfloat16,)))
    for what, inc, dtypes in cases:
        g, bd, bs = inc.shape
        m = torch.from_numpy(inc).to(dev)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
        ssrc, sdst, x32, ct32 = f(g, bs), f(g, bd), f(g, bs, HS), f(g, bd, HS)
        stab = seg._flash_stab(ssrc, sdst)
        for dtype in dtypes:
            x, ct = x32.to(dtype), ct32.to(dtype)
            out, den = ak.flash_gat_forward(ssrc, sdst, x, m, stab)
            srow = (ct.float() * out.float()).sum(dim=2)
            t_fwd = device_times(ak.flash_gat_forward, rotations((ssrc, sdst, x, m, stab)))
            t_bwd = device_times(ak.flash_gat_backward,
                                 rotations((ssrc, sdst, x, m, stab, den, ct, srow)))
            print(f"  [{g},{bd},{bs}] D={HS} m int8 x {str(dtype)[6:]} ({what}, "
                  f"{np.count_nonzero(inc)} non-zeros): kernel D {fmt_times(t_fwd)}; "
                  f"kernel E {fmt_times(t_bwd)}")


def training_over_seeds(package_root: str, seeds: str = "0,1,2,3,4,5") -> None:
    """Print, for each parameter seed, the loss+reg of 5 flagship training
    steps on the kernel path in bf16 and in f32 (the same batch as phase 4,
    the `ignnition_tpu_torch` package under `package_root`) and whether the
    last lies below the first: how often that holds at random weights, tree
    against tree, run as `time_gru_kernels` says. `main` never calls it."""
    sys.path.insert(0, os.path.abspath(package_root))
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    arrays, meta = igt.build_batch([make_sample(np.random.default_rng(SEED + 1), **FLAGSHIP)],
                                   ir, padding, training=True)
    dev = torch.device("cuda", 0)
    print(f"training over seeds, the package of {os.path.abspath(package_root)}")
    for seed in (int(s) for s in seeds.split(",")):
        runs = []
        for dtype in (torch.bfloat16, None):
            trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=dtype, device=dev)
            state = trainer.init_state(torch.Generator().manual_seed(seed))
            batch, step = to_device(arrays, dev), trainer.train_step_fn(meta)
            totals = [float(step(state, batch)[1]["total"]) for _ in range(TRAIN_STEPS["flagship"])]
            runs.append(f"{'bf16' if dtype else 'f32'} " + " ".join(f"{t:.4f}" for t in totals)
                        + (" (falls)" if totals[-1] < totals[0] else " (ends higher)"))
        print(f"  seed {seed}: " + "; ".join(runs))


def time_flagship_step(package_root: str) -> dict:
    """Print the flagship's bf16 training step and serving forward (medians
    of 20, CUDA events, after 3 warm calls) and the host time of one call of
    each kernel entry that the step calls (mean of 200 calls at a tiny shape,
    host clock, the device synchronized once at the end; without gradients
    as in serving, and with inputs that ask for them, the forward only, as
    in a step) of the `ignnition_tpu_torch` package under `package_root`:
    what a kernel call's Python dispatch costs, tree against tree, run as
    `time_gru_kernels` says or through `time_flagship_turns`. The last line
    printed is the numbers as JSON. `main` never calls it."""
    sys.path.insert(0, os.path.abspath(package_root))
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    arrays, meta = igt.build_batch([make_sample(np.random.default_rng(SEED + 1), **FLAGSHIP)],
                                   ir, padding, training=True)
    dev = torch.device("cuda", 0)
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    batch, step = to_device(arrays, dev), trainer.train_step_fn(meta)
    server = igt.ServingModel(igt.build(ir), state.params, meta, ir, device=dev)
    inputs = to_device({k: v for k, v in arrays.items() if k not in ("label", "label_mask")},
                       dev)

    def median_ms(fn):
        times = []
        for i in range(23):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        return float(np.median(times))

    step_ms = median_ms(lambda: step(state, batch))
    fwd_ms = median_ms(lambda: server.forward_device(inputs))
    f = lambda *s: torch.ones(s, device=dev, dtype=torch.bfloat16)
    row_ptr = torch.arange(0, 66, 2, device=dev, dtype=torch.int32)
    lens = torch.full((32,), 2, device=dev, dtype=torch.int32)
    params = {"kernel": f(32, 96), "recurrent_kernel": f(32, 96), "bias": f(2, 96)}
    x_a, x_b, h0 = f(64, 32), f(2, 32, 32), f(32, 32)
    g_a, g_b, g_h0 = (t.clone().requires_grad_() for t in (x_a, x_b, h0))
    g_params = {k: v.clone().requires_grad_() for k, v in params.items()}
    calls = {"kernel A": (False, lambda: sk.sorted_segment_sum_csr(x_a, row_ptr)),
             "kernel B": (False, lambda: rk.masked_gru_scan(x_b, lens, h0, params)),
             "kernel A, grad": (True, lambda: sk.sorted_segment_sum_csr(g_a, row_ptr)),
             "kernel B, grad": (True, lambda: rk.masked_gru_scan(g_b, lens, g_h0, g_params))}
    host = {}
    for what, (grad, fn) in calls.items():
        with torch.set_grad_enabled(grad):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host[what] = (time.perf_counter() - t0) / 200 * 1e3
            torch.cuda.synchronize()
    print(f"flagship of {os.path.abspath(package_root)}: bf16 training step median "
          f"{step_ms:.3f} ms, serving forward median {fwd_ms:.3f} ms (20 each, CUDA events); "
          f"host per call at a tiny shape: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                                        host.items()))
    out = dict(step_ms=step_ms, forward_ms=fwd_ms, host_ms=host)
    print(json.dumps(out))
    return out


def time_flagship_turns(roots, rounds: int = 10) -> None:
    """`time_flagship_step` of each package root in its own process, in turns
    (the roots' order reversed every other round, so that each takes each
    place as often), `rounds` times; prints each root's median and quartiles
    of every number. One card; run from the checkout whose timing method is
    to be used:

        python3 -c "import chip_smoke as c; c.time_flagship_turns(['P', 'C'])"

    `main` never calls it."""
    here = os.path.dirname(os.path.abspath(__file__))
    got = {r: [] for r in roots}
    for k in range(rounds):
        for root in (roots if k % 2 == 0 else roots[::-1]):
            run = subprocess.run(
                [sys.executable, "-c",
                 f"import chip_smoke as c; c.time_flagship_step({os.path.abspath(root)!r})"],
                cwd=here, capture_output=True, text=True, timeout=600, check=True)
            got[root].append(json.loads(run.stdout.strip().splitlines()[-1]))
            print(f"round {k + 1} {root}: {run.stdout.strip().splitlines()[-2]}", flush=True)
    for root, runs in got.items():
        series = {"step_ms": [r["step_ms"] for r in runs],
                  "forward_ms": [r["forward_ms"] for r in runs]}
        for what in runs[0]["host_ms"]:
            series[f"host ms, {what}"] = [r["host_ms"][what] for r in runs]
        print(f"{root}, {len(runs)} processes: " + "; ".join(
            f"{k} median {float(np.median(v))!r} (quartiles {float(np.percentile(v, 25))!r} - "
            f"{float(np.percentile(v, 75))!r}, all {v!r})" for k, v in series.items()), flush=True)


def _gru_plain_f64(xs, lens, h0, params):
    """`masked_gru_scan_plain` with f64 sums and gates (the carry still
    rounded to xs's dtype before each product, as the contract says)."""
    dtype, f64 = xs.dtype, torch.float64
    wx, wh, b = (params[k].to(dtype).to(f64) for k in ("kernel", "recurrent_kernel", "bias"))
    u = h0.shape[1]
    h = h0.to(dtype).to(f64)
    for t in range(xs.shape[0]):
        xw = xs[t].to(f64) @ wx + b[0]
        hw = h.to(dtype).to(f64) @ wh + b[1]
        z = torch.sigmoid(xw[:, :u] + hw[:, :u])
        r = torch.sigmoid(xw[:, u:2 * u] + hw[:, u:2 * u])
        h_new = z * h + (1.0 - z) * torch.tanh(xw[:, 2 * u:] + r * hw[:, 2 * u:])
        h = torch.where((lens > t)[:, None], h_new, h)
    return h.to(dtype)


def gru_rounding_spread() -> None:
    """Kernel B in bf16 and three references at shapes of the `cuda` test
    (its inputs: seed 9, N(0, 1) xs and h0, N(0, 0.25) weights): the plain
    version on the card, the plain version on the CPU (f32 sums in another
    order) and with f64 sums and gates. Prints the largest difference of each
    pair: the spread that the bf16 limit (3e-2) has to cover. `main` never
    calls it."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk

    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    for L, n, d, u in ((8, 16384, 32, 32), (8, 1000, 20, 48), (8, 1000, 32, 64),
                       (8, 1000, 32, 128)):
        rng = np.random.default_rng(9)
        f = lambda *s, scale=1.0: torch.from_numpy(
            (scale * rng.standard_normal(s)).astype(np.float32)).to(bf16)
        xs, h0 = f(L, n, d), f(n, u)
        lens = torch.from_numpy(rng.integers(0, L + 1, n).astype(np.int32))
        lens[:2] = torch.tensor([0, L])
        p = {"kernel": f(d, 3 * u, scale=0.5), "recurrent_kernel": f(u, 3 * u, scale=0.5),
             "bias": f(2, 3 * u, scale=0.1)}
        card = (xs.to(dev), lens.to(dev), h0.to(dev), {k: v.to(dev) for k, v in p.items()})
        outs = {"kernel": rk.masked_gru_scan(*card),
                "plain (card)": rk.masked_gru_scan_plain(*card),
                "plain (CPU)": rk.masked_gru_scan_plain(xs, lens, h0, p),
                "plain f64": _gru_plain_f64(xs, lens, h0, p)}
        outs = {k: v.float().cpu() for k, v in outs.items()}
        names = list(outs)
        pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
        print(f"  kernel B bf16 [{L},{n},{d}] u={u}, max abs difference: " + "; ".join(
            f"{a} - {b} {float((outs[a] - outs[b]).abs().max()):.4e}" for a, b in pairs))


GRAD_NAMES = ("d_xs", "d_h0", "d_kernel", "d_recurrent_kernel", "d_bias")


C_PARTS = (("sweep", "gru_bwd_sweep"), ("weight gradients", "gru_bwd_wgrad"),
           ("finalize", "gru_bwd_finalize"))


def _c_ran(rk, args) -> tuple:
    """(the sweep instance of kernel C that served a call on `args`, in
    `backward_instance`'s terms, as torch.profiler named the kernel; device
    ms a call of the sweep, weight-gradient and finalize kernels, 5 calls)."""
    per_kernel, _ = device_time_by_kernel(lambda: rk._launch_backward(*args),
                                          want=tuple(key for _, key in C_PARTS))
    ran = {rk.profiled_backward_instance(k) for k in per_kernel if "gru_bwd_sweep" in k}
    if len(ran) != 1:
        raise AssertionError(f"the profiler saw kernel C sweeps {sorted(ran)} in one call "
                             f"(kernels {sorted(per_kernel)})")
    split = {part: sum(ms for k, ms in per_kernel.items() if key in k) for part, key in C_PARTS}
    return ran.pop(), split


def check_gru_scan_bwd(dev, rng) -> dict:
    """Kernel C through `masked_gru_scan`'s autograd against the gradients of
    the plain version, at random lengths 0..L and at full lengths, each call
    twice and compared bitwise; the sweep instance that the profiler saw
    against `backward_instance`'s rule, and the device time of C's three
    kernels; C's times at the flagship and x4 shapes beside cuDNN's GRU
    backward and the bound."""
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk

    L, n, d, u = FLAGSHIP["path_len"], FLAGSHIP["n_paths"], HS, HS
    xs32, lens, full, h032, p32, ct32 = _gru_inputs(dev, rng, L, n, d, u)
    names = ("kernel", "recurrent_kernel", "bias")
    print(f"  kernel C kernels, ptxas: {_c_ptxas()}")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        xs, h0, ct = xs32.to(dtype), h032.to(dtype), ct32.to(dtype)
        p = {k: v.to(dtype) for k, v in p32.items()}
        reference = (rk.masked_gru_scan_bwd_kernel_plain if dtype == torch.bfloat16
                     else rk.masked_gru_scan_bwd_plain)
        err = max(_hold_c(rk, xs, ln, h0, p, ct, f"[{L},{n},{d}] u={u}, {which}")
                  for which, ln in (("random lengths", lens), ("full lengths", full)))
        wx, wh, b = (p[k].contiguous() for k in names)
        args = (xs, full, h0, wx, wh, b, ct)
        instance = rk.backward_instance(dtype, u)
        ran, split = _c_ran(rk, args)
        print(f"  kernel C sweep instance for {str(dtype)[6:]} u={u}: {ran} ran (profiler), the "
              f"rule says {instance}; device ms a call (torch.profiler, 5 calls): "
              + ", ".join(f"{part} {ms:.4f}" for part, ms in split.items()))
        if ran != instance:
            raise AssertionError(f"kernel C ran the {ran} sweep for {dtype} u={u}, the rule "
                                 f"says {instance}")
        t = device_times(rk._launch_backward, rotations(args))
        plain_ms = cuda_ms(lambda: reference(xs, full, h0, p, ct), iters=5)
        t_lib = _time_library_gru_backward(p, d, u, dtype, dev, xs, h0, ct)
        library_ms = t_lib["ms"]
        bound_ms, bound_by = _c_bound(L, n, d, u, dtype)
        print(f"    time at full lengths: kernel {fmt_times(t)}, plain {plain_ms:.4f} ms, "
              f"torch.nn.GRU backward {fmt_times(t_lib)}, bound {bound_ms:.4f} ms by "
              f"{bound_by} ({_c_flops(L, n, d, u) / t['graph_ms'] / 1e9:.1f} TFLOP/s by the "
              f"kernel in graph replay)")
        n4 = FLAGSHIP_X4["n_paths"]
        xs4, _, full4, h04, p4, ct4 = _gru_inputs(dev, rng, L, n4, d, u)
        args4 = (xs4.to(dtype), full4, h04.to(dtype),
                 *(p4[k].to(dtype) for k in names), ct4.to(dtype))
        t4 = device_times(rk._launch_backward, rotations(args4))
        _, split4 = _c_ran(rk, args4)
        bound4 = _c_bound(L, n4, d, u, dtype)
        p4_cast = dict(zip(names, args4[3:6]))
        t4_lib = _time_library_gru_backward(p4_cast, d, u, dtype, dev, args4[0], args4[2],
                                            args4[6])
        plain4 = cuda_ms(lambda: reference(args4[0], full4, args4[2], p4_cast, args4[6]),
                         iters=3, warmup=1)
        print(f"    time at the x4 shape [{L},{n4},{d}]: kernel {fmt_times(t4)}, plain "
              f"{plain4:.4f} ms, torch.nn.GRU backward {fmt_times(t4_lib)}, bound "
              f"{bound4[0]:.4f} ms by "
              f"{bound4[1]}; device ms a call: "
              + ", ".join(f"{part} {ms:.4f}" for part, ms in split4.items()))
        out[dtype] = dict(max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms,
                          library_graph_ms=t_lib["graph_ms"], library_cold_ms=t_lib["cold_ms"],
                          instance=ran, device_ms_by_kernel=split,
                          at_x4_shape=dict(**t4, bound_ms=bound4[0], device_ms_by_kernel=split4,
                                           plain_ms=plain4, library_ms=t4_lib["ms"],
                                           library_graph_ms=t4_lib["graph_ms"],
                                           library_cold_ms=t4_lib["cold_ms"]))
    return out


def _time_library_gru_backward(p, d, u, dtype, dev, xs, h0, ct) -> dict:
    """The three times of `torch.nn.GRU`'s backward (cuDNN) through its final
    state, holding the Keras params `p`, at the inputs of kernel C: a
    yardstick, never on the port's path."""
    gru = _library_gru(p, d, u, dtype, dev)

    def library_forward(x, h, c):
        # on the capture stream, so that the backward's kernels run there
        x_lib, h_lib = x.clone().requires_grad_(True), h.clone().requires_grad_(True)
        return gru(x_lib, h_lib)[1][0], [x_lib, h_lib, *gru.parameters()], c

    side_stream().wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side_stream()):
        lib_sets = [library_forward(*a) for a in rotations((xs, h0[None], ct))]
    torch.cuda.synchronize()
    return device_times(
        lambda h_n, leaves, c: torch.autograd.grad(h_n, leaves, c, retain_graph=True),
        lib_sets, guarded=True, what="torch.nn.GRU backward")


def _c_flops(L, n, d, u) -> int:
    """Kernel C's operations: the recompute, the transposed products and the
    weight gradients, each 2 L n (d + u) 3u."""
    return 3 * 2 * L * n * (d + u) * 3 * u


def _c_bound(L, n, d, u, dtype) -> tuple:
    """Kernel C's bound: read the inputs and ct; write d_xs, d_h0 and the f32
    weight gradients."""
    es = torch.tensor([], dtype=dtype).element_size()
    in_bytes, state_bytes = _gru_bytes(L, n, d, u, es)
    n_bytes = in_bytes + state_bytes + L * n * d * es + n * u * 4 + (d + u + 2) * 3 * u * 4
    return bound(n_bytes, _c_flops(L, n, d, u), dtype)


def incidence_of(sample, n_links: int, n_paths: int) -> np.ndarray:
    """The int8 multiplicity matrix [links, paths] of a sample's path -> link
    edges, as `build_batch` stores it."""
    adj = sample.adjacencies["adj_paths_links"]
    m = np.zeros((n_links, n_paths), np.int32)
    np.add.at(m, (adj.dst_idx, adj.src_idx), 1)
    if m.max() > 127:
        raise AssertionError("a multiplicity above 127 does not fit int8")
    return m.astype(np.int8)


def _d_ptxas() -> str:
    """Every instance of kernel D (each template instantiation)."""
    return _ptxas_of("kernel D", r"flash_gat_fwd_kernelI\w*?E(?=Ev)")


def _e_ptxas() -> str:
    """Both kernels of kernel E: every instance of the strip kernel and the
    row-sum kernel."""
    return _ptxas_of("kernel E", r"flash_gat_bwd_(?:strip|rowsum)_kernel(?:I\w*?E(?=Ev))?")


def _ran(what: str, call, args, design: list, pattern: str, calls: int = 5) -> dict:
    """{`__global__` name: device ms a call} of `calls` calls of `call(*args)`
    by torch.profiler. Raises unless each kernel of `design` ran exactly
    `calls` times and nothing else ran. The profiler has missed the first
    kernel of a profile now and then, so a short sleep kernel opens each
    profile; a profile still short of a record is taken again whole, up to
    6 times a second apart (three profiles in a row have come back without
    any device activity), and one with a launch too many fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call(*args)
    torch.cuda.synchronize()
    for attempt in range(6):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)  # the profile's first kernel, not counted
            torch.cuda.synchronize()
            for _ in range(calls):
                call(*args)
            torch.cuda.synchronize()
        count, ms = {}, {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or "spin_kernel" in e.name:
                continue
            found = re.search(pattern, e.name)
            k = e.name if found is None else found.group(0)
            count[k] = count.get(k, 0) + 1
            ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
        if sorted(count) == sorted(design) and all(n == calls for n in count.values()):
            return ms
        if any(k not in design or n > calls for k, n in count.items()):
            break
    raise AssertionError(f"{calls} calls of {what} made device launches {count}; the design "
                         f"makes {calls} of each of {design}")


def _d_ran(ak, args, calls: int = 5) -> dict:
    """Kernel D's device ms a call by torch.profiler; raises unless each call
    made exactly one device launch, of `flash_gat_fwd_kernel`."""
    return _ran("kernel D", ak.flash_gat_forward, args, ["flash_gat_fwd_kernel"],
                r"flash_gat_fwd_kernel", calls)


def _e_ran(ak, args, calls: int = 5) -> dict:
    """Kernel E's device ms a call by kernel; raises unless the strip kernel
    and the row sums each ran once a call (the `BWD_LAUNCHES_PER_CALL`
    device launches) and nothing else ran."""
    design = ["flash_gat_bwd_rowsum_kernel", "flash_gat_bwd_strip_kernel"]
    if len(design) != ak.BWD_LAUNCHES_PER_CALL:
        raise AssertionError(f"kernel E makes {ak.BWD_LAUNCHES_PER_CALL} launches a call, "
                             f"this check knows {design}")
    return _ran("kernel E", ak.flash_gat_backward, args, design, r"flash_gat_bwd_\w+_kernel",
                calls)


def _print_e_lists(ak, blocks: np.ndarray, d: int, x_dtype, m_dtype) -> None:
    """Print the non-zeros kernel E's list holds (`bwd_layout`, from the CUDA
    source) beside those of each strip of `blocks` [G, bd, bs]: a strip
    with more than the list holds handles it more than once."""
    g, bd, bs = blocks.shape
    strips, cap = ak.bwd_layout(bs, d, x_dtype, m_dtype)
    w = 64 // torch.empty((), dtype=m_dtype).element_size()  # kStripBytes / item size
    if -(-bs // w) != strips:
        raise AssertionError(f"kernel E has {strips} strips of {bs} columns, not {-(-bs // w)}")
    padded = np.zeros((g, bd, strips * w), bool)
    padded[:, :, :bs] = blocks != 0
    per_strip = padded.reshape(g, bd, strips, w).sum(axis=(1, 3))
    print(f"    kernel E list: {cap} non-zeros (x {str(x_dtype)[6:]}, D={d}); a strip's "
          f"non-zeros mean {per_strip.mean():.1f}, largest {per_strip.max()}; "
          f"{int((per_strip > cap).sum())} of {per_strip.size} strips fill it more than once")


def check_flash_gat(dev, rng, what: str, blocks: np.ndarray, d: int, x_dtypes, m_dtype,
                    timed: bool, profiled: bool = True) -> dict:
    """Kernels D and E on `blocks` [G, bd, bs] at width d against their plain
    versions, through the wrappers; E twice, compared bitwise. `profiled`:
    torch.profiler also holds each call to its design's device launches."""
    from ignnition_tpu_torch.ops import segment as seg
    from ignnition_tpu_torch.ops.cuda import attention_kernels as ak

    g, bd, bs = blocks.shape
    nnz = int(np.count_nonzero(blocks))
    m = torch.from_numpy(blocks).to(dev).to(m_dtype)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    ssrc, sdst, x32, ct32 = f(g, bs), f(g, bd), f(g, bs, d), f(g, bd, d)
    stab = seg._flash_stab(ssrc, sdst)
    fwd, bwd = {}, {}
    for dtype in x_dtypes:
        name = f"[{g},{bd},{bs}] D={d} m {str(m_dtype)[6:]} x {str(dtype)[6:]} ({what})"
        x, ct = x32.to(dtype), ct32.to(dtype)
        before = (ak.fwd_launch_count, ak.bwd_launch_count)
        out, den = ak.flash_gat_forward(ssrc, sdst, x, m, stab)
        srow = (ct.float() * out.float()).sum(dim=2)
        got = ak.flash_gat_backward(ssrc, sdst, x, m, stab, den, ct, srow)
        again = ak.flash_gat_backward(ssrc, sdst, x, m, stab, den, ct, srow)
        torch.cuda.synchronize()
        if (ak.fwd_launch_count, ak.bwd_launch_count) != (before[0] + 1, before[1] + 2):
            raise AssertionError("the wrappers did not launch kernels D and E")
        if out.dtype != dtype or den.dtype != torch.float32:
            raise AssertionError(f"kernel D returned {out.dtype}, {den.dtype}")
        for a, b, which in zip(got, again, ("dtab_plus", "d_sdst")):
            if not torch.equal(a, b):
                raise AssertionError(f"kernel E {which} differs between two runs")
        e_kernels = None
        if profiled:
            d_ms = _d_ran(ak, (ssrc, sdst, x, m, stab))["flash_gat_fwd_kernel"]
            print(f"  kernel D {name}: one device launch a call, {d_ms:.4f} device ms "
                  f"(torch.profiler, 5 calls)")
            e_kernels = _e_ran(ak, (ssrc, sdst, x, m, stab, den, ct, srow))
            print(f"  kernel E {name}: device ms a call by kernel (torch.profiler, 5 calls): "
                  + ", ".join(f"{k} {ms:.4f}" for k, ms in e_kernels.items()))
        _print_e_lists(ak, blocks, d, dtype, m_dtype)
        w_out, w_den = ak.flash_gat_forward_plain(ssrc, sdst, x, m, stab)
        want = ak.flash_gat_backward_plain(ssrc, sdst, x, m, stab, den, ct, srow)
        bf16 = dtype == torch.bfloat16
        # bf16: the f32 sums differ in their order, so the rounding of out to
        # bf16 may flip by one ulp, at most 2**-7 of the value
        atol, rtol = (1e-4, 2.0**-7) if bf16 else (1e-5, 1e-5)
        err = compare(f"kernel D out {name}", out, w_out, atol=atol, rtol=rtol,
                      why="one bf16 ulp of the rounded output" if bf16
                      else "f32 sums of a row's entries in another order")
        compare(f"kernel D den {name}", den, w_den, atol=1e-6, rtol=1e-5,
                why="f32 sums in another order")
        if bool((den == 0).any()) and bool(out[den == 0].any()):
            raise AssertionError("a row without support is not exactly 0")
        err_b = 0.0
        for which, a, w in zip(("dtab_plus", "d_sdst"), got, want):
            top = float(w.abs().max())
            if bf16:
                # an f32 ulp in a = z / den can flip a's bf16 rounding, 2**-8 of
                # one term: such entries are few and stay within 2**-7 of the
                # output's largest entry
                off = float(((a - w).abs() > 1e-5 * top + 1e-4 * w.abs()).float().mean())
                print(f"    kernel E {which}: {off:.2e} of the entries beyond the f32 limit "
                      f"(flips of a's bf16 rounding; at most 1e-4 of them may be)")
                if off > 1e-4:
                    raise AssertionError(f"kernel E {which}: too many entries off")
            err_b = max(err_b, compare(
                f"kernel E {which} {name}, bitwise repeatable", a, w,
                atol=(2.0**-7 if bf16 else 1e-5) * top, rtol=1e-4,
                why="rare flips of a's bf16 rounding" if bf16
                else "f32 sums in another order; 1e-5 of the largest entry"))
        if not timed:
            continue
        es, ms_ = x.element_size(), m.element_size()
        vectors = 4 * g * (bs + 3 * bd)
        fwd_bytes = g * bd * bs * ms_ + g * bs * d * es + vectors + g * bd * (d * es + 4)
        bwd_bytes = (g * bd * bs * ms_ + g * (bs + bd) * d * es + vectors + 8 * g * bd
                     + 4 * g * (bs * (d + 1) + bd))
        # operations of this run's data: only the non-zero entries do work
        fwd_bound = bound(fwd_bytes, nnz * (2 * d + 8), dtype)
        bwd_bound = bound(bwd_bytes, nnz * (6 * d + 16), dtype)
        t_fwd = device_times(ak.flash_gat_forward, rotations((ssrc, sdst, x, m, stab)))
        t_bwd = device_times(ak.flash_gat_backward,
                             rotations((ssrc, sdst, x, m, stab, den, ct, srow)))
        fwd_plain = cuda_ms(lambda: ak.flash_gat_forward_plain(ssrc, sdst, x, m, stab),
                            iters=5, warmup=1)
        bwd_plain = cuda_ms(
            lambda: ak.flash_gat_backward_plain(ssrc, sdst, x, m, stab, den, ct, srow),
            iters=5, warmup=1)
        # the matrix-materializing route with library products (never on the
        # port's path): no single PyTorch call computes this function
        leaves = [ssrc[0].clone().requires_grad_(True), sdst[0].clone().requires_grad_(True),
                  x[0].clone().requires_grad_(True)]
        dense_fwd = cuda_ms(lambda: seg._blocks_masked_softmax_matmul(
            ssrc.reshape(-1), sdst.reshape(-1), x.reshape(g * bs, d), m), iters=5, warmup=1)
        if g == 1:
            routed = seg._dense_masked_softmax_matmul(*leaves, m[0])
            dense_bwd = cuda_ms(lambda: torch.autograd.grad(
                routed, leaves, ct[0], retain_graph=True), iters=5, warmup=1)
        else:
            dense_bwd = None
        print(f"    time {name}: D {fmt_times(t_fwd)} (plain {fwd_plain:.3f}, materializing "
              f"route {dense_fwd:.3f}, bound {fwd_bound[0]:.4f} by {fwd_bound[1]}, "
              f"{fwd_bytes / t_fwd['cold_ms'] / 1e6:.0f} GB/s cold); E {fmt_times(t_bwd)} (plain "
              f"{bwd_plain:.3f}, materializing route "
              f"{'-' if dense_bwd is None else format(dense_bwd, '.3f')}, bound "
              f"{bwd_bound[0]:.4f} by {bwd_bound[1]}); {nnz} non-zeros of {g * bd * bs}")
        none = dict(library_ms=None, library_graph_ms=None, library_cold_ms=None)
        fwd[dtype] = dict(max_abs_err=err, **t_fwd, plain_ms=fwd_plain,
                          bound_ms=fwd_bound[0], bound_by=fwd_bound[1], **none,
                          materializing_route_ms=dense_fwd)
        bwd[dtype] = dict(max_abs_err=err_b, **t_bwd, plain_ms=bwd_plain,
                          bound_ms=bwd_bound[0], bound_by=bwd_bound[1], **none,
                          materializing_route_ms=dense_bwd, device_ms_by_kernel=e_kernels)
    return dict(fwd=fwd, bwd=bwd)


def check_attention_kernels(dev, rng) -> dict:
    """Kernels D and E at the flagship's [2048, 16384] int8 incidence (D=32,
    bf16 and f32), with a bf16 incidence, over 4 graph blocks of the
    `blocks_g4` size, at a shape the TPU tiles would refuse, and at a small
    graph's [256, 2048] (bf16, timed beside the materializing route)."""
    print(f"  kernel D, ptxas: {_d_ptxas()}")
    print(f"  kernel E kernels, ptxas: {_e_ptxas()}")
    both = (torch.bfloat16, torch.float32)
    size = FLAGSHIP
    m = incidence_of(make_sample(rng, **size), size["n_links"], size["n_paths"])
    main = check_flash_gat(dev, rng, "flagship stage 2", m[None], HS, both, torch.int8, True)
    check_flash_gat(dev, rng, "bf16 incidence", m[None], HS, (torch.bfloat16,),
                    torch.bfloat16, False)
    blocks = np.stack([incidence_of(make_sample(rng, 512, 4096, 8), 512, 4096)
                       for _ in range(4)])
    main["blocks"] = check_flash_gat(dev, rng, "4 graph blocks", blocks, HS,
                                     (torch.bfloat16,), torch.int8, True)
    ragged = incidence_of(make_sample(rng, 1003, 5001, 8), 1003, 5001)
    check_flash_gat(dev, rng, "ragged, unaligned rows", ragged[None], 48, both,
                    torch.int8, False)
    check_flash_gat(dev, rng, "ragged, bf16 incidence", ragged[None], 48,
                    (torch.float32,), torch.bfloat16, False)
    # a small graph (256 links, 2,048 paths): where D and E stand against the
    # materializing route when the matrix is small
    small = incidence_of(make_sample(rng, 256, 2048, 8), 256, 2048)
    main["small"] = check_flash_gat(dev, rng, "small graph", small[None], HS,
                                    (torch.bfloat16,), torch.int8, True)
    return main


# --------------------------------------------------------------------------
# phase 3: serving
# --------------------------------------------------------------------------


def serve(dev, card: str) -> dict:
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.data.graph import merge_metas

    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)

    sizes = {"flagship": FLAGSHIP, "flagship_x4": FLAGSHIP_X4}
    requests = []  # (size name, sample)
    servers = {}
    t0 = time.perf_counter()
    for name, size in sizes.items():
        count = N_FLAGSHIP_REQUESTS if name == "flagship" else 1
        samples = [make_sample(rng, **size) for _ in range(count)]
        # the served shapes: padded to fit every request of this size
        meta = merge_metas(
            [igt.build_batch([s], ir, padding, training=False)[1] for s in samples]
        )
        servers[name] = igt.ServingModel(
            igt.build(ir), params, meta, ir, compute_dtype=torch.bfloat16, device=dev
        )
        requests += [(name, s) for s in samples]
    print(f"[serve] {len(requests)} requests made and servers set up in "
          f"{time.perf_counter() - t0:.1f} s (host)")

    # ---- the main path: answer every request, counting kernel launches ----
    # (the first request of a size runs eagerly, the second captures the
    # forward, the third replays it: each request's hold reads `held()`, the
    # counters over the capture for a replay; the main path's counts are the
    # wrappers', `read()`)
    counts = Counts()
    counts.reset()
    answers = []
    for name, sample in requests:
        before = counts.held()
        preds = servers[name].predict_samples([sample])
        now = counts.held()
        da = now["csr_segment_sum"] - before["csr_segment_sum"]
        db = now["masked_gru_scan"] - before["masked_gru_scan"]
        n_paths = sample.num_nodes["path"]
        if preds.shape != (n_paths,) or not np.all(np.isfinite(preds)):
            raise AssertionError(
                f"{name}: predictions of shape {preds.shape} (want ({n_paths},)) "
                f"or non-finite")
        want_a = ITERATIONS if name == "flagship_x4" else 0
        print(f"  request {name}: {n_paths} predictions, finite, "
              f"mean {preds.mean():.5f}; launches kernel A +{da}, kernel B +{db}")
        if db != ITERATIONS or da != want_a:
            raise AssertionError(
                f"{name}: expected kernel A +{want_a} and kernel B +{ITERATIONS} "
                f"launches per forward, got +{da} and +{db}")
        answers.append(preds)
    now = counts.read()
    launches = {"csr_segment_sum": now["csr_segment_sum"],
                "masked_gru_scan": now["masked_gru_scan"]}
    print(f"[serve] main path launch counts: kernel A {launches['csr_segment_sum']}, "
          f"kernel B {launches['masked_gru_scan']}")
    if min(launches.values()) == 0:
        raise AssertionError("a kernel of the main path was never launched")

    # ---- kernel path vs plain path (the same model on the CPU) ----
    for name in sizes:
        sample = next(s for n, s in requests if n == name)
        kernels_vs_plain_forward(name, servers[name], ir, params, sample, dev,
                                 (None, torch.bfloat16))

    # ---- latency ----
    latency = {}
    for name in sizes:
        server = servers[name]
        sample = next(s for n, s in requests if n == name)
        arrays = server.build_batch([sample])
        inputs = {k: v for k, v in arrays.items() if k not in ("label", "label_mask")}
        fwd = forward_ms(server, to_device(inputs, dev))
        e2e = []
        for i in range(6):
            t1 = time.perf_counter()
            server.predict_samples([sample])
            if i >= 1:
                e2e.append((time.perf_counter() - t1) * 1e3)
        latency[name] = dict(forward_ms=float(np.median(fwd)), request_ms=float(np.median(e2e)))
        print(f"[latency] {name}: device forward median {np.median(fwd):.3f} ms "
              f"(min {min(fwd):.3f}, max {max(fwd):.3f}, 20 runs, CUDA events); "
              f"whole request (build_batch + copy + forward + trim) median "
              f"{np.median(e2e):.1f} ms (5 runs, host clock) on {card}")
        latency[name].update(build_batch_ms(name, lambda: server.build_batch([sample]), card))

        # ---- where the device time goes ----
        dev_batch = to_device(inputs, dev)
        latency[name].update(print_profile(
            f"{name} forward", lambda: server.forward_device(dev_batch),
            latency[name]["forward_ms"]))
    return dict(launches=launches, latency=latency)


# --------------------------------------------------------------------------
# phase 4: training
# --------------------------------------------------------------------------

def step0_gradients_vs_plain(name, ir, padding, arrays, meta, state, batch, noise=0.0):
    """Hold the loss and every gradient leaf of the kernel path (the card) to
    the plain path (the same model and batch on the CPU) in f32, before any
    step. Returns the initial parameters as a CPU tree, the CPU state and the
    CPU gradients by name."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params, map_params

    init_tree = map_params(lambda v: v.detach().cpu().clone(), state.params)
    f32_card = igt.Trainer(igt.build(ir), padding, compute_dtype=None)
    g_card, m_card = f32_card.grads_fn(meta)(state.params, batch)
    f32_cpu = igt.Trainer(igt.build(ir), padding, compute_dtype=None, device="cpu")
    cpu_state = f32_cpu.init_state(params=init_tree)
    t1 = time.perf_counter()
    g_cpu, m_cpu = f32_cpu.grads_fn(meta)(cpu_state.params, to_device(arrays, "cpu"))
    cpu_s = time.perf_counter() - t1
    compare(f"{name} step-0 loss, kernels vs plain (CPU, {cpu_s:.1f} s) f32",
            m_card["total"], m_cpu["total"], atol=1e-4, rtol=1e-4,
            why="f32 sums in another order on each device")
    want = flatten_params(g_cpu)
    for k, g in flatten_params(g_card).items():
        top = float(want[k].abs().max())
        compare(f"{name} step-0 gradient {k} (largest entry {top:.3e})", g, want[k],
                atol=1e-4 * top + noise, rtol=1e-3,
                why="f32 sums over up to 131,072 rows in another order; 1e-4 of the "
                    "leaf's largest entry" + (f" and {noise:g} of f32 noise" if noise else ""))
    return init_tree, cpu_state, want


def time_training_step(name, step, state, batch, arrays, card, edge_messages=None,
                       input_copies: int = 0) -> dict:
    """Median of 20 steps after 3 (CUDA events), edge-messages per second,
    peak device memory and the profile of one step by kernel.
    `edge_messages`: a step's messages, by default `ITERATIONS` times the
    real edges of every adjacency (each read by one pass). `input_copies`:
    the copies into its graph's static buffers that a replayed step begins
    with (`CapturedStep.input_copies`), which an eager step does not make."""
    times = []
    for i in range(3 + 20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    step_ms = float(np.median(times))
    edges = sum(int(np.sum(v > 0)) for k, v in arrays.items() if k.startswith("edge_mask_"))
    messages = ITERATIONS * edges if edge_messages is None else edge_messages
    rate = messages / (step_ms / 1e3)
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[train] {name}: step median {step_ms:.3f} ms (min {min(times):.3f}, max "
          f"{max(times):.3f}, 20 steps after 3, CUDA events), {rate / 1e6:.1f} M "
          f"edge-messages/s ({messages} a step), peak device "
          f"memory {peak:.0f} MiB, bf16 compute, on {card}")
    out = dict(step_ms=step_ms, edge_messages_per_s=rate, peak_mib=peak)
    out.update(print_profile(f"{name} training step", lambda: step(state, batch), step_ms))
    earlier = EARLIER_LAUNCHES_PER_STEP.get(name)
    if earlier and "kernels_per_call" in out:
        # the earlier count is an eager step's device activities: the
        # replay's copies of its inputs into the graph's buffers are left out
        kernels = out["kernels_per_call"] - input_copies
        print(f"    {out['kernels_per_call']:.0f} device activities per step, "
              f"{kernels:.0f} of them the step's own (less {input_copies} input copies of "
              f"the replay); {earlier} with one kernel-A launch per slice-sort window")
        if name == "flagship_x4" and not kernels < earlier:
            raise AssertionError(f"{name}: the step's launches did not fall below {earlier}")
    return out


def bf16_losses_vs_plain(name, ir, padding, arrays, meta, snapshots, totals) -> None:
    """Hold the loss of every bf16 step of the kernel path to the plain
    path's at the same parameters (`snapshots`, taken before each step; the
    same model and batch on the CPU, bf16 compute)."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    cpu = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16, device="cpu")
    batch = to_device(arrays, "cpu")
    with torch.no_grad():
        want = [cpu._loss(params, batch, meta)[0] for params in snapshots]
    compare(f"{name} loss+reg of each of {len(totals)} bf16 steps, kernels vs plain (CPU) "
            f"at the step's parameters", torch.tensor(totals), torch.stack(want),
            atol=3e-2, rtol=0.0,
            why="bf16 roundings fall differently on the two paths; at most 0.014 over "
                "5 steps from each of 2 seeds")


def f32_training_vs_plain(name, ir, padding, arrays, meta, init_tree, dev, steps) -> None:
    """Train `steps` steps in f32 from `init_tree` on the kernel path (the
    card) and on the plain path (the CPU): the losses agree step by step, and
    the last lies below the first."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    runs = []
    for device in (dev, "cpu"):
        trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=None, device=device)
        state, batch = trainer.init_state(params=init_tree), to_device(arrays, device)
        step, totals = trainer.train_step_fn(meta), []
        for _ in range(steps):
            state, m = step(state, batch)
            totals.append(float(m["total"]))
        runs.append(totals)
    print(f"  {name}: {steps} f32 steps, loss+reg " + " ".join(f"{t:.5f}" for t in runs[0]))
    compare(f"{name} loss+reg of {steps} f32 steps, kernels vs plain (CPU), each path its own "
            f"updates", torch.tensor(runs[0]), torch.tensor(runs[1]), atol=0.0, rtol=1e-3,
            why=f"f32 sums in another order on each device, carried through {steps - 1} Adam "
                "updates")
    if not runs[0][-1] < runs[0][0]:
        raise AssertionError(f"{name}: the f32 loss did not fall: {runs[0]}")


def train(dev, card: str) -> dict:
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params, map_params
    from ignnition_tpu_torch.training.metrics import MetricAccumulator

    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    rng = np.random.default_rng(SEED + 1)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    launches = {"csr_segment_sum": 0, "csr_segment_sum_windows": 0, "masked_gru_scan": 0,
                "masked_gru_scan_bwd": 0}
    result = {}
    for name, size in (("flagship", FLAGSHIP), ("flagship_x4", FLAGSHIP_X4)):
        t0 = time.perf_counter()
        arrays, meta = igt.build_batch([make_sample(rng, **size)], ir, padding, training=True)
        print(f"[train] {name}: build_batch(training=True) {time.perf_counter() - t0:.2f} s "
              f"(host, native helpers)")
        # bf16 compute over f32 masters; no device argument: the card is the default
        trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
        if trainer.device.type != "cuda":
            raise AssertionError(f"the trainer chose {trainer.device}, not the card")
        batch = to_device(arrays, trainer.device)
        state = trainer.init_state(torch.Generator().manual_seed(SEED))

        # ---- step-0 gradients: kernel path (card) vs plain path (CPU), f32 ----
        init_tree, cpu_state, want = step0_gradients_vs_plain(
            name, ir, padding, arrays, meta, state, batch)
        init_params = flatten_params(init_tree)

        # the training dtype: kernel path against plain path, both in bf16
        # (printed, not held: bf16 roundings fall differently on the two paths)
        g_bf16, _ = trainer.grads_fn(meta)(state.params, batch)
        bf16_cpu = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16,
                               device="cpu")
        g_bf16_cpu, _ = bf16_cpu.grads_fn(meta)(cpu_state.params, to_device(arrays, "cpu"))
        for (k, gb), gc in zip(flatten_params(g_bf16).items(),
                               flatten_params(g_bf16_cpu).values()):
            top = max(float(gc.abs().max()), 1e-30)
            print(f"      bf16 compute, {k}: kernels vs plain (CPU) "
                  f"{float((gb.cpu() - gc).abs().max()) / top:.2e}, plain bf16 vs plain f32 "
                  f"{float((gc - want[k]).abs().max()) / top:.2e} of the leaf's largest entry")

        # ---- the main path: training steps, counting kernel launches ----
        step = trainer.train_step_fn(meta)
        a = "adj_links_paths"
        windows = (arrays[f"slice_sort_row_ptr_{a}"].shape[0] - 1) // meta.nodes("link")
        dense = any(k.startswith(("dense_inc_", "inc_blocks_")) for k in arrays)
        sliced = any(k.startswith("bwd_slice_dst_") for k in arrays)
        # kernel A: `_gss_bwd` once per iteration whatever the number of
        # windows (the windowed entry adds them in one launch; a launch per
        # window before), but for the first iteration, whose link states come
        # from the features alone and need no gradient; past the dense cap also
        # stage 2's forward and, without the slice map, its backward
        want_a = (ITERATIONS - 1) + (0 if dense else ITERATIONS * (1 if sliced else 2))
        want_w = ITERATIONS - 1 if windows > 1 else 0
        # steps 0 and 1 run eagerly and capture; from step 2 on each step's
        # hold reads `held()`, the counters over the capture; the main path's
        # counts are the wrappers', `read()`
        counts = Counts()
        counts.reset()
        metrics, snapshots = [], []
        for i in range(TRAIN_STEPS[name]):
            counters = lambda: tuple(counts.held()[k] for k in (
                "csr_segment_sum", "csr_segment_sum_windows", "masked_gru_scan",
                "masked_gru_scan_bwd"))
            if name == "flagship":
                snapshots.append(map_params(lambda v: v.detach().cpu().clone(), state.params))
            before = counters()
            state, m = step(state, batch)
            got = tuple(now - was for now, was in zip(counters(), before))
            if got != (want_a, want_w, ITERATIONS, ITERATIONS):
                raise AssertionError(
                    f"{name} step {i}: expected kernel A +{want_a} (+{want_w} of them "
                    f"windowed), B +{ITERATIONS}, C +{ITERATIONS} launches, got {got}")
            metrics.append(m)
        torch.cuda.synchronize()
        for k, v in counts.read().items():
            if k in launches:
                launches[k] += v
        totals = [float(m["total"]) for m in metrics]
        losses = [float(m["loss"]) for m in metrics]
        print(f"  {name}: {len(totals)} steps, loss+reg " + " ".join(f"{t:.5f}" for t in totals)
              + "; loss " + " ".join(f"{t:.5f}" for t in losses)
              + f"; per step kernel A +{want_a} ({windows} slice-sort windows: "
              f"{want_a + want_w * (windows - 1)} launches with one per window), "
              f"B +{ITERATIONS}, C +{ITERATIONS}")
        if not all(np.isfinite(totals + losses)):
            raise AssertionError(f"{name}: a loss is not finite")
        if name == "flagship":
            # bf16 gradients of this random-weight model are dominated by
            # rounding, so whether 5 bf16 steps end below the start is chance
            # (the plain path's own bf16 steps from here go elsewhere): each
            # step's loss is held to the plain path at the same parameters,
            # and the fall is asked of 5 f32 steps of both paths
            bf16_losses_vs_plain(name, ir, padding, arrays, meta, snapshots, totals)
            f32_training_vs_plain(name, ir, padding, arrays, meta, init_tree, dev,
                                  len(totals))
        elif not totals[-1] < totals[0]:
            raise AssertionError(f"{name}: the loss did not fall: {totals}")
        if state.step != len(totals) or state.opt_state["count"] != len(totals):
            raise AssertionError(f"{name}: the state counts {state.step} steps")
        moved = max(float((v.detach().cpu() - init_params[k]).abs().max())
                    for k, v in flatten_params(state.params).items())
        if not 0.0 < moved < 0.1:
            raise AssertionError(f"{name}: parameters moved by {moved}")

        # ---- evaluation step (f32 compute, no graph) ----
        preds, loss = trainer.eval_step_fn(meta)(state.params, batch)
        n_pad = meta.nodes("path")
        if preds.shape != (n_pad,) or preds.requires_grad or not torch.isfinite(preds).all():
            raise AssertionError(f"{name}: eval predictions {tuple(preds.shape)} or non-finite")
        acc = MetricAccumulator()
        acc.update(arrays["label"], preds.cpu().numpy(), arrays["label_mask"])
        print(f"  {name}: eval loss {float(loss):.5f}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in acc.result().items()))

        # ---- step time ----
        result[name] = dict(losses=totals, **time_training_step(
            name, step, state, batch, arrays, card,
            input_copies=trainer.graphs.captured[("train", meta, None)].input_copies))
    print(f"[train] main path launch counts: kernel A {launches['csr_segment_sum']} "
          f"({launches['csr_segment_sum_windows']} windowed), "
          f"kernel B {launches['masked_gru_scan']}, kernel C {launches['masked_gru_scan_bwd']}")
    if min(launches.values()) == 0:
        raise AssertionError("a kernel of the training path was never launched")
    return dict(launches=launches, steps=result)


# --------------------------------------------------------------------------
# phase 5: the attention family
# --------------------------------------------------------------------------


class Counts:
    """Launch counts of every kernel by name. `reset()` sets them to 0 and
    `read()` returns the wrappers' counters: the launches made from Python
    since the reset (eager calls, and the launches a capture recorded).
    These are what each phase adds up for the `kernels` line. A replay of a
    captured step runs no wrapper, so `read()` does not see it: `replays`
    lists, for each replay since the reset, the counters read over its
    capture (`CapturedStep.recorded`; a graph launches what it recorded),
    and `held()` is `read()` plus those, one call's launches whether it ran
    eagerly, captured or replayed. The holds of a call's launches
    (`expect_counts(what, counts, ...)`) read `held()` unless they say they
    read the profiler; phase 14 holds each replay's kernels, counted by name
    in a profile of the device, to the eager call's."""

    active = None  # the instance whose `replays` a replay is logged in

    def __init__(self):
        from ignnition_tpu_torch.ops.cuda import attention_kernels as ak
        from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk
        from ignnition_tpu_torch.ops.cuda import segment_kernels as sk
        from ignnition_tpu_torch.training import capture

        self.ak, self.rk, self.sk = ak, rk, sk
        self.replays = []
        call = capture.CapturedStep.__call__
        if not getattr(call, "logs_replays", False):
            def logged(step, bound, inputs):
                out = call(step, bound, inputs)
                if step.last == "replay" and Counts.active is not None:
                    Counts.active.replays.append(dict(step.recorded))
                return out

            logged.logs_replays = True
            capture.CapturedStep.__call__ = logged

    def reset(self) -> None:
        self.sk.launch_count = self.sk.windows_launch_count = self.sk.ids_launch_count = 0
        self.rk.launch_count = self.rk.bwd_launch_count = 0
        self.ak.fwd_launch_count = self.ak.bwd_launch_count = 0
        self.replays = []
        Counts.active = self

    def read(self) -> dict:
        from ignnition_tpu_torch.ops.cuda import launch_counts

        return launch_counts()

    def held(self) -> dict:
        got = self.read()
        for recorded in self.replays:
            for k, v in recorded.items():
                got[k] += v
        return got


def expect_counts(what: str, got, **want) -> None:
    """Raise unless the launch counts `got` are `want` (0 where not named):
    a dict, or a `Counts`, whose `held()` is read (the counters over the
    capture for each replay)."""
    note = ""
    if isinstance(got, Counts):
        if got.replays:
            python = ", ".join(f"{k} {v}" for k, v in got.read().items() if v) or "none"
            note = (f" ({len(got.replays)} replayed call(s) read over their capture; "
                    f"launched from Python: {python})")
        got = got.held()
    wrong = {k: (v, want.get(k, 0)) for k, v in got.items() if v != want.get(k, 0)}
    print(f"  {what}: launches " + ", ".join(f"{k} {v}" for k, v in got.items() if v) + note)
    if wrong:
        raise AssertionError(f"{what}: launch counts (got, expected) {wrong}")


def serve_one_size(dev, ir, params, samples, padding, compute_dtype=torch.bfloat16):
    """A `ServingModel` at the shapes that fit `samples`."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data.graph import merge_metas

    meta = merge_metas([igt.build_batch([s], ir, padding, training=False)[1] for s in samples])
    return igt.ServingModel(igt.build(ir), params, meta, ir, compute_dtype=compute_dtype,
                            device=dev)


def kernels_vs_plain_forward(name, server, ir, params, sample, dev, dtypes) -> None:
    """One request's predictions on the card against the same model on the
    CPU (every kernel's plain version)."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    tols = {
        None: (1e-4, 1e-4, "f32: sums and products in another order on each device"),
        torch.bfloat16: (3e-2, 3e-2, "bf16: roundings of the bf16 states and "
                                     "matmul outputs fall differently over the iterations"),
    }
    arrays = server.build_batch([sample])
    inputs = {k: v for k, v in arrays.items() if k not in ("label", "label_mask")}
    cpu_model = igt.build(ir)
    cpu_model.load_params(params)
    b_dev, b_cpu = to_device(inputs, dev), to_device(inputs, "cpu")
    mask = torch.from_numpy(arrays["node_mask_path"] > 0)
    for cd in dtypes:
        atol, rtol, why = tols[cd]
        with torch.inference_mode():
            got = server.model(b_dev, server.meta, compute_dtype=cd)
            t1 = time.perf_counter()
            want = cpu_model(b_cpu, server.meta, compute_dtype=cd)
            cpu_s = time.perf_counter() - t1
        compare(f"{name} predictions, kernels vs plain (CPU, {cpu_s:.1f} s) "
                f"{'f32' if cd is None else 'bf16'}",
                got.cpu()[mask], want[mask], atol=atol, rtol=rtol, why=why)


def attention(dev, card: str) -> dict:
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params

    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    ir = igt.parse_model_description(attention_description(), FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    leaves = [k for k in flatten_params(params) if k.startswith("aggregation/")]
    if leaves != [f"aggregation/s1/m0/{k}" for k in ("kernel1", "kernel2", "attn_kernel")]:
        raise AssertionError(f"attention leaves {leaves}")
    rng = np.random.default_rng(SEED + 2)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    result = {}

    # ---- serving at the flagship size: dense attention, kernel D ----
    samples = [make_sample(rng, **FLAGSHIP) for _ in range(N_FLAGSHIP_REQUESTS)]
    server = serve_one_size(dev, ir, params, samples, padding)
    inc = server.build_batch([samples[0]])["dense_inc_adj_paths_links"]
    print(f"[attention] flagship incidence {inc.dtype} {inc.shape}, "
          f"{int(np.count_nonzero(inc))} non-zeros")
    for i, sample in enumerate(samples):
        counts.reset()
        preds = server.predict_samples([sample])
        got = counts.read()
        add(got)
        if preds.shape != (FLAGSHIP["n_paths"],) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"attention request {i}: {preds.shape} or non-finite")
        expect_counts(f"attention request {i} ({preds.shape[0]} predictions, mean "
                      f"{preds.mean():.5f})", counts,
                      masked_gru_scan=ITERATIONS, flash_gat_fwd=ITERATIONS)
    kernels_vs_plain_forward("attention flagship", server, ir, params, samples[0], dev,
                             (None, torch.bfloat16))
    arrays = server.build_batch([samples[0]])
    inputs = to_device({k: v for k, v in arrays.items()
                        if k not in ("label", "label_mask")}, dev)
    fwd = forward_ms(server, inputs)
    e2e = []
    for _ in range(3):
        t1 = time.perf_counter()
        server.predict_samples([samples[0]])
        e2e.append((time.perf_counter() - t1) * 1e3)
    result["serving"] = dict(forward_ms=float(np.median(fwd)), request_ms=float(np.median(e2e)))
    print(f"[latency] attention flagship: device forward median {np.median(fwd):.3f} ms "
          f"(min {min(fwd):.3f}, max {max(fwd):.3f}, 20 runs, CUDA events); whole request "
          f"median {np.median(e2e):.1f} ms (3 runs, host clock) on {card}")
    result["serving"].update(build_batch_ms(
        "attention flagship", lambda: server.build_batch([samples[0]]), card))
    result["serving"].update(print_profile(
        "attention flagship forward", lambda: server.forward_device(inputs),
        result["serving"]["forward_ms"]))

    # ---- training at the flagship size: kernels D and E ----
    t0 = time.perf_counter()
    arrays, meta = igt.build_batch([make_sample(rng, **FLAGSHIP)], ir, padding, training=True)
    print(f"[attention] build_batch(training=True) {time.perf_counter() - t0:.2f} s (host)")
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
    batch = to_device(arrays, trainer.device)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    init_tree, _, _ = step0_gradients_vs_plain(
        "attention", ir, padding, arrays, meta, state, batch, noise=1e-7)
    init_params = flatten_params(init_tree)
    step = trainer.train_step_fn(meta)
    metrics = []
    for i in range(ATTENTION_TRAIN_STEPS):
        counts.reset()
        state, m = step(state, batch)
        got = counts.read()
        add(got)
        # kernel A: the slice gather's backward, but for the first iteration,
        # whose link states need no gradient. Kernel E: but for the last
        # iteration, whose link states the readout (over paths) never reads,
        # so autograd has nothing to send back through that attention.
        expect_counts(f"attention training step {i}", counts,
                      csr_segment_sum=ITERATIONS - 1, masked_gru_scan=ITERATIONS,
                      masked_gru_scan_bwd=ITERATIONS, flash_gat_fwd=ITERATIONS,
                      flash_gat_bwd=ITERATIONS - 1)
        metrics.append({k: float(v) for k, v in m.items()})
    print("  attention training: " + "; ".join(
        f"{k} " + " ".join(f"{m[k]:.5f}" for m in metrics) for k in ("total", "loss", "reg")))
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("attention training: a loss is not finite")
    regs = [m["reg"] for m in metrics]
    if not all(b < a for a, b in zip(regs, regs[1:])):
        raise AssertionError(f"attention training: the L2 term did not fall: {regs}")
    moved = {k: float((v.detach().cpu() - init_params[k]).abs().max())
             for k, v in flatten_params(state.params).items()}
    if not all(0.0 < v < 0.1 for v in moved.values()):
        raise AssertionError(f"attention training: parameters moved by {moved}")
    result["training"] = dict(
        losses=[m["total"] for m in metrics], regs=regs,
        **time_training_step("attention flagship", step, state, batch, arrays, card))

    # ---- 4x: past the dense cap, per-edge attention through kernel A ----
    # (the port's default, `_SLOT_ATTN` off; phase 16 (c) runs slot-rate
    # attention, the JAX package's default, at this size beside it)
    sample = make_sample(rng, **FLAGSHIP_X4)
    server = serve_one_size(dev, ir, params, [sample], padding)
    counts.reset()
    preds = server.predict_samples([sample])
    got = counts.read()
    add(got)
    if preds.shape != (FLAGSHIP_X4["n_paths"],) or not np.all(np.isfinite(preds)):
        raise AssertionError(f"attention x4: {preds.shape} or non-finite")
    expect_counts(f"attention x4 request ({preds.shape[0]} predictions)", counts,
                  csr_segment_sum=2 * ITERATIONS, masked_gru_scan=ITERATIONS)
    kernels_vs_plain_forward("attention x4 (per-edge)", server, ir, params, sample, dev,
                             (None,))
    arrays = server.build_batch([sample])
    inputs = to_device({k: v for k, v in arrays.items()
                        if k not in ("label", "label_mask")}, dev)
    fwd = forward_ms(server, inputs, runs=10)
    result["serving_x4"] = dict(forward_ms=float(np.median(fwd)))
    print(f"[latency] attention x4 (per-edge): device forward median {np.median(fwd):.3f} ms "
          f"(10 runs, CUDA events) on {card}")
    result["serving_x4"].update(print_profile(
        "attention x4 forward", lambda: server.forward_device(inputs),
        result["serving_x4"]["forward_ms"]))

    # ---- hs=48: a width off 128, the id-keyed sum on a model path ----
    ir48 = igt.parse_model_description(attention_description(hs=48), FEATURE_DIMS)
    params48 = igt.build(ir48).init(torch.Generator().manual_seed(SEED))
    sample = make_sample(rng, **SMALL_PER_EDGE)
    server = serve_one_size(dev, ir48, params48, [sample], padding, compute_dtype=None)
    counts.reset()
    preds = server.predict_samples([sample])
    got = counts.read()
    add(got)
    if preds.shape != (SMALL_PER_EDGE["n_paths"],) or not np.all(np.isfinite(preds)):
        raise AssertionError(f"attention hs=48: {preds.shape} or non-finite")
    # per iteration: the numerator (width 48) through the id-keyed kernel, the
    # denominator (width 8) through kernel A
    expect_counts(f"attention hs=48 request ({preds.shape[0]} predictions)", counts,
                  csr_segment_sum=ITERATIONS, segment_sum_ids=ITERATIONS,
                  masked_gru_scan=ITERATIONS)
    kernels_vs_plain_forward("attention hs=48 (per-edge)", server, ir48, params48, sample,
                             dev, (None,))
    # the per-edge backward on the card: `gather_by_dst` (kernel A) and the
    # id-keyed kernel under autograd
    arrays, meta = igt.build_batch([sample], ir48, padding, training=True)
    trainer = igt.Trainer(igt.build(ir48), padding, compute_dtype=None)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    step0_gradients_vs_plain("attention hs=48", ir48, padding, arrays, meta, state,
                             to_device(arrays, trainer.device), noise=1e-7)
    print("[attention] main path launch counts: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, **result)


# --------------------------------------------------------------------------
# phase 6: the Q-size model
# --------------------------------------------------------------------------


def qsize(dev, card: str) -> dict:
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params

    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    igt.register_normalization("normalization_queue_size", normalization_queue_size)
    ir = igt.parse_model_description(qsize_description(), QSIZE_FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    tag = "path_s0m0"  # the interleave's companions
    result = {}

    # ---- serving: stage 1 through the combined slice map into kernel B ----
    samples = [make_qsize_sample(rng, **QSIZE) for _ in range(QSIZE_REQUESTS)]
    server = serve_one_size(dev, ir, params, samples, padding)
    arrays = server.build_batch([samples[0]])
    for key in (f"ilv_slice_{tag}", "dense_inc_adj_paths_links", "dense_inc_adj_paths_nodes"):
        if key not in arrays:
            raise AssertionError(f"qsize: the batch has no {key}")
    incs = [arrays[f"dense_inc_adj_paths_{e}"] for e in ("links", "nodes")]
    print(f"[qsize] {QSIZE}: interleave slice map {arrays[f'ilv_slice_{tag}'].shape}, stage-2 "
          f"incidence " + ", ".join(f"{m.dtype} {m.shape} ({int(np.count_nonzero(m))} "
                                    f"non-zeros)" for m in incs))
    for i, sample in enumerate(samples):
        counts.reset()
        preds = server.predict_samples([sample])
        got = counts.read()
        add(got)
        if preds.shape != (QSIZE["n_paths"],) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"qsize request {i}: {preds.shape} or non-finite")
        # kernel B: stage 1's path update, once per iteration; stage 2 is two
        # incidence products (library matmuls)
        expect_counts(f"qsize request {i} ({preds.shape[0]} predictions, mean "
                      f"{preds.mean():.5f})", counts, masked_gru_scan=ITERATIONS)
    kernels_vs_plain_forward("qsize", server, ir, params, samples[0], dev,
                             (None, torch.bfloat16))
    inputs = to_device({k: v for k, v in arrays.items()
                        if k not in ("label", "label_mask")}, dev)
    fwd = forward_ms(server, inputs)
    e2e = []
    for i in range(6):
        t1 = time.perf_counter()
        server.predict_samples([samples[0]])
        if i >= 1:
            e2e.append((time.perf_counter() - t1) * 1e3)
    result["serving"] = dict(forward_ms=float(np.median(fwd)), request_ms=float(np.median(e2e)))
    print(f"[latency] qsize: device forward median {np.median(fwd):.3f} ms (min "
          f"{min(fwd):.3f}, max {max(fwd):.3f}, 20 runs, CUDA events); whole request "
          f"(build_batch + copy + forward + trim) median {np.median(e2e):.1f} ms (5 runs, "
          f"host clock) on {card}")
    result["serving"].update(build_batch_ms(
        "qsize", lambda: server.build_batch([samples[0]]), card))
    result["serving"].update(print_profile(
        "qsize forward", lambda: server.forward_device(inputs), result["serving"]["forward_ms"]))

    # ---- training: kernels B and C, kernel A as the interleave's backward ----
    t0 = time.perf_counter()
    arrays, meta = igt.build_batch([make_qsize_sample(rng, **QSIZE)], ir, padding,
                                   training=True)
    print(f"[qsize] build_batch(training=True) {time.perf_counter() - t0:.2f} s "
          f"(host, native helpers)")
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
    batch = to_device(arrays, trainer.device)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    init_tree, _, _ = step0_gradients_vs_plain("qsize", ir, padding, arrays, meta, state, batch)
    init_params = flatten_params(init_tree)
    windows = ((arrays[f"ilv_sort_row_ptr_{tag}"].shape[0] - 1)
               // (meta.nodes("link") + meta.nodes("node")))
    step = trainer.train_step_fn(meta)
    metrics = []
    for i in range(QSIZE_TRAIN_STEPS):
        counts.reset()
        state, m = step(state, batch)
        got = counts.read()
        add(got)
        # kernel A: the interleave gather's backward over `ilv_sort_*` (its
        # windows in one launch), but for the first iteration, whose link and
        # node states come from the features alone and need no gradient
        expect_counts(f"qsize training step {i} ({windows} slice-sort windows)", counts,
                      csr_segment_sum=ITERATIONS - 1,
                      csr_segment_sum_windows=ITERATIONS - 1 if windows > 1 else 0,
                      masked_gru_scan=ITERATIONS, masked_gru_scan_bwd=ITERATIONS)
        metrics.append({k: float(v) for k, v in m.items()})
    print("  qsize training: " + "; ".join(
        f"{k} " + " ".join(f"{m[k]:.5f}" for m in metrics) for k in ("total", "loss", "reg")))
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("qsize training: a loss is not finite")
    if state.step != QSIZE_TRAIN_STEPS:
        raise AssertionError(f"qsize training: the state counts {state.step} steps")
    moved = max(float((v.detach().cpu() - init_params[k]).abs().max())
                for k, v in flatten_params(state.params).items())
    if not 0.0 < moved < 0.1:
        raise AssertionError(f"qsize training: parameters moved by {moved}")
    result["training"] = dict(
        losses=[m["total"] for m in metrics],
        **time_training_step("qsize", step, state, batch, arrays, card))
    print("[qsize] main path launch counts: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, **result)


# --------------------------------------------------------------------------
# phase 7: the mlp_message family
# --------------------------------------------------------------------------


def check_slot_map_backward(dev, rng, arrays, meta, adj: str, src: str, d: int,
                            tag: str = "[mlp_message]") -> dict:
    """Kernel A as the backward of a slot map's gather (`_gss_bwd`) on this
    batch's own sort companions: the cotangent of the [L, n_dst] slots (zero
    past each destination's in-degree, as the masked sum leaves it) gathered
    into source order and summed into the sources, every window in one launch.
    Invalid slots point at the last source row, so that row's segment holds
    every invalid slot. Against the plain version in bf16 and f32, timed
    beside `torch.segment_reduce` over the same row pointers and the bound."""
    from ignnition_tpu_torch.ops import segment as seg
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    n_src = meta.nodes(src)
    slice_src = arrays[f"slice_src_{adj}"]
    rp = torch.from_numpy(arrays[f"slice_sort_row_ptr_{adj}"]).to(dev)
    windows = (rp.shape[0] - 1) // n_src
    perm = torch.from_numpy(arrays[f"slice_sort_perm_{adj}"]).to(dev)
    whole = seg._whole_sort_perm(perm, windows) if windows > 1 else perm.to(torch.int64)
    valid = np.arange(slice_src.shape[0])[:, None] < arrays[f"lens_{adj}"][None, :]
    longest = int(np.diff(arrays[f"slice_sort_row_ptr_{adj}"]).max())
    print(f"{tag} stage-2 slot map {slice_src.shape}: {int(valid.sum())} real slots of "
          f"{valid.size}, {windows} slice-sort windows, longest source segment {longest} "
          f"slots (the invalid slots' row)")
    # small integers: f32 sums exact in any order over the long segment
    values = (rng.integers(-4, 5, size=slice_src.shape + (d,)) * valid[:, :, None])
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        ct = torch.from_numpy(values.astype(np.float32)).to(dev, dtype).reshape(-1, d)
        sorted_ct = ct[whole]
        before = sk.launch_count
        call = lambda x, r: sk.sorted_segment_sum_csr_windows(x, r, n_src)
        first, second = call(sorted_ct, rp), call(sorted_ct, rp)
        torch.cuda.synchronize()
        if sk.launch_count != before + 2:
            raise AssertionError("the slot-map backward did not launch kernel A")
        if not torch.equal(first, second):
            raise AssertionError("the slot-map backward: two calls differ bitwise")
        plain_call = lambda x, r: sk.sorted_segment_sum_csr_windows_plain(x, r, n_src)
        plain = plain_call(sorted_ct, rp)
        tag = f"[{ct.shape[0]}x{d}] -> [{n_src}x{d}] over {windows} windows {str(dtype)[6:]}"
        err = compare(f"kernel A, stage-2 slot-map backward {tag}, bitwise repeatable", first,
                      plain, atol=1e-4, rtol=1e-5,
                      why=f"exact: sums of small integers over up to {longest} rows")
        offsets = rp.to(torch.int64)
        t = device_times(call, rotations((sorted_ct, rp)))
        plain_ms = cuda_ms(lambda: plain_call(sorted_ct, rp))
        t_lib = device_times(
            lambda x, o: torch.segment_reduce(x, "sum", offsets=o, axis=0, unsafe=True),
            rotations((sorted_ct, offsets)), guarded=True, what="torch.segment_reduce")
        n_bytes = ct.shape[0] * d * ct.element_size() + rp.shape[0] * 4 + n_src * d * 4
        bound_ms, bound_by = bound(n_bytes, ct.shape[0] * d, torch.float32)
        print(f"    time: kernel {fmt_times(t)}, plain {plain_ms:.4f} ms, torch.segment_reduce "
              f"{fmt_times(t_lib)} ({windows * n_src} segments, the windows not added), "
              f"bound {bound_ms:.4f} ms by {bound_by}")
        out[dtype] = dict(max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=t_lib["ms"],
                          library_graph_ms=t_lib["graph_ms"], library_cold_ms=t_lib["cold_ms"])
    return out


# the depth at which phase 7 holds the kernel path to the plain path: at 8
# iterations this random-weight model amplifies f32 rounding past the limits
# (the plain path alone lies ~2e-4 from its f64 result; its bf16 form ~0.4),
# which `mlp_message_vs_plain` measures and prints in every run
MLP_MESSAGE_CHECK_ITERATIONS = 2


def _predictions(model, arrays, meta, device, compute_dtype):
    from ignnition_tpu_torch.batch import to_device

    inputs = {k: v for k, v in arrays.items() if k not in ("label", "label_mask")}
    with torch.inference_mode():
        out = model(to_device(inputs, device), meta, compute_dtype=compute_dtype)
    return out.float().cpu()[torch.from_numpy(arrays["node_mask_path"] > 0)]


def _grads(ir, params, arrays, meta, padding, device, compute_dtype):
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params, map_params

    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=compute_dtype, device=device)
    state = trainer.init_state(params=map_params(lambda v: v.clone(), params))
    grads, _ = trainer.grads_fn(meta)(state.params, to_device(arrays, device))
    return {k: v.double().cpu() for k, v in flatten_params(grads).items()}


def gradient_spread(dev, ir, params, arrays, meta, padding) -> dict:
    """How far the kernel path's f32 step-0 gradients lie from the plain
    path's (the CPU) and from the plain path's f64, and the plain path's own
    f32 from its f64: of each leaf's largest entry, the worst leaf."""
    g = {name: _grads(ir, params, arrays, meta, padding, d, cd)
         for name, d, cd in (("card", dev, None), ("cpu", "cpu", None),
                             ("cpu f64", "cpu", torch.float64))}
    ggap = lambda a, b: max(float((g[a][k] - v).abs().max() / v.abs().max())
                            for k, v in g[b].items())
    return dict(gradients_kernel_vs_plain=ggap("card", "cpu"),
                gradients_kernel_vs_plain_f64=ggap("card", "cpu f64"),
                gradients_plain_f32_vs_f64=ggap("cpu", "cpu f64"))


def mlp_message_vs_plain(dev, ir, params, serve_sample, train_arrays, train_meta,
                         padding) -> dict:
    """The kernel path against the plain path (the CPU) on the main path's
    batches and weights. At the main path's 8 iterations, printed: how far
    the kernel path's f32 predictions and step-0 gradients lie from the
    plain path's, and how far the plain path's own f32 lies from its f64
    (the rounding that 8 iterations of this random-weight model amplify).
    Held, at `MLP_MESSAGE_CHECK_ITERATIONS` (full width, depth cut): f32
    and bf16 predictions, the step-0 loss and every gradient leaf in f32,
    at the limits of the other families."""
    import ignnition_tpu_torch as igt

    arrays, meta = igt.build_batch([serve_sample], ir, padding, training=False)
    cpu, card = igt.build(ir), igt.build(ir)
    cpu.load_params(params)
    card.load_params(params, device=dev)
    p = {name: _predictions(m, arrays, meta, d, cd) for name, m, d, cd in (
        ("card", card, dev, None), ("cpu", cpu, "cpu", None),
        ("cpu f64", cpu, "cpu", torch.float64))}
    gap = lambda a, b: float((p[a] - p[b]).abs().max())
    spread = dict(predictions_kernel_vs_plain=gap("card", "cpu"),
                  predictions_plain_f32_vs_f64=gap("cpu", "cpu f64"),
                  **gradient_spread(dev, ir, params, train_arrays, train_meta, padding))
    print(f"[mlp_message] at {ir.num_iterations} iterations, f32, measured and not held: "
          f"predictions kernels vs plain {spread['predictions_kernel_vs_plain']:.3e}, plain "
          f"f32 vs plain f64 {spread['predictions_plain_f32_vs_f64']:.3e}; step-0 gradients "
          f"(of each leaf's largest entry, the worst leaf) kernels vs plain "
          f"{spread['gradients_kernel_vs_plain']:.3e}, plain f32 vs f64 "
          f"{spread['gradients_plain_f32_vs_f64']:.3e} (the limits: 1e-4); the paths are held "
          f"at {MLP_MESSAGE_CHECK_ITERATIONS} iterations")

    cut = igt.parse_model_description(
        mlp_message_description(num_iterations=MLP_MESSAGE_CHECK_ITERATIONS), FEATURE_DIMS)
    cut_params = igt.build(cut).init(torch.Generator().manual_seed(SEED))
    name = f"mlp_message ({MLP_MESSAGE_CHECK_ITERATIONS} iterations)"
    server = serve_one_size(dev, cut, cut_params, [serve_sample], padding)
    kernels_vs_plain_forward(name, server, cut, cut_params, serve_sample, dev,
                             (None, torch.bfloat16))
    arrays, meta = igt.build_batch([serve_sample], cut, padding, training=True)
    trainer = igt.Trainer(igt.build(cut), padding, compute_dtype=torch.bfloat16)
    state = trainer.init_state(params=cut_params)
    from ignnition_tpu_torch.batch import to_device

    step0_gradients_vs_plain(name, cut, padding, arrays, meta, state,
                             to_device(arrays, trainer.device))
    return spread


def mlp_message(dev, card: str) -> dict:
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.frontend.ir import SLOT_PAD_CAP
    from ignnition_tpu_torch.model.builder import flatten_params

    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    ir = igt.parse_model_description(mlp_message_description(), FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    leaves = [k for k in flatten_params(params) if k.startswith("message/")]
    want_leaves = [f"message/s{si}/m0/src0/op0/layers/{j}/{w}"
                   for si in (0, 1) for j in (0, 1) for w in ("kernel", "bias")]
    if leaves != want_leaves:
        raise AssertionError(f"mlp_message leaves {leaves}")
    rng = np.random.default_rng(SEED + 3)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    s1, s2 = "adj_links_paths", "adj_paths_links"
    result = {}

    # ---- the lowering of each stage, as the builder decides it ----
    samples = [make_sample(rng, **FLAGSHIP) for _ in range(MLP_MESSAGE_REQUESTS)]
    server = serve_one_size(dev, ir, params, samples, padding)
    meta = server.meta
    slots = meta.maxlen(s2) * meta.nodes("link")
    slot_sum = slots <= SLOT_PAD_CAP * meta.edges(s2)
    print(f"[mlp_message] stage 1: slice map [{meta.maxlen(s1)}, {meta.nodes('path')}], the "
          f"message network's tail over the slot tensor, then kernel B; stage 2: "
          f"{slots} slots for {meta.edges(s2)} edges (cap {SLOT_PAD_CAP:g} x edges): "
          + ("the slot-rate sum" if slot_sum else "past the cap, gather + the CSR sum"))
    if not slot_sum:
        raise AssertionError("mlp_message: stage 2 fell past the slot cap at the flagship "
                             "size; the launch counts below assume the slot-rate sum")

    # ---- serving: kernel B x8 a forward, and nothing else of the port's ----
    for i, sample in enumerate(samples):
        counts.reset()
        preds = server.predict_samples([sample])
        got = counts.read()
        add(got)
        if preds.shape != (FLAGSHIP["n_paths"],) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"mlp_message request {i}: {preds.shape} or non-finite")
        # kernel B once per iteration: the step loop would launch none
        expect_counts(f"mlp_message request {i} ({preds.shape[0]} predictions, mean "
                      f"{preds.mean():.5f})", counts, masked_gru_scan=ITERATIONS)
    arrays = server.build_batch([samples[0]])
    inputs = to_device({k: v for k, v in arrays.items()
                        if k not in ("label", "label_mask")}, dev)
    fwd = forward_ms(server, inputs)
    e2e = []
    for i in range(6):
        t1 = time.perf_counter()
        server.predict_samples([samples[0]])
        if i >= 1:
            e2e.append((time.perf_counter() - t1) * 1e3)
    result["serving"] = dict(forward_ms=float(np.median(fwd)), request_ms=float(np.median(e2e)))
    print(f"[latency] mlp_message: device forward median {np.median(fwd):.3f} ms (min "
          f"{min(fwd):.3f}, max {max(fwd):.3f}, 20 runs, CUDA events); whole request "
          f"(build_batch + copy + forward + trim) median {np.median(e2e):.1f} ms (5 runs, "
          f"host clock) on {card}")
    result["serving"].update(build_batch_ms(
        "mlp_message", lambda: server.build_batch([samples[0]]), card))
    print(f"    build_batch's share of the whole request "
          f"{result['serving']['build_batch_ms'] / result['serving']['request_ms']:.0%}")
    result["serving"].update(print_profile(
        "mlp_message forward", lambda: server.forward_device(inputs),
        result["serving"]["forward_ms"]))

    # ---- training: B and C x8 a step, A as both slice gathers' backward ----
    t0 = time.perf_counter()
    arrays, meta = igt.build_batch([make_sample(rng, **FLAGSHIP)], ir, padding, training=True)
    print(f"[mlp_message] build_batch(training=True) {time.perf_counter() - t0:.2f} s "
          f"(host, native helpers)")
    if meta.maxlen(s2) * meta.nodes("link") > SLOT_PAD_CAP * meta.edges(s2):
        raise AssertionError("mlp_message: the training batch fell past the slot cap")
    result["slot_map_backward"] = check_slot_map_backward(dev, rng, arrays, meta, s2, "path",
                                                          HS)
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
    batch = to_device(arrays, trainer.device)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    init_params = {k: v.detach().cpu().clone() for k, v in flatten_params(state.params).items()}
    result["vs_plain"] = mlp_message_vs_plain(dev, ir, params, samples[0], arrays, meta, padding)
    windows = {a: (arrays[f"slice_sort_row_ptr_{a}"].shape[0] - 1) // meta.nodes(src)
               for a, src in ((s1, "link"), (s2, "path"))}
    # kernel A: each slice gather's backward. Stage 1's at every iteration:
    # the gathered table is `link_states @ Ksrc`, and Ksrc needs its
    # gradient even where the link states (iteration 1's) need none. Stage
    # 2's but for the last iteration, whose link states reach no prediction.
    per_stage = {s1: ITERATIONS, s2: ITERATIONS - 1}
    want_a = sum(per_stage.values())
    want_w = sum(n for a, n in per_stage.items() if windows[a] > 1)
    print(f"[mlp_message] a step should launch kernel A {want_a} times ({per_stage[s1]} for "
          f"stage 1's slot map, {windows[s1]} window(s); {per_stage[s2]} for stage 2's, "
          f"{windows[s2]} window(s): {want_w} windowed), B and C {ITERATIONS} times each")
    step = trainer.train_step_fn(meta)
    metrics = []
    for i in range(MLP_MESSAGE_TRAIN_STEPS):
        counts.reset()
        state, m = step(state, batch)
        got = counts.read()
        add(got)
        expect_counts(f"mlp_message training step {i}", counts, csr_segment_sum=want_a,
                      csr_segment_sum_windows=want_w, masked_gru_scan=ITERATIONS,
                      masked_gru_scan_bwd=ITERATIONS)
        metrics.append({k: float(v) for k, v in m.items()})
    print("  mlp_message training: " + "; ".join(
        f"{k} " + " ".join(f"{m[k]:.5f}" for m in metrics) for k in ("total", "loss", "reg")))
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("mlp_message training: a loss is not finite")
    if state.step != MLP_MESSAGE_TRAIN_STEPS:
        raise AssertionError(f"mlp_message training: the state counts {state.step} steps")
    moved = {k: float((v.detach().cpu() - init_params[k]).abs().max())
             for k, v in flatten_params(state.params).items()}
    if not all(0.0 < v < 0.1 for k, v in moved.items() if k.startswith("message/")):
        raise AssertionError(f"mlp_message training: message parameters moved by {moved}")
    result["training"] = dict(
        losses=[m["total"] for m in metrics],
        **time_training_step("mlp_message", step, state, batch, arrays, card))
    print("[mlp_message] main path launch counts: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, **result)


# --------------------------------------------------------------------------
# phase 8: the homogeneous-graph models, and the blocks_g4 and x8 sizes
# --------------------------------------------------------------------------

# graphs a batch, and each graph's node count: drawn from GRAPH_NODES on the
# CSR batches (unequal sizes, so no block-diagonal incidence), exactly
# BLOCK_GRAPH_NODES on the block batch; out-degree 3 (data/synthetic.py)
HOMOGENEOUS_GRAPHS = 1024
GRAPH_NODES = (96, 160)
BLOCK_GRAPH_NODES = 128
OUT_DEGREE = 3
HOMOGENEOUS_REQUESTS = 2
HOMOGENEOUS_TRAIN_STEPS = 5
HOMOGENEOUS_DIMS = {"graphprop": {"x": 1, "cap": 1}, "linkpred": {"x": 1}}
NODE_ADJ = "adj_nodes_nodes"
# bench.py's blocks_g4 (4 graphs of 512 links and 4,096 paths, padded per
# graph: stage 2 a block product) and flagship_x8 (16,384 links, 131,072
# paths: gather + kernel A, the windowed backward): (size, graphs, per-graph
# padding)
ITEM1_SIZES = {
    "blocks_g4": (dict(n_links=512, n_paths=4096, path_len=8), 4, True),
    "flagship_x8": (dict(n_links=16384, n_paths=131072, path_len=8), 1, False),
}
ITEM1_TRAIN_STEPS = 2
# the depth at which the item-1 sizes hold the model's step-0 gradients to
# the plain path (as phase 7 does for the same reason)
ITEM1_CHECK_ITERATIONS = 2
# blocks_g4 at 8 iterations, f32: how much further from the plain f64 the
# kernel path's step-0 gradients may lie than the plain f32's (the CPU's)
# own distance, both read in the same run. Measured 5.3x (2.87e-4 against
# 5.41e-5 on an NVIDIA H100 80GB HBM3, 700 W), 2.9x of it the block
# product's library f32 rounding (`spread_by_operation`); 8 leaves ~1.5x
# room for the card's order of summation
F32_SPREAD_MULTIPLE = 8


def example_ir(name: str):
    """`examples/<name>/model_description.yaml` as it is, parsed by the port."""
    from ignnition_tpu_torch.frontend import parse_model_file

    here = os.path.dirname(os.path.abspath(__file__))
    return parse_model_file(os.path.join(here, "examples", name, "model_description.yaml"),
                            HOMOGENEOUS_DIMS[name])


def homogeneous_samples(rng, ir, kind: str, sizes) -> list:
    """One graph of `data/synthetic.py`'s `make_<kind>_sample` per node count,
    converted for the model."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data import synthetic

    make = getattr(synthetic, f"make_{kind}_sample")
    spec = igt.SampleSpec.from_ir(ir)
    return [igt.convert_sample(make(rng, n_nodes=int(n), out_degree=OUT_DEGREE), spec)
            for n in sizes]


def check_graph_ids(what: str, arrays) -> None:
    """The id-keyed kernel pools by graph ids that never decrease over the
    real rows: checked once a batch, on the host."""
    ids = arrays["graph_id_node"][arrays["node_mask_node"] > 0]
    if not np.all(np.diff(ids) >= 0):
        raise AssertionError(f"{what}: the real node rows are not sorted by graph")


def homogeneous_launches(kind: str, ir, arrays, training: bool) -> dict:
    """Kernel launches of one forward or one training step, from the lowering
    that `GnnModel` takes for this batch.

    graphprop, per iteration: over an incidence matrix (blocks or dense)
    the attention is kernel D, and E in the step (its scores read `kernel1`
    from the first iteration on); the convolution is a library product. On
    the CSR batch the attention's numerator and denominator and the
    convolution's sum are kernel A, and the step adds the transposes of the
    attention's destination-score gather and of the per-edge message
    gathers (A each): the convolution's at every iteration, the attention's
    but for the first, whose messages are the features; the sums' own
    backwards are gathers. The mean pooling is the id-keyed kernel once a
    forward (its backward a gather).
    linkpred: the sum is kernel A once an iteration past the cap (a gather
    of source rows, then A); in the step its backward is A again where the
    batch has no out-degree slice map (`direct_segment_sum`), but for the
    first iteration, whose states come from the features; the readout's two
    gathers per edge are transposed by kernel A each."""
    a, it = NODE_ADJ, ir.num_iterations
    incidence = f"inc_blocks_{a}" in arrays or f"dense_inc_{a}" in arrays
    if kind == "graphprop":
        if incidence:
            out = dict(flash_gat_fwd=it, flash_gat_bwd=it if training else 0)
        else:
            out = dict(csr_segment_sum=3 * it + (3 * it - 1 if training else 0))
        out["segment_sum_ids"] = 1
        return out
    if incidence:
        raise AssertionError("linkpred: the phase's batches lie past the dense cap")
    want_a = it
    if training:
        direct = f"bwd_slice_dst_{a}" not in arrays and f"dst_in_src_order_{a}" in arrays
        want_a += (it - 1 if direct else 0) + 2
    return dict(csr_segment_sum=want_a)


def forward_with_states(model, batch, meta, compute_dtype):
    """One forward's predictions and the node states that reach the readout
    (per node, before any pooling)."""
    seen = {}
    readout = model._readout

    def spy(params, b, m, states, *rest):
        seen.update(states)
        return readout(params, b, m, states, *rest)

    model._readout = spy
    try:
        with torch.inference_mode():
            preds = model(batch, meta, compute_dtype=compute_dtype)
    finally:
        del model._readout
    return preds, seen["node"]


def homogeneous_vs_plain_forward(name, server, ir, params, samples, dev) -> dict:
    """One request on the card against the same model on the CPU (every
    kernel's plain version), on the real rows of the predictions (each
    graph's, or each real edge's in the samples' edge order) and of the node
    states that reach the readout. f32: within 1e-4. bf16: the kernel path
    may lie no further from the plain path in bf16 than bf16 rounding alone
    puts the plain path from itself in f32 (the control, on the same rows,
    this run's reading). Returns the readings."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    bf16 = torch.bfloat16
    arrays = server.build_batch(samples)
    inputs = {k: v for k, v in arrays.items() if k not in ("label", "label_mask", "label_perm")}
    cpu_model = igt.build(ir)
    cpu_model.load_params(params)
    b_dev, b_cpu = to_device(inputs, dev), to_device(inputs, "cpu")
    nodes = torch.from_numpy(arrays["node_mask_node"] > 0)
    runs, cpu_s = {}, 0.0
    for where, model, batch in (("card", server.model, b_dev), ("cpu", cpu_model, b_cpu)):
        for cd in (None, bf16):
            t1 = time.perf_counter()
            preds, states = forward_with_states(model, batch, server.meta, cd)
            cpu_s += (time.perf_counter() - t1) if where == "cpu" else 0.0
            runs[where, cd] = (torch.from_numpy(server.trim(preds.cpu().numpy(), arrays)),
                               states.float().cpu()[nodes])
    out = {}
    for i, what in enumerate(("predictions", "final node states")):
        compare(f"{name} {what}, kernels vs plain (CPU, {cpu_s:.1f} s for four forwards) f32",
                runs["card", None][i], runs["cpu", None][i], atol=1e-4, rtol=1e-4,
                why="f32: sums and products in another order on each device")
        gap = float((runs["card", bf16][i] - runs["cpu", bf16][i]).abs().max())
        control = float((runs["cpu", bf16][i] - runs["cpu", None][i]).abs().max())
        top = float(runs["cpu", None][i].abs().max())
        print(f"  {name} {what} bf16 ({runs['card', bf16][i].shape[0]} rows, largest "
              f"{top:.3e}): kernels vs plain max_abs={gap:.3e}; the control, plain bf16 vs "
              f"plain f32, {control:.3e} (ratio {gap / max(control, 1e-30):.3f}; limit 1)")
        out[what] = dict(bf16_gap=gap, bf16_control=control)
        if not gap <= control:
            raise AssertionError(f"{name} {what}: the bf16 kernel path lies further from the "
                                 f"plain path than bf16 rounding puts it from f32")
    return out


def serve_and_time(name, server, samples, inputs, card, counts, add, per_request) -> dict:
    """Answer each request (a list of samples) through `predict_samples`,
    holding its shape and launch counts, then time the forward, the whole
    request and `build_batch`, and profile the forward."""
    for i, request in enumerate(samples):
        counts.reset()
        preds = server.predict_samples(request)
        got = counts.read()
        add(got)
        want_rows, want_counts = per_request(request)
        if preds.shape != (want_rows,) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"{name} request {i}: predictions {preds.shape} (want "
                                 f"({want_rows},)) or non-finite")
        expect_counts(f"{name} request {i} ({want_rows} predictions, mean {preds.mean():.5f})",
                      counts, **want_counts)
    fwd = forward_ms(server, inputs)
    e2e = []
    for i in range(4):
        t1 = time.perf_counter()
        server.predict_samples(samples[0])
        if i >= 1:
            e2e.append((time.perf_counter() - t1) * 1e3)
    out = dict(forward_ms=float(np.median(fwd)), request_ms=float(np.median(e2e)))
    print(f"[latency] {name}: device forward median {np.median(fwd):.3f} ms (min "
          f"{min(fwd):.3f}, max {max(fwd):.3f}, 20 runs, CUDA events); whole request "
          f"(build_batch + copy + forward + trim) median {np.median(e2e):.1f} ms (3 runs, "
          f"host clock) on {card}")
    out.update(build_batch_ms(name, lambda: server.build_batch(samples[0]), card, runs=3,
                              numpy_runs=1))
    out.update(print_profile(f"{name} forward", lambda: server.forward_device(inputs),
                             out["forward_ms"]))
    return out


def step0_bf16_gradients_vs_plain(name, ir, padding, arrays, meta, state, batch, init_tree,
                                  cpu_f32) -> dict:
    """Hold every bf16 step-0 gradient leaf of the kernel path to the plain
    path's in bf16 (the same model and batch on the CPU): the kernel path
    may lie no further from it than bf16 rounding alone puts the plain path
    from its f32 gradients (`cpu_f32`; the control, this run's reading, leaf
    by leaf). Returns the readings by leaf."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params

    bf16 = torch.bfloat16
    card = igt.Trainer(igt.build(ir), padding, compute_dtype=bf16)
    g_card, m_card = card.grads_fn(meta)(state.params, batch)
    cpu = igt.Trainer(igt.build(ir), padding, compute_dtype=bf16, device="cpu")
    t1 = time.perf_counter()
    g_cpu, m_cpu = cpu.grads_fn(meta)(cpu.init_state(params=init_tree).params,
                                      to_device(arrays, "cpu"))
    print(f"  {name} step-0 loss bf16: kernels {float(m_card['total']):.7f}, plain (CPU, "
          f"{time.perf_counter() - t1:.1f} s) {float(m_cpu['total']):.7f}")
    want = flatten_params(g_cpu)
    out, worst = {}, 0.0
    for k, g in flatten_params(g_card).items():
        gap = float((g.cpu() - want[k]).abs().max())
        control = float((want[k] - cpu_f32[k]).abs().max())
        ratio = gap / max(control, 1e-30)
        worst = max(worst, ratio)
        out[k] = dict(bf16_gap=gap, bf16_control=control)
        print(f"  {name} step-0 gradient {k} bf16 (largest {float(want[k].abs().max()):.3e}): "
              f"kernels vs plain max_abs={gap:.3e}; the control, plain bf16 vs plain f32, "
              f"{control:.3e} (ratio {ratio:.3f}; limit 1)")
        if not gap <= control:
            raise AssertionError(f"{name} step-0 gradient {k}: the bf16 kernel path lies "
                                 f"further from the plain path than bf16 rounding puts it "
                                 f"from f32")
    print(f"  {name} step-0 bf16 gradients: the largest ratio to the control {worst:.3f}")
    return out


def train_and_time(name, ir, padding, arrays, meta, card, counts, add, steps, want_counts,
                   noise=0.0, hold=True, hold_bf16=False, edge_messages=None) -> dict:
    """`steps` bf16 steps through `Trainer` on the card, each with its launch
    counts; finite losses, the last below the first; with `hold` the step-0
    loss and gradients against the plain path in f32 first, with `hold_bf16`
    the step-0 gradients in bf16 too; then the step time, edge-messages per
    second, device busy and peak memory."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
    if trainer.device.type != "cuda":
        raise AssertionError(f"{name}: the trainer chose {trainer.device}, not the card")
    batch = to_device(arrays, trainer.device)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    held = {}
    if hold:
        init_tree, _, cpu_f32 = step0_gradients_vs_plain(name, ir, padding, arrays, meta, state,
                                                         batch, noise=noise)
        if hold_bf16:
            held = dict(step0_bf16_gradients=step0_bf16_gradients_vs_plain(
                name, ir, padding, arrays, meta, state, batch, init_tree, cpu_f32))
    step = trainer.train_step_fn(meta)
    totals = []
    for i in range(steps):
        counts.reset()
        state, m = step(state, batch)
        got = counts.read()
        add(got)
        expect_counts(f"{name} training step {i}", counts, **want_counts)
        totals.append(float(m["total"]))
    print(f"  {name} training: loss+reg " + " ".join(f"{t:.5f}" for t in totals))
    if not all(np.isfinite(totals)):
        raise AssertionError(f"{name} training: a loss is not finite")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"{name} training: the loss did not fall: {totals}")
    if state.step != steps:
        raise AssertionError(f"{name} training: the state counts {state.step} steps")
    return dict(losses=totals, **held, **time_training_step(
        name, step, state, batch, arrays, card, edge_messages=edge_messages))


def check_kernels_on_batch(dev, rng, name, kind, ir, params, arrays, meta) -> dict:
    """Kernels A, the id-keyed kernel, D and E held to their plain versions
    (phase 2's checks) on this training batch's own index arrays, at the
    shapes the model gives them. Over the block incidence: D and E at the
    state width. Over the row pointers: A at the state width (the sums), for
    graphprop also at 8 (the attention's denominators and the transpose of
    its destination-score gather), and after the batch's source sort (the
    transposes of the source gathers). graphprop's mean pooling: the
    id-keyed kernel over the ids `graph_pool` derives (`_pool_ids`, the
    trailing padding keyed past the last graph), at the embedding's width
    and the mask column."""
    from ignnition_tpu_torch.ops import segment as seg

    a, n, hs = NODE_ADJ, meta.nodes("node"), ir.state_dims()["node"]
    both = (torch.bfloat16, torch.float32)
    out = {}
    if f"inc_blocks_{a}" in arrays:
        # phase 2 holds the launches a call by the profiler
        out["blocks"] = check_flash_gat(dev, rng, name, np.asarray(arrays[f"inc_blocks_{a}"]),
                                        hs, both, torch.int8, True, profiled=False)
    else:
        e = arrays[f"dst_{a}"].shape[0]
        case = case_of_row_ptr(arrays[f"row_ptr_{a}"], e)
        out["csr"] = check_segment_sums(dev, rng, f"{name} sums", e, n, hs, case=case,
                                        timed=True)
        check_segment_sums(dev, rng, f"{name} source gathers' transpose", e, n, hs,
                           gathered=True, case=case_of_row_ptr(arrays[f"src_row_ptr_{a}"], e),
                           perm=arrays[f"src_perm_{a}"])
        if kind == "graphprop":
            check_segment_sums(dev, rng, f"{name} attention denominators", e, n, 8, case=case)
    if kind == "graphprop":
        ids = seg._pool_ids(torch.from_numpy(arrays["graph_id_node"]).to(dev), meta.num_graphs,
                            torch.from_numpy(arrays["node_mask_node"]).to(dev))
        width = params["readout"]["op0"]["layers"][-1]["kernel"].shape[1] + 1
        out["pooling"] = check_segment_sums(
            dev, rng, f"{name} mean pooling", n, meta.num_graphs, width, timed=True,
            case=case_of_ids(ids.cpu().numpy(), meta.num_graphs))
    return out


def homogeneous(dev, card: str) -> dict:
    """graphprop on a CSR batch and on a block batch, linkpred on a CSR batch,
    each served (2 requests) and trained (5 bf16 steps) at 1,024 graphs a
    batch."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.data.graph import merge_metas

    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    rng, check_rng = np.random.default_rng(SEED + 4), np.random.default_rng(SEED + 6)
    padding = igt.PaddingConfig()
    result, checked, served, samples = {}, {}, {}, {}
    cases = (("graphprop CSR", "graphprop", False), ("graphprop blocks", "graphprop", True),
             ("linkpred", "linkpred", False))
    for name, kind, equal in cases:
        ir = example_ir(kind)
        params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
        t0 = time.perf_counter()
        requests = [homogeneous_samples(
            rng, ir, kind, [BLOCK_GRAPH_NODES] * HOMOGENEOUS_GRAPHS if equal else
            rng.integers(GRAPH_NODES[0], GRAPH_NODES[1] + 1, size=HOMOGENEOUS_GRAPHS))
            for _ in range(HOMOGENEOUS_REQUESTS)]
        batches = [igt.build_batch(r, ir, padding, training=False) for r in requests]
        meta = merge_metas([m for _, m in batches])
        server = igt.ServingModel(igt.build(ir), params, meta, ir,
                                  compute_dtype=torch.bfloat16, device=dev)
        arrays = server.build_batch(requests[0])
        for a_ in (arrays, *(b for b, _ in batches)):
            check_graph_ids(name, a_)
        nodes = int(np.sum(arrays["node_mask_node"] > 0))
        edges = int(np.sum(arrays[f"edge_mask_{NODE_ADJ}"] > 0))
        lowering = ("block-diagonal incidence " + str(arrays[f"inc_blocks_{NODE_ADJ}"].shape)
                    if f"inc_blocks_{NODE_ADJ}" in arrays else
                    "dense incidence" if f"dense_inc_{NODE_ADJ}" in arrays else
                    f"CSR (row pointers; past the dense cap at {meta.nodes('node')}^2)")
        print(f"[homogeneous] {name}: {HOMOGENEOUS_GRAPHS} graphs, {nodes} nodes, {edges} "
              f"directed edges in request 0 (padded to {meta.nodes('node')} nodes, "
              f"{meta.edges(NODE_ADJ)} edges); {lowering}; {ir.num_iterations} iterations, "
              f"hs={ir.state_dims()['node']}; samples made and batched in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        if equal != (f"inc_blocks_{NODE_ADJ}" in arrays) or f"dense_inc_{NODE_ADJ}" in arrays:
            raise AssertionError(f"{name}: the batch took the wrong lowering ({lowering})")
        fwd_counts = homogeneous_launches(kind, ir, arrays, training=False)

        def per_request(request, _kind=kind, _fwd=fwd_counts):
            if _kind == "graphprop":
                return len(request), _fwd
            return sum(len(s.adjacencies[NODE_ADJ].src_idx) for s in request), _fwd

        inputs = {k: v for k, v in arrays.items()
                  if k not in ("label", "label_mask", "label_perm")}
        result[name] = dict(serving=serve_and_time(
            name, server, requests, to_device(inputs, dev), card, counts, add, per_request))
        result[name]["bf16_forward"] = homogeneous_vs_plain_forward(
            name, server, ir, params, requests[0], dev)
        served[name] = (ir, params, meta, requests[0])  # phase 11's artifacts
        samples[name] = (ir, requests)  # phase 14's batches and second requests

        t0 = time.perf_counter()
        t_arrays, t_meta = igt.build_batch(requests[0], ir, padding, training=True)
        print(f"[homogeneous] {name}: build_batch(training=True) "
              f"{time.perf_counter() - t0:.2f} s (host, native helpers)")
        check_graph_ids(name, t_arrays)
        checked[name] = check_kernels_on_batch(dev, check_rng, name, kind, ir, params,
                                               t_arrays, t_meta)
        passes = sum(len(mp.sources) for stage in ir.stages for mp in stage.passes)
        result[name]["training"] = train_and_time(
            name, ir, padding, t_arrays, t_meta, card, counts, add, HOMOGENEOUS_TRAIN_STEPS,
            homogeneous_launches(kind, ir, t_arrays, training=True),
            noise=1e-7 if kind == "graphprop" else 0.0, hold_bf16=True,
            edge_messages=ir.num_iterations * passes * edges)
    print("[homogeneous] main path launch counts: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, kernels_at_batch_shapes=checked, served=served,
                samples=samples, **result)


def check_kernels_at_x8(dev, rng, arrays, meta) -> dict:
    """B, C and A held to their plain versions at flagship_x8's shapes: B
    and C at [8, paths, 32]; A at stage 2's sum on the batch's own row
    pointers, at its transpose's (the source sort) where the batch has no
    out-degree slice map, and over the batch's own slice-sort windows.
    Returns {kernel name: {dtype: {"max_abs_err": ...}}}."""
    a1, a2 = "adj_links_paths", "adj_paths_links"
    n_links, n_paths, e = meta.nodes("link"), meta.nodes("path"), arrays[f"dst_{a2}"].shape[0]
    path_len = arrays[f"slice_src_{a1}"].shape[0]
    held = check_gru_at(dev, rng, "flagship_x8", path_len, n_paths, HS, HS)
    out = {k: {dt: dict(max_abs_err=v) for dt, v in errs.items()} for k, errs in held.items()}
    out["csr_segment_sum"] = check_segment_sums(
        dev, rng, "flagship_x8 stage 2", e, n_links, HS,
        case=case_of_row_ptr(arrays[f"row_ptr_{a2}"], e))["csr"]
    if f"bwd_slice_dst_{a2}" not in arrays:
        check_segment_sums(dev, rng, "flagship_x8 stage 2's transpose", e, n_paths, HS,
                           case=case_of_row_ptr(arrays[f"src_row_ptr_{a2}"], e))
    comp = {k: arrays[f"{k}_{a1}"] for k in ("slice_sort_row_ptr", "slice_sort_perm")}
    out["csr_segment_sum_windows"] = check_segment_sum_windows(
        dev, rng, n_paths, path_len, n_links, comp=comp)
    return out


def item1_sizes(dev, card: str) -> dict:
    """The flagship model at bench.py's blocks_g4 and flagship_x8 shapes:
    one request and 2 bf16 steps each, with finite values, a falling loss
    and the launch counts. First, at x8, B, C and A held to their plain
    versions at its shapes (blocks_g4's are phase 2's: [8,16384,32] and
    [131072,32] -> [2048,32]); at both, the step-0 loss and every gradient
    leaf held to the plain path in f32 at `ITEM1_CHECK_ITERATIONS` (full
    width, depth cut). At 8 iterations the random-weight flagship amplifies
    f32 rounding: on an NVIDIA H100 80GB HBM3 at 700 W, blocks_g4's step-0
    gradient of `path_update/kernel` (largest entry ~1e3) lies 2.9e-4 of
    that entry from the plain path's f64, where the plain f32 (the CPU) lies
    5.4e-5 from it. `spread_by_operation` found the block product carrying
    most of that (a library f32 matmul over 4,096-long sums: computed in f64
    on the card, the gap falls to 1.0e-4), none of B, C and A. So at that
    depth blocks_g4's gradients are held to a control measured in the same
    run: no further from f64 than `F32_SPREAD_MULTIPLE` times the plain
    f32's own distance."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 5)
    result = {}
    for name, (size, graphs, per_graph) in ITEM1_SIZES.items():
        padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256,
                                    per_graph=per_graph)
        samples = [make_sample(rng, **size) for _ in range(graphs)]
        arrays, meta = igt.build_batch(samples, ir, padding, training=True)
        a1, a2 = "adj_links_paths", "adj_paths_links"
        incidence = f"inc_blocks_{a2}" in arrays or f"dense_inc_{a2}" in arrays
        sliced = f"bwd_slice_dst_{a2}" in arrays
        windows = (arrays[f"slice_sort_row_ptr_{a1}"].shape[0] - 1) // meta.nodes("link")
        print(f"[item 1] {name}: {graphs} graph(s) of {size}, stage 2 "
              + ("a block-diagonal product " + str(arrays[f"inc_blocks_{a2}"].shape)
                 if f"inc_blocks_{a2}" in arrays else "a dense product" if incidence
                 else "gather + kernel A") + f", {windows} slice-sort window(s)")
        if name == "blocks_g4" and f"inc_blocks_{a2}" not in arrays:
            raise AssertionError("blocks_g4: stage 2 is not a block product")
        if name == "flagship_x8" and (incidence or windows < 2):
            raise AssertionError("flagship_x8: expected the CSR sum and the windowed sort")
        cut = igt.parse_model_description(
            flagship_description(num_iterations=ITEM1_CHECK_ITERATIONS), FEATURE_DIMS)
        cut_arrays, cut_meta = igt.build_batch(samples, cut, padding, training=True)
        cut_trainer = igt.Trainer(igt.build(cut), padding, compute_dtype=None)
        step0_gradients_vs_plain(
            f"{name} ({ITEM1_CHECK_ITERATIONS} iterations)", cut, padding, cut_arrays, cut_meta,
            cut_trainer.init_state(torch.Generator().manual_seed(SEED)),
            to_device(cut_arrays, cut_trainer.device))
        if name == "flagship_x8":
            result[name] = dict(kernels_at_its_shapes=check_kernels_at_x8(dev, rng, arrays, meta))
        else:
            spread = gradient_spread(dev, ir, params, arrays, meta, padding)
            limit = F32_SPREAD_MULTIPLE * spread["gradients_plain_f32_vs_f64"]
            print(f"[item 1] {name} step-0 gradients, f32, {ITERATIONS} iterations (of each "
                  f"leaf's largest entry, the worst leaf): kernels vs plain "
                  f"{spread['gradients_kernel_vs_plain']:.3e}, kernels vs plain f64 "
                  f"{spread['gradients_kernel_vs_plain_f64']:.3e} (limit {limit:.3e}: "
                  f"{F32_SPREAD_MULTIPLE} x the control), control plain f32 vs plain f64 "
                  f"{spread['gradients_plain_f32_vs_f64']:.3e}")
            if not spread["gradients_kernel_vs_plain_f64"] <= limit:
                raise AssertionError(
                    f"{name}: the kernel path's f32 step-0 gradients lie "
                    f"{spread['gradients_kernel_vs_plain_f64']:.3e} from the plain f64, past "
                    f"{F32_SPREAD_MULTIPLE} x the plain f32's {spread['gradients_plain_f32_vs_f64']:.3e}")
            result[name] = dict(f32_spread=spread)
        fwd_a = 0 if incidence else ITERATIONS
        server = igt.ServingModel(igt.build(ir), params, meta, ir,
                                  compute_dtype=torch.bfloat16, device=dev)
        inputs = {k: v for k, v in server.build_batch(samples).items()
                  if k not in ("label", "label_mask")}
        n_paths = graphs * size["n_paths"]
        result[name]["serving"] = serve_and_time(
            name, server, [samples], to_device(inputs, dev), card, counts, add,
            lambda request: (n_paths, dict(csr_segment_sum=fwd_a,
                                           masked_gru_scan=ITERATIONS)))
        # kernel A as in phase 4: the slice gather's backward but for the
        # first iteration (windows in one launch), and past the cap stage 2's
        # forward and, without the out-degree slice map, its backward
        want_a = (ITERATIONS - 1) + (0 if incidence else ITERATIONS * (1 if sliced else 2))
        result[name]["training"] = train_and_time(
            name, ir, padding, arrays, meta, card, counts, add, ITEM1_TRAIN_STEPS,
            dict(csr_segment_sum=want_a,
                 csr_segment_sum_windows=ITERATIONS - 1 if windows > 1 else 0,
                 masked_gru_scan=ITERATIONS, masked_gru_scan_bwd=ITERATIONS), hold=False)
    print("[item 1] main path launch counts: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, **result)


def _gru_scan_swapped(forward_plain: bool, backward_plain: bool, f64: bool = False):
    """`masked_gru_scan` with kernel B and/or kernel C replaced by its plain
    version on the card (with `f64`, both computed in float64 and rounded
    back to the input dtype)."""
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk

    names = ("kernel", "recurrent_kernel", "bias")

    def plain(xs, lens, h0, params):
        if not f64:
            return rk.masked_gru_scan_plain(xs, lens, h0, params)
        dt = xs.dtype
        return rk.masked_gru_scan_plain(
            xs.double(), lens, h0.double(), {k: params[k].double() for k in names}).to(dt)

    class Swapped(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xs, lens, h0, wx, wh, b):
            ctx.save_for_backward(xs, lens, h0, wx, wh, b)
            if forward_plain:
                return plain(xs, lens, h0, dict(zip(names, (wx, wh, b))))
            return rk._launch_forward(*(t.contiguous() for t in (xs, lens, h0, wx, wh, b)))

        @staticmethod
        def backward(ctx, ct):
            xs, lens, h0, wx, wh, b = ctx.saved_tensors
            if backward_plain:
                with torch.enable_grad():
                    leaves = [t.detach().requires_grad_(True) for t in (xs, h0, wx, wh, b)]
                    out = plain(leaves[0], lens, leaves[1], dict(zip(names, leaves[2:])))
                    g = torch.autograd.grad(out, leaves, ct.to(out.dtype))
                return g[0], None, g[1], g[2], g[3], g[4]
            d_xs, d_h0, d_wx, d_wh, d_b = rk._launch_backward(
                *(t.contiguous() for t in (xs, lens, h0, wx, wh, b)), ct.to(xs.dtype).contiguous())
            return d_xs, None, d_h0, d_wx, d_wh, d_b

    def scan(xs, lens, h0, params):
        if forward_plain and backward_plain:
            return plain(xs, lens, h0, params)
        dt = xs.dtype
        wx, wh, b = (params[k].to(dt) for k in names)
        return Swapped.apply(xs, lens.to(torch.int32), h0.to(dt), wx, wh, b)

    return scan


def spread_by_operation() -> None:
    """Which operation on the card carries the f32 gradient gap of blocks_g4
    at 8 iterations (ROADMAP Queue 3): the step-0 gradients of the flagship
    model on phase 8's blocks_g4 batch, computed on the card with one
    operation at a time swapped for its plain version on the card (B, C, A in
    the slice gather's backward) or computed in float64 on the card (the
    block product, B and C, A), each printed as its distance from the plain
    path's f64 on the CPU beside the plain f32's own. Of each leaf's largest
    entry, the worst leaf. Run it as
    `python3 -c "import chip_smoke as c; c.spread_by_operation()"`."""
    import ignnition_tpu_torch as igt
    import ignnition_tpu_torch.nn.rnn as t_rnn
    import ignnition_tpu_torch.ops.segment as t_seg
    from ignnition_tpu_torch.ops.cuda import _build
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 5)  # item1_sizes' samples: blocks_g4 comes first
    size, graphs, per_graph = ITEM1_SIZES["blocks_g4"]
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256, per_graph=per_graph)
    samples = [make_sample(rng, **size) for _ in range(graphs)]
    arrays, meta = igt.build_batch(samples, ir, padding, training=True)
    ref = {name: _grads(ir, params, arrays, meta, padding, "cpu", cd)
           for name, cd in (("cpu", None), ("cpu f64", torch.float64))}

    def worst(g, against):
        return max((float((g[k] - v).abs().max() / v.abs().max()), k)
                   for k, v in ref[against].items())

    def blocks_f64(src_states, blocks, n_dst_pad):
        out = orig_blocks(src_states.double(), blocks.double(), n_dst_pad)
        return out.to(src_states.dtype)

    def windows_plain(data, row_ptr, n):
        return sk.sorted_segment_sum_csr_windows_plain(data, row_ptr, n)

    def windows_f64(data, row_ptr, n):
        return sk.sorted_segment_sum_csr_windows_plain(data.double(), row_ptr, n).float()

    orig_scan, orig_blocks = t_rnn.masked_gru_scan, t_seg.direct_segment_sum_blocks
    orig_windows = t_seg.sorted_segment_sum_csr_windows
    variants = {
        "kernels (as run)": {},
        "B plain on the card": dict(scan=_gru_scan_swapped(True, False)),
        "C plain on the card": dict(scan=_gru_scan_swapped(False, True)),
        "B and C plain on the card": dict(scan=_gru_scan_swapped(True, True)),
        "A plain on the card": dict(windows=windows_plain),
        "B, C and A plain on the card": dict(scan=_gru_scan_swapped(True, True),
                                             windows=windows_plain),
        "block product in f64 on the card": dict(blocks=blocks_f64),
        "B and C in f64 on the card": dict(scan=_gru_scan_swapped(True, True, f64=True)),
        "A in f64 on the card": dict(windows=windows_f64),
        "block product, B, C and A in f64 on the card": dict(
            blocks=blocks_f64, scan=_gru_scan_swapped(True, True, f64=True),
            windows=windows_f64),
    }
    print(f"[spread] blocks_g4, {ir.num_iterations} iterations, f32 step-0 gradients, of "
          f"each leaf's largest entry, the worst leaf; plain f32 (CPU) vs plain f64 (CPU): "
          f"{worst(ref['cpu'], 'cpu f64')[0]:.3e} ({worst(ref['cpu'], 'cpu f64')[1]})")
    for name, swap in variants.items():
        t_rnn.masked_gru_scan = swap.get("scan", orig_scan)
        t_seg.direct_segment_sum_blocks = swap.get("blocks", orig_blocks)
        t_seg.sorted_segment_sum_csr_windows = swap.get("windows", orig_windows)
        try:
            g = _grads(ir, params, arrays, meta, padding, dev, None)
        finally:
            t_rnn.masked_gru_scan, t_seg.direct_segment_sum_blocks = orig_scan, orig_blocks
            t_seg.sorted_segment_sum_csr_windows = orig_windows
        f64, leaf = worst(g, "cpu f64")
        print(f"[spread] {name}: vs plain f64 {f64:.3e} ({leaf}), vs plain f32 "
              f"{worst(g, 'cpu')[0]:.3e}")


# --------------------------------------------------------------------------
# phase 9: the entry points
# --------------------------------------------------------------------------

# the examples' RouteNet at the flagship widths over data of the port's
# `write_dataset`: 4 archives of 16 samples to train on, 1 of 16 to evaluate
# and predict; a batch of 8 is the flagship's 2,048 links and 16,384 paths
API_SAMPLE = dict(n_links=256, n_paths=2048, max_path_len=8)
API_BATCH = 8
API_STEPS = 32  # 4 epochs of 8 batches; the resumed run stops at 16 = 2 epochs
API_TIMED_STEPS = 40  # each pipeline run; the median interval of steps 10-40
API_ACCUM_GRAPHS = 32  # graphs an optimizer step in (c)
API_ACCUM_TIMED = 30  # steps timed per route and round, after 3 warm
API_E2E_STEPS = 3  # (e): f32 steps of the kernel path against the plain path
API_LR = 1e-3  # the description's learning rate (Adam moves an element at most 2 lr a step)
# (d): docs/ab_convergence_flagship.json's configuration
CONVERGENCE = dict(steps=600, batch=4, n_train=300, n_eval=100, per_archive=25,
                   sample=dict(n_links=24, n_paths=32, max_path_len=6), seed=0)
CONVERGENCE_R2_WITHIN = 0.03
CONVERGENCE_LAST50_WITHIN = 0.10


def convergence_description() -> dict:
    """The model of docs/ab_convergence_flagship.json (`tests/helpers.py`'s
    `routenet_description(8, 32)`): the flagship's message passing with a
    64-unit selu readout."""
    d = flagship_description()
    for nn in d["neural_networks"]:
        if nn["nn_name"] == "readout":
            nn["nn_name"] = "readout_model"
            nn["nn_architecture"] = [
                {"type_layer": "Dense", "units": 64, "activation": "selu",
                 "kernel_regularizer": 0.1},
                {"type_layer": "Dense", "units": 1, "activation": "None",
                 "kernel_regularizer": 0.01},
            ]
        else:
            nn["nn_name"] = "state_update"
    for stage in d["message_passing"]["stages"]:
        for mp in stage["stage_mp"]:
            mp["update"]["nn_name"] = "state_update"
    d["readout"][0]["nn_name"] = "readout_model"
    return d


class StepLosses(logging.Handler):
    """(loss, reg, total) of every step that `Trainer.train` logs; while it
    is open the package's log lines come here alone."""

    def __init__(self):
        super().__init__()
        self.rows, self.logger = [], logging.getLogger("ignnition_tpu_torch")

    def emit(self, record):
        if record.msg.startswith("step "):
            self.rows.append(tuple(float(a) for a in record.args[1:]))

    def __enter__(self):
        self.saved = self.logger.handlers, self.logger.level
        self.logger.handlers = [self]
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.handlers, level = self.saved
        self.logger.setLevel(level)


def quiet_train(trainer, state, data_dir, steps, **kw):
    """`trainer.train` with the package's INFO lines held back."""
    log = logging.getLogger("ignnition_tpu_torch")
    level = log.level
    log.setLevel(logging.WARNING)
    try:
        return trainer.train(state, data_dir, steps, **kw)
    finally:
        log.setLevel(level)


def leaf_gaps(got: dict, want: dict) -> dict:
    """Of each leaf's largest entry (of `want`), how far `got` lies from it."""
    f64 = lambda t: t.detach().cpu().double()
    return {k: float((f64(got[k]) - f64(v)).abs().max() / max(float(f64(v).abs().max()), 1e-30))
            for k, v in want.items() if isinstance(v, torch.Tensor)}


def api_verbs(dev, root: str, train_dir: str, eval_dir: str, counts, add) -> dict:
    """(a) and its launches: `create_model` from a train_options.ini ->
    `train_and_evaluate` (32 f32 steps) -> `Runner.evaluate` -> a resumed run
    (16 steps, then to 32 on the same run_dir) held to the run of 32 ->
    `predict` from the run's checkpoint (`warm_start_path`)."""
    import dataclasses

    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data import SampleSpec, iter_samples
    from ignnition_tpu_torch.examples import description
    from ignnition_tpu_torch.model.builder import flatten_params

    ini = os.path.join(root, "train_options.ini")
    with open(ini, "w") as f:
        f.write(f"[PATHS]\ntrain_dataset = {train_dir}\neval_dataset = {eval_dir}\n"
                f"predict_dataset = {eval_dir}\njson_path = {description('routenet')}\n"
                f"model_dir = {os.path.join(root, 'checkpoints')}\n"
                f"[TRAINING_OPTIONS]\nbatch_size = {API_BATCH}\ntrain_steps = {API_STEPS}\n"
                f"shuffle_train_samples = false\neval_samples = 2\neval_batch_size = 8\n"
                f"log_every = 8\n")
    model = igt.create_model(ini)
    cfg = model.config
    out = {}

    def verb(what, fn, **want):
        counts.reset()
        t1 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        got = counts.read()
        expect_counts(f"{what} ({seconds:.1f} s)", counts, **want)
        add(got)
        out[what] = dict(seconds=seconds, launches={k: v for k, v in got.items() if v})
        return result

    steps = API_STEPS
    state = verb("train_and_evaluate", lambda: igt.train_and_evaluate(
        model, run_dir=os.path.join(root, "run_32")),
        csr_segment_sum=7 * steps, masked_gru_scan=8 * steps, masked_gru_scan_bwd=8 * steps)
    if state.step != steps:
        raise AssertionError(f"train_and_evaluate ended at step {state.step}")
    metrics = verb("Runner.evaluate", lambda: igt.Runner(model).evaluate(state),
                   masked_gru_scan=8 * 2)
    print(f"[api] after {steps} f32 steps, Runner.evaluate (2 batches of 8, denormalized "
          "with exp): " + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items()))
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"evaluate: {metrics}")

    # resume: 16 steps, then a second run to 32 on the same run_dir
    run_b = os.path.join(root, "run_16_32")
    half = igt.Model(ir=model.ir, config=dataclasses.replace(cfg, train_steps=steps // 2))
    verb("train_and_evaluate to 16", lambda: igt.train_and_evaluate(half, run_dir=run_b),
         csr_segment_sum=7 * steps // 2, masked_gru_scan=4 * steps,
         masked_gru_scan_bwd=4 * steps)
    resumed = verb("train_and_evaluate resumed to 32",
                   lambda: igt.train_and_evaluate(model, run_dir=run_b),
                   csr_segment_sum=7 * steps // 2, masked_gru_scan=4 * steps,
                   masked_gru_scan_bwd=4 * steps)
    gaps = leaf_gaps(flatten_params(resumed.params), flatten_params(state.params))
    gaps.update({f"opt_state/{k}": v for k, v in leaf_gaps(
        flatten_params(resumed.opt_state), flatten_params(state.opt_state)).items()})
    worst = max(gaps, key=gaps.get)
    print(f"[api] resumed run (16, then to 32 on one run_dir) vs one run of 32: worst leaf "
          f"{worst} {gaps[worst]:.3e} of its largest entry (limit 1e-6), step {resumed.step}, "
          f"optimizer count {resumed.opt_state['count']}")
    if resumed.step != steps or resumed.opt_state["count"] != steps or not gaps[worst] <= 1e-6:
        raise AssertionError("the resumed run does not end where the single run does")

    cfg.warm_start_path = os.path.join(root, "run_32")
    preds = verb("predict", lambda: igt.predict(model), masked_gru_scan=8 * 16)
    direct = igt.Runner(model).predict(state)
    n_paths = [s.num_nodes["path"] for s in iter_samples(eval_dir, SampleSpec.from_ir(model.ir))]
    shapes_ok = [p.shape == (n,) and np.all(np.isfinite(p)) for p, n in zip(preds, n_paths)]
    gap = max(float(np.abs(p - q).max() / np.abs(q).max()) for p, q in zip(preds, direct))
    print(f"[api] predict (warm start from the run's checkpoint): {len(preds)} arrays for "
          f"{len(n_paths)} eval samples, of {sorted(set(p.shape[0] for p in preds))} paths "
          f"(the samples' {sorted(set(n_paths))}); against Runner.predict of the trained state "
          f"{gap:.3e} of the largest (limit 1e-6)")
    if len(preds) != len(n_paths) or not all(shapes_ok) or not gap <= 1e-6:
        raise AssertionError("predict: wrong count, shapes, values or checkpoint")
    out.update(loss=metrics["loss"], metrics=metrics, resume_worst_leaf=gaps[worst],
               predicted_arrays=len(preds))
    return model, out


def kernel_path_vs_plain_steps(dev, ir, train_dir: str) -> dict:
    """(e): the first `API_E2E_STEPS` f32 optimizer steps of (a)'s run
    (`Trainer.train`, shuffle off, from the Runner's seed-0 tree) on the card
    and on the CPU plain path, and on the plain path computing in f64 (f32
    masters) as the control. Held: each step's loss+reg, kernels vs plain, at
    1e-4; each parameter leaf no further from the f64 run than 1e-4 of its
    largest entry or, where the plain f32 run itself lies further,
    `F32_SPREAD_MULTIPLE` times the plain f32's distance. Adam divides each
    element's first moment by the root of its second, so after a few steps
    an element's update turns on the ratio of its gradients, and f32
    rounding (or, on elements whose true gradient is ~0, f32 noise of either
    sign) moves it by up to 2 lr a step in both paths."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.model.builder import flatten_params

    tree = igt.build(ir).init(torch.Generator().manual_seed(0))
    ends, losses = {}, {}
    for name, device, dtype in (("card", dev, None), ("plain", "cpu", None),
                                ("plain f64", "cpu", torch.float64)):
        trainer = igt.Trainer(igt.build(ir), compute_dtype=dtype, device=device)
        with StepLosses() as log:
            state = trainer.train(trainer.init_state(params=tree), train_dir, API_E2E_STEPS,
                                  batch_size=API_BATCH, shuffle=False, log_every=1)
        ends[name] = {k: v.detach().cpu() for k, v in flatten_params(state.params).items()}
        losses[name] = [row[2] for row in log.rows]
    compare(f"(e) loss+reg of {API_E2E_STEPS} f32 steps of train(), kernels vs plain (CPU)",
            torch.tensor(losses["card"]), torch.tensor(losses["plain"]), atol=0.0, rtol=1e-4,
            why="f32 sums in another order on each device")
    card_f64 = leaf_gaps(ends["card"], ends["plain f64"])
    plain_f64 = leaf_gaps(ends["plain"], ends["plain f64"])
    card_plain = leaf_gaps(ends["card"], ends["plain"])
    bad = {k: (v, plain_f64[k]) for k, v in card_f64.items()
           if not v <= max(1e-4, F32_SPREAD_MULTIPLE * plain_f64[k])}
    worst = max(card_plain, key=card_plain.get)
    ratio = max(card_f64, key=lambda k: card_f64[k] / max(plain_f64[k], 1e-30))
    print(f"[api] (e) {API_E2E_STEPS} f32 steps of train(), of each leaf's largest entry: "
          f"kernels vs plain worst {worst} {card_plain[worst]:.3e}; vs the plain f64 run, "
          f"kernels {card_f64[ratio]:.3e} against the plain f32's {plain_f64[ratio]:.3e} at "
          f"{ratio} (the largest ratio; limit the larger of 1e-4 and {F32_SPREAD_MULTIPLE} x "
          f"the plain f32's); losses " + " ".join(f"{t:.5f}" for t in losses["card"]))
    moved = max(float((ends["card"][k] - v).abs().max()) for k, v in ends["plain"].items())
    if bad or not moved <= 2 * API_LR * API_E2E_STEPS:
        raise AssertionError(f"(e): leaves past the limit (kernels vs f64, plain vs f64) {bad}; "
                             f"largest difference {moved:.3e}")
    return dict(worst_leaf_vs_plain=card_plain[worst], losses=losses["card"],
                worst_ratio_leaf=ratio, kernel_vs_f64=card_f64[ratio],
                plain_f32_vs_f64=plain_f64[ratio])


def pipeline_costs(ir, train_dir: str, card: str, edges_per_graph: float,
                   flagship_step_ms: float) -> dict:
    """(b): `Trainer.train` for 40 bf16 steps in four ways (the default
    stream, 4 input workers, batches cached on the device, and batches
    packed into pinned buffers and staged ahead on a side stream); each
    step's end stamped on the host clock after a device sync (an `eval_fn`
    called every step), the median and mean interval of steps 10-40 (a
    reader parses an archive of 16 samples at once, so a starved stream's
    intervals alternate long and short; the rate is the mean's) beside phase
    4's device-resident flagship step and `build_batch` of one batch. The runs
    that see the default stream's batches in its order (all but 4 workers,
    whose order is the threads') end with its parameters: held at 1e-6 of
    each leaf's largest entry."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data import SampleSpec, iter_samples
    from ignnition_tpu_torch.model.builder import flatten_params
    from ignnition_tpu_torch.training import capture

    samples = []
    for s in iter_samples(train_dir, SampleSpec.from_ir(ir)):
        samples.append(s)
        if len(samples) == API_BATCH:
            break
    built = build_batch_ms(f"api batch of {API_BATCH} samples", lambda: igt.build_batch(
        samples, ir, igt.PaddingConfig(), training=True)[0], card)
    messages = ITERATIONS * edges_per_graph * API_BATCH
    out = dict(build_batch_ms=built["build_batch_ms"], edge_messages_per_step=messages,
               phase4_flagship_step_ms=flagship_step_ms)
    ends = {}
    for name, kw in (("default stream", {}), ("input_workers 4", dict(input_workers=4)),
                     ('cache_batches "device"', dict(cache_batches="device")),
                     ('cache_batches "device", eager', dict(cache_batches="device")),
                     ("device_prefetch 2, pack_transfer", dict(device_prefetch=2,
                                                               pack_transfer=True))):
        trainer = igt.Trainer(igt.build(ir), compute_dtype=torch.bfloat16)
        if name in ("default stream", "input_workers 4"):
            # the stream alone, no step: what the host takes to read and
            # build a batch without the step's dispatch beside it
            # (the mean interval of batches 11-25: by then the 4 batches the
            # stream prefetched are spent; a reader parses an archive of 16
            # samples at once, so intervals alternate long and short)
            stream = trainer.batches(train_dir, API_BATCH, workers=kw.get("input_workers", 1))
            pulled = []
            for _ in range(25):
                next(stream)
                pulled.append(time.perf_counter())
            stream.close()
            alone = (pulled[-1] - pulled[9]) / 15 * 1e3
            print(f"[api] (b) {name}, the batch stream alone (batches(), no step): {alone:.2f} "
                  f"ms a batch (mean interval of batches 11-25, host clock)")
            out[f"{name}, stream alone"] = dict(batch_ms=alone)
        stamps = []

        def stamp(_state):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return {}

        # the loop's steps replay their CUDA graphs; the ", eager" run steps
        # op by op (phase 14 (d) sets the two side by side)
        with capture.eager() if name.endswith("eager") else contextlib.nullcontext():
            state = quiet_train(
                trainer, trainer.init_state(torch.Generator().manual_seed(SEED)), train_dir,
                API_TIMED_STEPS, batch_size=API_BATCH, shuffle=False, log_every=0,
                eval_fn=stamp, eval_secs=0, **kw)
        ends[name] = flatten_params(state.params)
        ms = float(np.median(np.diff(stamps[9:]))) * 1e3
        mean = (stamps[-1] - stamps[9]) / (len(stamps) - 10) * 1e3
        # the batch shapes the stream produced: one training-step key each,
        # captured at its second call, all reading the trainer's one set of
        # static input buffers
        keys = [c for k, c in trainer.graphs.captured.items() if k[0] == "train"]
        captured = sum(c.last in ("capture", "replay") for c in keys)
        static_mib = trainer.graphs.static_bytes() / 2**20
        print(f"[api] (b) {name}: step interval median {ms:.2f} ms, mean {mean:.2f} ms (steps "
              f"10-{API_TIMED_STEPS}, host clock, bf16), {messages / mean / 1e3:.1f} M "
              f"edge-messages/s at the mean; phase 4's device-resident flagship step "
              f"{flagship_step_ms:.2f} ms, build_batch of one batch "
              f"{built['build_batch_ms']:.1f} ms; {len(keys)} batch shapes (step keys) in "
              f"{API_TIMED_STEPS} steps, {captured} of them captured, static input buffers "
              f"{static_mib:.1f} MiB; {card}")
        out[name] = dict(step_ms=ms, mean_step_ms=mean, edge_messages_per_s=messages / mean * 1e3,
                         batch_shapes=len(keys), captured_shapes=captured,
                         static_inputs_mib=static_mib)
    for name in ('cache_batches "device"', 'cache_batches "device", eager',
                 "device_prefetch 2, pack_transfer"):
        gaps = leaf_gaps(ends[name], ends["default stream"])
        worst = max(gaps, key=gaps.get)
        print(f"[api] (b) {name} vs the default stream after {API_TIMED_STEPS} steps: worst leaf "
              f"{worst} {gaps[worst]:.3e} of its largest entry (limit 1e-6)")
        if not gaps[worst] <= 1e-6:
            raise AssertionError(f"(b) {name}: the parameters leave the default stream's")
    return out


def accumulation_vs_merging(ir, train_dir: str, card: str, edges: list) -> dict:
    """(c): 32 graphs an optimizer step, `accumulate_steps="auto"`
    (`_auto_accumulate`'s split of `_TARGET_MICROBATCH_EDGES`, stacked
    microbatches through `accum_train_step_fn`) against one merged batch
    (`train_step_fn`), bf16, both batches on the device. Both warmed, then
    timed in two rounds of 30 steps each (host clock, a device sync after
    every step); compared in edge-messages per second, since "auto" rounds
    32 graphs up to its even split."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.data import SampleSpec, iter_samples
    from ignnition_tpu_torch.parallel import stack_batches

    trainer = igt.Trainer(igt.build(ir), compute_dtype=torch.bfloat16)
    k, micro = trainer._auto_accumulate(train_dir, API_ACCUM_GRAPHS)
    samples = list(iter_samples(train_dir, SampleSpec.from_ir(ir)))
    merged, merged_meta = igt.build_batch(samples[:API_ACCUM_GRAPHS], ir, trainer.padding,
                                          training=True)
    stacked, stacked_meta = stack_batches(
        [igt.build_batch(samples[i * micro:(i + 1) * micro], ir, trainer.padding, training=True)
         for i in range(k)], ir)
    if any(key.startswith("dense_inc_") for key in merged):
        raise AssertionError("(c): the merged batch is not past the dense cap")
    routes = {
        "merged": (trainer.train_step_fn(merged_meta), to_device(merged, trainer.device),
                   ITERATIONS * sum(edges[:API_ACCUM_GRAPHS])),
        "auto": (trainer.accum_train_step_fn(stacked_meta, k), to_device(stacked, trainer.device),
                 ITERATIONS * sum(edges[:k * micro])),
    }
    print(f"[api] (c) auto: _auto_accumulate({API_ACCUM_GRAPHS}) -> {k} microbatches of {micro} "
          f"graphs ({k * micro} graphs a step; _TARGET_MICROBATCH_EDGES "
          f"{trainer._TARGET_MICROBATCH_EDGES}, ~{np.mean(edges):.0f} edges a graph); merged: one batch "
          f"of {merged_meta.nodes('link')} links, {merged_meta.nodes('path')} paths")
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    times = {name: [] for name in routes}
    for rnd in range(3):
        for name, (step, batch, _) in routes.items():
            for _ in range(3 if rnd == 0 else API_ACCUM_TIMED):
                t1 = time.perf_counter()
                step(state, batch)
                torch.cuda.synchronize()
                if rnd:
                    times[name].append((time.perf_counter() - t1) * 1e3)
    out = {}
    for name, (_, _, messages) in routes.items():
        ms = float(np.median(times[name]))
        out[name] = dict(step_ms=ms, edge_messages_per_s=messages / ms * 1e3,
                         edge_messages_per_step=messages)
        print(f"[api] (c) {name}: step median {ms:.2f} ms ({2 * API_ACCUM_TIMED} steps, host "
              f"clock, bf16), {messages / ms / 1e3:.1f} M edge-messages/s; {card}")
    out["auto_over_merged"] = out["auto"]["edge_messages_per_s"] / out["merged"]["edge_messages_per_s"]
    out["split"] = dict(microbatches=k, graphs=micro)
    print(f"[api] (c) auto / merged, edge-messages/s: {out['auto_over_merged']:.3f}")
    return out


def convergence(root: str, card: str) -> dict:
    """(d): does bf16 converge as f32 does? docs/ab_convergence_flagship.json's
    configuration (the same synthetic data, written by the port's copy of
    `write_dataset` with that record's seeds): `Trainer.train` for 600 steps
    of batch 4, then `Trainer.evaluate` over the 100 eval graphs
    denormalized with exp, in bf16 and in f32 from the same seed-0 tree. The
    initial weights and the batch order are not the A/B's, so this holds
    convergence, not the trajectory: both R² within 0.03 of the JAX
    package's recorded bf16 R², bf16's mean loss+reg over its last 50 steps
    within 10% of f32's."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data import find_dataset_dimensions
    from ignnition_tpu_torch.data.synthetic import write_dataset

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                           "ab_convergence_flagship.json")) as f:
        record = json.load(f)
    c = CONVERGENCE
    train_dir, eval_dir = os.path.join(root, "conv_train"), os.path.join(root, "conv_eval")
    write_dataset(train_dir, c["n_train"] // c["per_archive"], c["per_archive"], seed=c["seed"],
                  **c["sample"])
    write_dataset(eval_dir, c["n_eval"] // c["per_archive"], c["per_archive"],
                  seed=c["seed"] + 1000, **c["sample"])
    ir = igt.parse_model_description(convergence_description(),
                                     find_dataset_dimensions(train_dir))
    tree = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    out = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        trainer = igt.Trainer(igt.build(ir), compute_dtype=dtype)
        t1 = time.perf_counter()
        with StepLosses() as losses:
            state = trainer.train(trainer.init_state(params=tree), train_dir, c["steps"],
                                  batch_size=c["batch"], shuffle=False, log_every=1)
        train_s = time.perf_counter() - t1
        m = trainer.evaluate(state, eval_dir, num_batches=c["n_eval"] // c["batch"],
                             batch_size=c["batch"], denormalization=igt.get_normalization("exp"),
                             label_name="delay")
        totals = [row[2] for row in losses.rows]
        last50 = float(np.mean(totals[-50:]))
        out[name] = dict(r2=m["r-squared"], mae=m["mae"], mre=m["mre"], last50_loss=last50,
                         train_seconds=train_s)
        print(f"[api] (d) {name}: R² {m['r-squared']:.5f}, MAE {m['mae']:.6f}, MRE "
              f"{m['mre']:.5f}, mean loss+reg of the last 50 steps {last50:.6f} "
              f"({len(totals)} steps in {train_s:.1f} s); {card}")
    jax_r2 = record["repo"]["metrics"]["r2"]
    tf_r2 = record["reference"]["metrics"]["r2"]
    print(f"[api] (d) recorded (docs/ab_convergence_flagship.json): the JAX package in bf16 R² "
          f"{jax_r2:.5f}, last-50 {record['repo']['final_loss_mean_last50']:.6f}; the TF "
          f"reference R² {tf_r2:.5f}, last-50 {record['reference']['final_loss_mean_last50']:.6f}")
    gap = abs(out["bf16"]["last50_loss"] - out["f32"]["last50_loss"]) / out["f32"]["last50_loss"]
    print(f"[api] (d) held: |R² - {jax_r2:.5f}| <= {CONVERGENCE_R2_WITHIN} for both; bf16's "
          f"last-50 within {CONVERGENCE_LAST50_WITHIN:.0%} of f32's ({gap:.1%}). Other initial "
          "weights and batch order than the A/B's: convergence is held, not the trajectory")
    for name in ("bf16", "f32"):
        if not abs(out[name]["r2"] - jax_r2) <= CONVERGENCE_R2_WITHIN:
            raise AssertionError(f"(d) {name}: R² {out[name]['r2']:.5f}")
    if not gap <= CONVERGENCE_LAST50_WITHIN:
        raise AssertionError(f"(d): bf16's last-50 loss lies {gap:.1%} from f32's")
    out.update(jax_bf16_r2=jax_r2, tf_r2=tf_r2, last50_gap=gap)
    return out


# (g): docs/ab_convergence_qsize.json's configuration
QSIZE_RECORD = dict(steps=3000, batch=4, n_train=300, n_eval=100, per_archive=25,
                    sample=dict(n_links=14, n_paths=18, max_path_len=5), seed=0)


def qsize_record_description() -> dict:
    """The model of docs/ab_convergence_qsize.json (`tests/helpers.py`'s
    `qsize_description(4, 16)`): Q-size's interleave of link and node states
    into each path's sequence and its sums into links and nodes, features as
    they are, the log of the delay as the label, a 64-unit selu readout and
    Adam at 1e-3 under the examples' slow ExponentialDecay."""
    d = qsize_description(num_iterations=4, hs=16)
    for entity in d["entities"]:
        for feature in entity["features"]:
            feature.pop("normalization")
    d["readout"][0].update(label_normalization="log", nn_name="readout_model")
    dense = lambda units, act, reg: {"type_layer": "Dense", "units": units,  # noqa: E731
                                     "activation": act, "kernel_regularizer": reg}
    d["neural_networks"] = [
        {"nn_name": "readout_model", "nn_type": "feed_forward",
         "nn_architecture": [dense(64, "selu", 0.1), dense(1, "None", 0.01)]},
        {"nn_name": "state_update", "nn_type": "recurrent_neural_network",
         "recurrent_type": "GRU"}]
    for stage in d["message_passing"]["stages"]:
        for mp in stage["stage_mp"]:
            mp["update"]["nn_name"] = "state_update"
    d["learning_options"]["optimizer"]["schedule"] = {
        "type": "ExponentialDecay", "initial_learning_rate": 0.001, "decay_steps": 80000,
        "decay_rate": 0.6}
    return d


def qsize_record(root: str, card: str, seed: int = SEED, hold: bool = True) -> dict:
    """(g): the interleave against a record of the TF reference.
    docs/ab_convergence_qsize.json holds the reference's Q-size run (hs 16,
    4 iterations, 3,000 steps of batch 4 over 300 graphs of 14 links and 18
    paths with nodes, Adam 1e-3): R² and the mean loss+reg of its last 50
    steps. The same configuration through the port's `Trainer.train` in f32
    (the data from the port's copy of `write_dataset` with the record's
    seeds; batches cached on the device, so that the graphs replay), then
    `Trainer.evaluate` over the 100 eval graphs denormalized with exp.
    `seed` draws the initial weights and shuffles the batch stream, so that
    a run repeats (`qsize_record_spread` reads the spread over seeds). The
    initial weights and the batch order are not the A/B's: held (`hold`)
    are R² at least the reference's less 0.03 and the last-50 mean within
    10% of the reference's."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data import find_dataset_dimensions
    from ignnition_tpu_torch.data.synthetic import write_dataset

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                           "ab_convergence_qsize.json")) as f:
        record = json.load(f)
    c = QSIZE_RECORD
    want = {k: record["config"][k] for k in ("steps", "batch", "n_train", "n_eval", "seed")}
    if want != {k: c[k] for k in want} or record["config"]["hs"] != 16 or \
            record["config"]["iters"] != 4:
        raise AssertionError(f"(g) docs/ab_convergence_qsize.json's configuration "
                             f"{record['config']} is not the one run here")
    train_dir, eval_dir = os.path.join(root, "qsize_train"), os.path.join(root, "qsize_eval")
    write_dataset(train_dir, c["n_train"] // c["per_archive"], c["per_archive"], seed=c["seed"],
                  with_nodes=True, **c["sample"])
    write_dataset(eval_dir, c["n_eval"] // c["per_archive"], c["per_archive"],
                  seed=c["seed"] + 1000, with_nodes=True, **c["sample"])
    ir = igt.parse_model_description(qsize_record_description(),
                                     find_dataset_dimensions(train_dir))
    trainer = igt.Trainer(igt.build(ir))
    t0 = time.perf_counter()
    with StepLosses() as losses:
        state = trainer.train(trainer.init_state(torch.Generator().manual_seed(seed)), train_dir,
                              c["steps"], batch_size=c["batch"], shuffle=True, log_every=1,
                              cache_batches="device", seed=seed)
    train_s = time.perf_counter() - t0
    m = trainer.evaluate(state, eval_dir, num_batches=c["n_eval"] // c["batch"],
                         batch_size=c["batch"], denormalization=igt.get_normalization("exp"),
                         label_name="delay")
    totals = [row[2] for row in losses.rows]
    last50 = float(np.mean(totals[-50:]))
    ref = record["reference"]
    ref_r2, ref_last50 = ref["metrics"]["r2"], ref["final_loss_mean_last50"]
    gap = abs(last50 - ref_last50) / ref_last50
    keys = len({k for k in trainer.graphs.captured if k[0] == "train"})
    print(f"[api] (g) Q-size, docs/ab_convergence_qsize.json's configuration, f32, seed "
          f"{seed}: R² "
          f"{m['r-squared']:.5f}, MAE {m['mae']:.6f}, MRE {m['mre']:.5f}, mean loss+reg of the "
          f"last 50 steps {last50:.6f} ({len(totals)} steps in {train_s:.1f} s, {keys} batch "
          f"shapes captured); the TF reference R² {ref_r2:.5f}, last-50 {ref_last50:.6f}; the "
          f"JAX package R² {record['repo']['metrics']['r2']:.5f}, last-50 "
          f"{record['repo']['final_loss_mean_last50']:.6f}; held: R² >= {ref_r2 - 0.03:.5f}, "
          f"last-50 within 10% of the reference's ({gap:.1%}); {card}")
    result = dict(r2=m["r-squared"], mae=m["mae"], mre=m["mre"], last50_loss=last50,
                  train_seconds=train_s, reference_r2=ref_r2, reference_last50=ref_last50,
                  last50_gap=gap, losses=totals)
    if not hold:
        return result
    if len(totals) != c["steps"]:
        raise AssertionError(f"(g) {len(totals)} steps logged, not {c['steps']}")
    if not m["r-squared"] >= ref_r2 - 0.03:
        raise AssertionError(f"(g) R² {m['r-squared']:.5f} below {ref_r2 - 0.03:.5f}")
    if not gap <= 0.10:
        raise AssertionError(f"(g) the last-50 loss lies {gap:.1%} from the reference's")
    return {k: v for k, v in result.items() if k != "losses"}


def qsize_record_spread(seeds: int = 10) -> None:
    """Phase 9 (g)'s run at seeds 0 .. seeds-1 and at seed 0 once more,
    without the other phases and without its holds: the spread of R² and
    of the last-50 gap over seeds, each run's margin to the holds, and
    whether a seed repeats its losses bitwise:
    `python3 -c "import chip_smoke as c; c.qsize_record_spread(10)"`."""
    import shutil
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    _build.library()
    root = tempfile.mkdtemp(prefix="chip_smoke_qsize_")
    try:
        runs = [qsize_record(os.path.join(root, str(i)), card, seed=seed, hold=False)
                for i, seed in enumerate(list(range(seeds)) + [0])]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gaps, r2 = [r["last50_gap"] for r in runs[:-1]], [r["r2"] for r in runs[:-1]]
    floor = runs[0]["reference_r2"] - 0.03
    print(f"[api] (g) over seeds 0-{seeds - 1}: last-50 gap {min(gaps):.2%} - {max(gaps):.2%} "
          f"(mean {np.mean(gaps):.2%}, sd {np.std(gaps, ddof=1):.2%}; held within 10%, "
          f"{sum(g > 0.10 for g in gaps)} past it); R² {min(r2):.5f} - {max(r2):.5f} (held "
          f">= {floor:.5f}, {sum(v < floor for v in r2)} below); seed 0 again: gap "
          f"{runs[-1]['last50_gap']:.2%}, losses bitwise equal to its first run: "
          f"{runs[-1]['losses'] == runs[0]['losses']}; {card}")
    print(json.dumps({"gaps": gaps, "r2": r2, "seed0_again": {
        "gap": runs[-1]["last50_gap"], "r2": runs[-1]["r2"],
        "bitwise": runs[-1]["losses"] == runs[0]["losses"]}, "card": card}))


def entry_points(dev, card: str, flagship_step_ms: float) -> dict:
    """Phase 9: the user's entry points on the examples' RouteNet
    (`examples/routenet/model_description.yaml`: hs=32, 8 iterations,
    256-256-1 selu readout) over data written by the port's `write_dataset`
    into a temporary directory: (a) the verbs and a resumed run, (e) the
    kernel path against the plain path over `train()`'s first steps, (f) the
    launch counts of every verb and the profile of a step, (b) what the input
    pipeline costs, (c) accumulation against merging, (d) convergence in
    bf16 and f32, (g) Q-size's interleave against the TF reference's record."""
    import shutil
    import tempfile

    import ignnition_tpu_torch as igt
    import ignnition_tpu_torch.examples.routenet  # noqa: F401 (normalization_routenet)
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.data import SampleSpec, iter_samples
    from ignnition_tpu_torch.data.synthetic import write_dataset

    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    root = tempfile.mkdtemp(prefix="chip_smoke_api_")
    try:
        t1 = time.perf_counter()
        train_dir, eval_dir = os.path.join(root, "train"), os.path.join(root, "eval")
        write_dataset(train_dir, 4, 16, seed=SEED, **API_SAMPLE)
        write_dataset(eval_dir, 1, 16, seed=SEED + 1000, **API_SAMPLE)
        print(f"[api] datasets written in {time.perf_counter() - t1:.1f} s: 4 x 16 and 1 x 16 "
              f"samples of {API_SAMPLE}")
        model, verbs = api_verbs(dev, root, train_dir, eval_dir, counts, add)
        ir = model.ir
        spec = SampleSpec.from_ir(ir)
        edges = [sum(len(a.src_idx) for a in s.adjacencies.values())
                 for s in iter_samples(train_dir, spec)]
        result = dict(verbs=verbs, edges_per_graph=float(np.mean(edges)))
        result["kernel_path_vs_plain"] = kernel_path_vs_plain_steps(dev, ir, train_dir)

        # (f) a profile of one f32 step and one forward at (a)'s batch
        trainer = igt.Trainer(igt.build(ir))
        state = trainer.init_state(torch.Generator().manual_seed(SEED))
        arrays, meta = next(trainer.batches(train_dir, API_BATCH, shuffle=False, repeat=False))
        batch = to_device(arrays, dev)
        step = trainer.train_step_fn(meta)
        forward = lambda: trainer.eval_step_fn(meta)(state.params, batch)
        for what, fn in (("f32 training step", lambda: step(state, batch)),
                         ("f32 evaluation forward", forward)):
            times = []
            for i in range(13):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                if i >= 3:
                    times.append(start.elapsed_time(end))
            result[what] = dict(ms=float(np.median(times)), **print_profile(
                f"api {what}", fn, float(np.median(times))))

        result["pipeline"] = pipeline_costs(ir, train_dir, card, result["edges_per_graph"],
                                            flagship_step_ms)
        result["accumulation"] = accumulation_vs_merging(ir, train_dir, card, edges)
        result["convergence"] = convergence(root, card)
        result["qsize_record"] = qsize_record(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("[api] main path launch counts: " + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, **result)


# --------------------------------------------------------------------------
# phase 10: the description language
# --------------------------------------------------------------------------

LANGUAGE_TRAIN_STEPS = 5
LANGUAGE_REFERENCE_STEPS = 3
OPTIMIZER_STEPS = 3
# (b): one case per optimizer kind and option, each under ExponentialDecay
OPTIMIZER_CASES = {
    "Adam": {"type": "Adam"},
    "Adam amsgrad": {"type": "Adam", "amsgrad": True},
    "AdamW": {"type": "AdamW", "weight_decay": 0.004},
    "SGD momentum nesterov": {"type": "SGD", "momentum": 0.9, "nesterov": True},
    "RMSprop": {"type": "RMSprop"},
    "RMSprop centered momentum": {"type": "RMSprop", "centered": True, "momentum": 0.9},
    "Adagrad": {"type": "Adagrad"},
    "Adadelta": {"type": "Adadelta"},
    "Adamax": {"type": "Adamax"},
    "Nadam": {"type": "Nadam"},
}
LANGUAGE_SCHEDULE = {"type": "ExponentialDecay", "initial_learning_rate": 0.001,
                     "decay_steps": 2, "decay_rate": 0.5}

TENSORBOARD = dict(samples=8, batch=2, steps=5)
BN_STATS = ("moving_mean", "moving_variance")


def chip_scale_init(generator, layer, in_dim):
    """`ChipScale`, the custom layer of (a): a trainable per-feature scale,
    initialized to the description's `gain`."""
    return {"scale": torch.full((in_dim,), float(layer.extra.get("gain", 1.0)))}, in_dim


def chip_scale_apply(layer, params, x, *, deterministic, generator):
    return x * params["scale"]


def layers_description(optimizer=None, num_iterations: int = ITERATIONS, hs: int = HS) -> dict:
    """The flagship with its 256-256-1 readout rewritten to use every
    built-in layer kind and the registered `ChipScale`; `optimizer` (a
    description's optimizer entry) replaces Adam, under `LANGUAGE_SCHEDULE`."""
    desc = flagship_description(num_iterations, hs)
    layer = lambda kind, **kw: {"type_layer": kind, **kw}
    next(n for n in desc["neural_networks"] if n["nn_name"] == "readout")["nn_architecture"] = [
        layer("Dense", units=256, activation="selu", kernel_regularizer=0.1),
        layer("LayerNormalization"),
        layer("Dropout", rate=0.1),
        layer("Dense", units=256, kernel_regularizer=0.1),
        layer("PReLU"),
        layer("BatchNormalization"),
        layer("ChipScale", gain=1.5),
        layer("Activation", activation="relu"),
        layer("AlphaDropout", rate=0.05),
        layer("GaussianNoise", stddev=0.01),
        layer("ReLU", max_value=6),
        layer("ELU"),
        layer("LeakyReLU"),
        layer("Dense", units=1, activation="None", kernel_regularizer=0.01),
    ]
    if optimizer is not None:
        desc["learning_options"]["optimizer"] = dict(optimizer, schedule=LANGUAGE_SCHEDULE)
    return desc


@contextlib.contextmanager
def plain_on_card():
    """The plain path on the card: the kernel switches at 'never'
    (`ops.segment.set_pallas_mode`, which D and E follow, and
    `rnn_kernels.set_mode`), so that every wrapper the model calls runs its
    plain version (the functions the CPU runs) and a run on the card draws
    its dropout masks from the same device generator as the kernel path.
    Under the pallas switch's 'never' the captured steps run eagerly on their
    own and say why (`CapturedStep.why_eager`): kernel A's plain sum reads a
    row pointer back to the host, which a capture cannot hold, and no graph
    captured from the kernel path stands in for a plain run."""
    from ignnition_tpu_torch.ops import cuda
    from ignnition_tpu_torch.ops import segment as t_seg
    from ignnition_tpu_torch.ops.cuda import rnn_kernels as rk

    saved = dict(cuda._MODES)
    t_seg.set_pallas_mode("never")
    rk.set_mode("never")
    try:
        yield
    finally:
        for switch, mode in saved.items():
            cuda.set_mode(switch, mode)


@contextlib.contextmanager
def kernel_switch(switch: str, mode: str):
    """One kernel switch (`ops.cuda`: 'pallas', 'flash-attn', 'fused-rnn')
    set for a block."""
    from ignnition_tpu_torch.ops import cuda

    saved = cuda._MODES[switch]
    cuda.set_mode(switch, mode)
    try:
        yield
    finally:
        cuda.set_mode(switch, saved)


@contextlib.contextmanager
def builder_switch(name: str, value):
    """One of `model.builder`'s lowering switches (`_SLOT_ATTN`,
    `_ITER_REMAT`: `model.builder.SWITCHES`) set for a block."""
    from ignnition_tpu_torch.model import builder

    saved = getattr(builder, name)
    setattr(builder, name, value)
    try:
        yield
    finally:
        setattr(builder, name, saved)


def step_launches(what, trainer, state, batch, meta, steps, counts, add, **want):
    """`steps` training steps, each one's launches held to `want`; returns
    the state and each step's (total, loss, reg)."""
    step, rows = trainer.train_step_fn(meta), []
    for i in range(steps):
        counts.reset()
        state, m = step(state, batch)
        got = counts.read()
        add(got)
        expect_counts(f"{what} step {i}", counts, **want)
        rows.append(tuple(float(m[k]) for k in ("total", "loss", "reg")))
    if not np.all(np.isfinite(rows)):
        raise AssertionError(f"{what}: a loss is not finite: {rows}")
    print(f"  {what}: loss+reg " + " ".join(f"{r[0]:.5f}" for r in rows))
    return state, rows


def serve_requests(what, server, samples, n_rows, counts, add, **want) -> None:
    """Answer each request, holding its launches to `want`."""
    for i, sample in enumerate(samples):
        counts.reset()
        preds = server.predict_samples([sample])
        got = counts.read()
        add(got)
        if preds.shape != (n_rows,) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"{what} request {i}: {preds.shape} or non-finite")
        expect_counts(f"{what} request {i} ({n_rows} predictions, mean {preds.mean():.5f})",
                      counts, **want)


def serving_times(what, server, sample, card, dev) -> dict:
    """Forward (CUDA events) and whole-request (host clock) medians and the
    forward's profile."""
    from ignnition_tpu_torch.batch import to_device

    arrays = server.build_batch([sample])
    inputs = to_device({k: v for k, v in arrays.items()
                        if k not in ("label", "label_mask")}, dev)
    fwd = forward_ms(server, inputs)
    e2e = []
    for _ in range(4):
        t1 = time.perf_counter()
        server.predict_samples([sample])
        e2e.append((time.perf_counter() - t1) * 1e3)
    out = dict(forward_ms=float(np.median(fwd)), request_ms=float(np.median(e2e[1:])))
    print(f"[latency] {what}: device forward median {out['forward_ms']:.3f} ms (20 runs, "
          f"CUDA events); whole request median {out['request_ms']:.1f} ms (3 runs, host "
          f"clock) on {card}")
    out.update(print_profile(f"{what} forward", lambda: server.forward_device(inputs),
                             out["forward_ms"]))
    return out


def flagship_layers(dev, card: str, counts, add) -> tuple:
    """(a): the flagship with every built-in layer kind and `ChipScale` in its
    readout. Serving (3 requests, kernels vs the plain path on the CPU in f32
    and bf16); the step-0 f32 gradients of the kernel path against the plain
    path, both on the card from one generator state (the same masks);
    `training=False` output independent of the generator; 5 bf16 steps with
    their launches (B x8, C x8, A x7 as the flagship's), step time and
    profile. Returns (result, (padding, the training arrays and meta, the
    initial tree))."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params

    ir = igt.parse_model_description(layers_description(), FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    kinds = [layer.kind for layer in ir.readout[0].mlp.layers]
    print(f"[language] (a) flagship readout: {' -> '.join(kinds)}")
    rng = np.random.default_rng(SEED + 6)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    out = {}

    samples = [make_sample(rng, **FLAGSHIP) for _ in range(N_FLAGSHIP_REQUESTS)]
    server = serve_one_size(dev, ir, params, samples, padding)
    serve_requests("(a) layers", server, samples, FLAGSHIP["n_paths"], counts, add,
                   masked_gru_scan=ITERATIONS)
    kernels_vs_plain_forward("(a) layers", server, ir, params, samples[0], dev,
                             (None, torch.bfloat16))
    out["serving"] = serving_times("(a) layers", server, samples[0], card, dev)

    arrays, meta = igt.build_batch([make_sample(rng, **FLAGSHIP)], ir, padding, training=True)
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
    batch = to_device(arrays, trainer.device)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))

    # step 0 in f32: kernels vs plain, both on the card, one generator state
    f32 = igt.Trainer(igt.build(ir), padding, compute_dtype=None)
    runs = {}
    for name, ctx in (("kernels", contextlib.nullcontext()), ("plain", plain_on_card()),
                      ("another seed", contextlib.nullcontext())):
        f32.generator.manual_seed(SEED + (name == "another seed"))
        counts.reset()
        with ctx:
            runs[name] = f32.grads_fn(meta)(state.params, batch)
        if name == "plain" and any(counts.read().values()):
            raise AssertionError(f"the plain path launched kernels: {counts.read()}")
    # the profiler too sees none of the port's kernels on the plain path (it
    # runs eagerly: no replayed graph stands in for it); a profile that lost
    # every device record is taken again, up to 3 times
    with plain_on_card():
        for _ in range(3):
            names = profiled_device_kernels(lambda: f32.grads_fn(meta)(state.params, batch), 1)
            if names:
                break
    ours = sorted({n for n in names if any(k in n for k in ALL_PORT_KERNELS)})
    print(f"  (a) the plain path on the card: {len(names)} device kernels a gradient call, "
          f"{len(ours)} of them the port's (torch.profiler)")
    if ours or not names:
        raise AssertionError(f"(a) the plain path's profile: {len(names)} kernels, the port's "
                             f"{ours}")
    (g_k, m_k), (g_p, m_p), (g_o, m_o) = runs.values()
    compare("(a) step-0 loss+reg, kernels vs plain (card, one generator state) f32",
            m_k["total"], m_p["total"], atol=1e-4, rtol=1e-4,
            why="f32 sums in another order; the same dropout masks and noise")
    want = flatten_params(g_p)
    for k, g in flatten_params(g_k).items():
        top = float(want[k].abs().max())
        compare(f"(a) step-0 gradient {k} (largest entry {top:.3e})", g, want[k],
                atol=1e-4 * top + 1e-7, rtol=1e-3,
                why="f32 sums in another order; 1e-4 of the leaf's largest entry")
        if k.split("/")[-1] in BN_STATS and g.any():
            raise AssertionError(f"{k}: a moving statistic has a non-zero gradient")
    print(f"  (a) another generator seed: loss+reg {float(m_o['total']):.6f} against "
          f"{float(m_k['total']):.6f} (other masks)")
    if float(m_o["total"]) == float(m_k["total"]):
        raise AssertionError("(a): the training loss does not depend on the masks")
    with torch.no_grad():
        outs = [trainer.model.apply(state.params, batch, meta, compute_dtype=torch.bfloat16,
                                    generator=g)
                for g in (None, torch.Generator(dev).manual_seed(1),
                          torch.Generator(dev).manual_seed(2))]
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError("(a): training=False output depends on the generator")
    print("  (a) training=False: the same predictions with no generator and with two seeds")

    init = {k: v.detach().clone() for k, v in flatten_params(state.params).items()}
    a = "adj_links_paths"
    windows = (arrays[f"slice_sort_row_ptr_{a}"].shape[0] - 1) // meta.nodes("link")
    trainer.generator.manual_seed(SEED)
    state, rows = step_launches(
        "(a) layers training", trainer, state, batch, meta, LANGUAGE_TRAIN_STEPS, counts, add,
        csr_segment_sum=ITERATIONS - 1,
        csr_segment_sum_windows=ITERATIONS - 1 if windows > 1 else 0,
        masked_gru_scan=ITERATIONS, masked_gru_scan_bwd=ITERATIONS)
    now = flatten_params(state.params)
    for k, v in init.items():
        moved = not torch.equal(now[k].detach(), v)
        if moved == (k.split("/")[-1] in BN_STATS):
            raise AssertionError(f"(a) {k}: moved {moved} under Adam")
    print("  (a) every leaf moved but the moving statistics, which Adam leaves where they are")
    out["training"] = dict(losses=[r[0] for r in rows], **time_training_step(
        "(a) layers", trainer.train_step_fn(meta), state, batch, arrays, card))
    return out, (padding, arrays, meta, params)


def optimizers(dev, counts, add, padding, arrays, meta, tree) -> dict:
    """(b): each case of `OPTIMIZER_CASES` trains (a)'s model 3 f32 steps on
    (a)'s batch on the card from one tree and one generator state: the
    kernel path, and the plain path on the card in f32 and in f64 (f32
    masters). Held: the optimizer on the card, a copy of it over f64
    masters and f64 state taking the kernel path's gradients step by step,
    every leaf of the f32 run within 1e-5 of its largest entry of the f64
    copy's (the CPU tests' limit against optax), and the moving statistics
    exact: still under every kind but AdamW, whose decay scales them by
    (1 - lr_t wd) a step. Printed, not held: phase 9 (e)'s rule (each leaf
    of the kernel path within 1e-4 of its largest entry of the f64 run's,
    or `F32_SPREAD_MULTIPLE` times the plain f32's distance), and each
    step's gradient distance of both f32 paths from the f64 run at the
    worst leaf. The rule's control computes the f64 run's own algorithm in
    f32, while kernels B and C compute in another order, so that the kernel
    path's gradients can lie several times further from f64 at a leaf; the
    normalizing optimizers carry that into the parameters, and the rule's
    verdict then turns on the leaf (PERF.md §6)."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.frontend.ir import ScheduleSpec
    from ignnition_tpu_torch.model.builder import flatten_params, map_params
    from ignnition_tpu_torch.training.optimizers import build_schedule

    batch = to_device(arrays, dev)
    init = {k: v.detach().cpu() for k, v in flatten_params(tree).items()}
    schedule = build_schedule(ScheduleSpec(kind="ExponentialDecay", params={
        k: v for k, v in LANGUAGE_SCHEDULE.items() if k != "type"}))
    out = {}
    for case, optimizer in OPTIMIZER_CASES.items():
        ir = igt.parse_model_description(layers_description(optimizer), FEATURE_DIMS)
        ends, grads = {}, {}
        for name, ctx, dtype in (("kernels", contextlib.nullcontext(), None),
                                 ("plain", plain_on_card(), None),
                                 ("plain f64", plain_on_card(), torch.float64)):
            trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=dtype)
            state = trainer.init_state(params=tree)
            tx = trainer.optimizer
            if name == "kernels":
                shadow = map_params(lambda v: v.detach().to(torch.float64), state.params)
                shadow_state = tx.init(shadow)
            trainer.generator.manual_seed(SEED)
            grads_fn, grads[name] = trainer.grads_fn(meta), []
            counts.reset()
            with ctx:
                for _ in range(OPTIMIZER_STEPS):
                    g, m = grads_fn(state.params, batch)
                    tx.step(state.params, g, state.opt_state)
                    if name == "kernels":
                        tx.step(shadow, map_params(lambda v: v.to(torch.float64), g),
                                shadow_state)
                    grads[name].append({k: v.detach().cpu() for k, v in flatten_params(g).items()})
            got = counts.read()
            if name == "kernels":
                add(got)
                expect_counts(f"(b) {case}, {OPTIMIZER_STEPS} steps", counts,
                              csr_segment_sum=(ITERATIONS - 1) * OPTIMIZER_STEPS,
                              csr_segment_sum_windows=counts.held()["csr_segment_sum_windows"],
                              masked_gru_scan=ITERATIONS * OPTIMIZER_STEPS,
                              masked_gru_scan_bwd=ITERATIONS * OPTIMIZER_STEPS)
            elif any(got.values()):
                raise AssertionError(f"(b) the plain path launched kernels: {got}")
            if not np.isfinite(float(m["total"])):
                raise AssertionError(f"(b) {case} {name}: the loss is not finite")
            ends[name] = {k: v.detach().cpu() for k, v in flatten_params(state.params).items()}
        # held: the f32 optimizer against its f64 copy on the same gradients
        vs_copy = leaf_gaps(ends["kernels"], flatten_params(shadow))
        arith = max(vs_copy, key=vs_copy.get)
        print(f"  (b) {case}: the optimizer's f32 arithmetic on the card, worst leaf {arith} "
              f"{vs_copy[arith]:.3e} of its largest entry from an f64 copy on the same "
              f"gradients (limit 1e-5)")
        if vs_copy[arith] > 1e-5:
            raise AssertionError(f"(b) {case}: {arith} lies past 1e-5 of the f64 copy")
        decay = 1.0
        if optimizer["type"] == "AdamW":
            for t in range(OPTIMIZER_STEPS):
                decay *= 1.0 - schedule(t) * optimizer["weight_decay"]
        for k in init:
            if k.split("/")[-1] in BN_STATS:
                end, want = ends["kernels"][k], init[k] * decay
                if not torch.allclose(end.double(), want.double(), rtol=1e-6, atol=0.0):
                    raise AssertionError(f"(b) {case}: {k} is {end[:4]}, not {want[:4]}")
        # printed: phase 9 (e)'s rule, and where the gradients part
        card_f64 = leaf_gaps(ends["kernels"], ends["plain f64"])
        plain_f64 = leaf_gaps(ends["plain"], ends["plain f64"])
        limit = {k: max(1e-4, F32_SPREAD_MULTIPLE * v) for k, v in plain_f64.items()}
        worst = max(card_f64, key=lambda k: card_f64[k] / limit[k])
        steps = [(leaf_gaps(gk, gf)[worst], leaf_gaps(gp, gf)[worst]) for gk, gp, gf in zip(
            grads["kernels"], grads["plain"], grads["plain f64"])]
        print(f"  (b) {case}: training against the f64 run, worst leaf {worst} "
              f"{card_f64[worst]:.3e} of its largest entry (phase 9 (e)'s rule "
              f"{'allows' if card_f64[worst] <= limit[worst] else 'would refuse past'} "
              f"{limit[worst]:.3e}; the plain f32's {plain_f64[worst]:.3e}); its gradients "
              "from the f64 run's a step, kernels / plain f32: "
              + ", ".join(f"{a:.2e} / {b:.2e}" for a, b in steps))
        out[case] = dict(optimizer_vs_f64_copy=vs_copy[arith], worst_leaf=worst,
                         distance=card_f64[worst], rule_limit=limit[worst],
                         plain_f32_distance=plain_f64[worst],
                         gradient_distances=steps)
    print(f"[language] (b) {len(OPTIMIZER_CASES)} optimizer cases held; the moving statistics "
          "moved under AdamW alone, by its decay")
    return out


# (b)'s leaves where the kernel path's step-0 gradients lay furthest from f64
GAP_LEAVES = ("layers/3/kernel", "layers/1/gamma")


def gradient_gap_by_kernel(dev, card: str, padding, arrays, meta, tree) -> dict:
    """(b): which kernel's summation order puts the kernel path's f32
    step-0 gradients of (a)'s model further from f64 than the plain path's.
    The gradients on the card from one generator state (the same masks), with
    kernel B, kernel C, both, or kernel A swapped for its plain version in
    f32, and B or C for its plain version computed in f64
    (`_gru_scan_swapped`), each set beside the kernel path and the plain
    path: of each leaf's largest entry, its distance from the plain path in
    f64 on the card at `GAP_LEAVES` and at its worst leaf, and how far the
    path states that reach the readout lie from the f64 run's. A swap
    accounts for the share (kernels - swap) / (kernels - plain) of the gap
    at a leaf. Printed, not held."""
    import ignnition_tpu_torch as igt
    import ignnition_tpu_torch.nn.rnn as t_rnn
    import ignnition_tpu_torch.ops.segment as t_seg
    from ignnition_tpu_torch.model.builder import GnnModel
    from ignnition_tpu_torch.ops.cuda import segment_kernels as sk

    ir = igt.parse_model_description(layers_description(), FEATURE_DIMS)
    swaps = {
        "kernels (as run)": {},
        "plain path": None,
        "B plain (f32)": dict(scan=_gru_scan_swapped(True, False)),
        "C plain (f32)": dict(scan=_gru_scan_swapped(False, True)),
        "B plain in f64": dict(scan=_gru_scan_swapped(True, False, f64=True)),
        "C plain in f64": dict(scan=_gru_scan_swapped(False, True, f64=True)),
        "B and C plain (f32)": dict(scan=_gru_scan_swapped(True, True)),
        "A plain (f32)": dict(sums=(sk.sorted_segment_sum_csr_plain,
                                    sk.sorted_segment_sum_csr_windows_plain)),
    }
    orig = (t_rnn.masked_gru_scan, t_seg.sorted_segment_sum_csr,
            t_seg.sorted_segment_sum_csr_windows, GnnModel._readout)
    seen = {}

    def spy(self, params, batch, meta, states, *rest, **kw):
        seen["path"] = states["path"].detach().to("cpu", torch.float64, copy=True)
        return orig[3](self, params, batch, meta, states, *rest, **kw)

    def run(swap, compute_dtype=None):
        """The gradients and the path states at the readout under `swap`."""
        GnnModel._readout = spy
        try:
            if swap is None:
                with plain_on_card():
                    g = _grads(ir, tree, arrays, meta, padding, dev, compute_dtype)
            else:
                t_rnn.masked_gru_scan = swap.get("scan", orig[0])
                t_seg.sorted_segment_sum_csr, t_seg.sorted_segment_sum_csr_windows = swap.get(
                    "sums", orig[1:3])
                g = _grads(ir, tree, arrays, meta, padding, dev, compute_dtype)
        finally:
            (t_rnn.masked_gru_scan, t_seg.sorted_segment_sum_csr,
             t_seg.sorted_segment_sum_csr_windows, GnnModel._readout) = orig
        return g, seen.pop("path")

    ref, ref_states = run(None, torch.float64)
    leaves = {want: next(k for k in ref if k.endswith("/" + want)) for want in GAP_LEAVES}
    out = {}
    for name, swap in swaps.items():
        g, states = run(swap)
        gaps = {k: float((g[k] - v).abs().max() / max(float(v.abs().max()), 1e-30))
                for k, v in ref.items()}
        worst = max(gaps, key=gaps.get)
        out[name] = dict(leaves={w: gaps[k] for w, k in leaves.items()}, worst_leaf=worst,
                         worst=gaps[worst], states=float(
                             (states - ref_states).abs().max() / ref_states.abs().max()))
    kern, plain = out["kernels (as run)"]["leaves"], out["plain path"]["leaves"]
    for name, r in out.items():
        share = {w: (kern[w] - r["leaves"][w]) / (kern[w] - plain[w])
                 if kern[w] != plain[w] else float("nan") for w in GAP_LEAVES}
        r["share_of_gap"] = share
        print(f"  (b) step-0 f32 gradients, {name}: from the plain path in f64 (card) "
              + ", ".join(f"{w} {r['leaves'][w]:.3e} ({share[w]:.0%} of the gap)"
                          for w in GAP_LEAVES)
              + f"; worst leaf {r['worst_leaf']} {r['worst']:.3e}; the path states at the "
              f"readout {r['states']:.3e} from the f64 run's")
    print(f"[language] (b) the gradient gap by kernel: kernels {kern}, plain {plain}; {card}")
    return out


def attention_reference(dev, card: str, counts, add) -> dict:
    """(c): phase 5's attention flagship with `attention_softmax: reference`
    (the reference's softmax over each graph's destinations): the per-edge
    form, whatever the batch holds, its weighted sum through kernel A, no
    kernel D or E. Served and trained, held to the plain path (CPU)."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    desc = attention_description()
    desc["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"][
        "attention_softmax"] = "reference"
    ir = igt.parse_model_description(desc, FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 7)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    out = {}
    samples = [make_sample(rng, **FLAGSHIP) for _ in range(N_FLAGSHIP_REQUESTS)]
    server = serve_one_size(dev, ir, params, samples, padding)
    # a forward: B at each iteration's stage 1, A at each stage 2's weighted sum
    serve_requests("(c) reference attention", server, samples, FLAGSHIP["n_paths"], counts,
                   add, masked_gru_scan=ITERATIONS, csr_segment_sum=ITERATIONS)
    kernels_vs_plain_forward("(c) reference attention", server, ir, params, samples[0], dev,
                             (None, torch.bfloat16))
    out["serving"] = serving_times("(c) reference attention", server, samples[0], card, dev)

    arrays, meta = igt.build_batch([make_sample(rng, **FLAGSHIP)], ir, padding, training=True)
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
    batch = to_device(arrays, trainer.device)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    step0_gradients_vs_plain("(c) reference attention", ir, padding, arrays, meta, state,
                             batch, noise=1e-7)
    # kernel A a step: the weighted sum at each iteration (forward); the slice
    # gather's, the edge gather's and the destination scores' backwards but
    # at the last iteration, whose link states no prediction reads
    state, rows = step_launches(
        "(c) reference attention training", trainer, state, batch, meta,
        LANGUAGE_REFERENCE_STEPS, counts, add,
        csr_segment_sum=ITERATIONS + 3 * (ITERATIONS - 1),
        masked_gru_scan=ITERATIONS, masked_gru_scan_bwd=ITERATIONS)
    out["training"] = dict(losses=[r[0] for r in rows], **time_training_step(
        "(c) reference attention", trainer.train_step_fn(meta), state, batch, arrays, card))
    return out


def qsize_attention(dev, card: str, counts, add) -> dict:
    """(d): Q-size with stage 1's interleave replaced by attention over its
    two sources (link and node states into each path) at the shapes of
    phase 6: the sources' edges concatenated, `segment_softmax` and the
    library's unsorted sum, then one GRU cell step. Served and trained,
    held to the plain path (CPU); its launches reported."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device

    igt.register_normalization("normalization_queue_size", normalization_queue_size)
    desc = qsize_description()
    desc["message_passing"]["stages"][0]["stage_mp"][0]["aggregation"] = {"type": "attention"}
    ir = igt.parse_model_description(desc, QSIZE_FEATURE_DIMS)
    params = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 8)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    out = {}
    samples = [make_qsize_sample(rng, **QSIZE) for _ in range(QSIZE_REQUESTS)]
    server = serve_one_size(dev, ir, params, samples, padding)
    # no kernel of the port: the edge gathers, the softmax, the unsorted sum,
    # the cell step and stage 2's incidence products are library calls
    serve_requests("(d) qsize attention", server, samples, QSIZE["n_paths"], counts, add)
    kernels_vs_plain_forward("(d) qsize attention", server, ir, params, samples[0], dev,
                             (None, torch.bfloat16))
    out["serving"] = serving_times("(d) qsize attention", server, samples[0], card, dev)

    arrays, meta = igt.build_batch([make_qsize_sample(rng, **QSIZE)], ir, padding,
                                   training=True)
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
    batch = to_device(arrays, trainer.device)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    step0_gradients_vs_plain("(d) qsize attention", ir, padding, arrays, meta, state, batch,
                             noise=1e-7)
    # kernel A: each source's edge gather backward, but at the first
    # iteration, whose link and node states need no gradient
    state, rows = step_launches(
        "(d) qsize attention training", trainer, state, batch, meta,
        LANGUAGE_REFERENCE_STEPS, counts, add, csr_segment_sum=2 * (ITERATIONS - 1))
    edges = sum(int(np.sum(v > 0)) for k, v in arrays.items() if k.startswith("edge_mask_"))
    out["training"] = dict(losses=[r[0] for r in rows], **time_training_step(
        "(d) qsize attention", trainer.train_step_fn(meta), state, batch, arrays, card,
        edge_messages=ITERATIONS * edges))
    return out


def tensorboard_run(dev, counts, add) -> dict:
    """(e): `Trainer.train` on (a)'s model for 5 bf16 steps over a dataset
    of the port's `write_dataset` with a TensorBoard directory; the event
    file read back holds each step's loss scalars, equal to the logged
    ones."""
    import shutil
    import tempfile

    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data.synthetic import write_dataset
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ir = igt.parse_model_description(layers_description(), FEATURE_DIMS)
    root = tempfile.mkdtemp(prefix="chip_smoke_tb_")
    try:
        data_dir, tb = os.path.join(root, "train"), os.path.join(root, "tb")
        write_dataset(data_dir, 1, TENSORBOARD["samples"], seed=SEED, **API_SAMPLE)
        trainer = igt.Trainer(igt.build(ir), compute_dtype=torch.bfloat16)
        steps = TENSORBOARD["steps"]
        counts.reset()
        with StepLosses() as log:
            state = trainer.train(trainer.init_state(torch.Generator().manual_seed(SEED)),
                                  data_dir, steps, batch_size=TENSORBOARD["batch"],
                                  shuffle=False, log_every=1, tensorboard_dir=tb)
        got = counts.read()
        add(got)
        expect_counts(f"(e) train() with tensorboard_dir, {steps} steps", counts,
                      csr_segment_sum=(ITERATIONS - 1) * steps,
                      csr_segment_sum_windows=counts.held()["csr_segment_sum_windows"],
                      masked_gru_scan=ITERATIONS * steps,
                      masked_gru_scan_bwd=ITERATIONS * steps)
        events = EventAccumulator(tb)
        events.Reload()
        scalars = {tag: [(e.step, e.value) for e in events.Scalars(tag)]
                   for tag in ("loss", "regularization_loss", "total_loss")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    logged = {"loss": [r[0] for r in log.rows], "regularization_loss": [r[1] for r in log.rows],
              "total_loss": [r[2] for r in log.rows]}
    for tag, rows in scalars.items():
        if [s for s, _ in rows] != list(range(1, steps + 1)):
            raise AssertionError(f"(e) {tag}: steps {[s for s, _ in rows]}")
        compare(f"(e) TensorBoard scalar {tag} of {steps} steps against the logged values",
                torch.tensor([v for _, v in rows]), torch.tensor(logged[tag]),
                atol=0.0, rtol=1e-6, why="the event file stores float32")
    if state.step != steps:
        raise AssertionError(f"(e) train() ended at step {state.step}")
    return {tag: [v for _, v in rows] for tag, rows in scalars.items()}


def description_language(dev, card: str) -> dict:
    """Phase 10: (a) the flagship with every built-in layer and a registered
    one in its readout, (b) every optimizer and which kernel's order puts
    the kernel path's f32 gradients further from f64, (c) the reference
    attention softmax, (d) attention over Q-size's two sources, (e)
    TensorBoard."""
    import ignnition_tpu_torch as igt

    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    igt.register_layer("ChipScale", chip_scale_init, chip_scale_apply)
    result = {}
    result["flagship_layers"], (padding, arrays, meta, tree) = flagship_layers(
        dev, card, counts, add)
    result["optimizers"] = optimizers(dev, counts, add, padding, arrays, meta, tree)
    result["gradient_gap_by_kernel"] = gradient_gap_by_kernel(dev, card, padding, arrays, meta,
                                                              tree)
    result["attention_reference"] = attention_reference(dev, card, counts, add)
    result["qsize_attention"] = qsize_attention(dev, card, counts, add)
    result["tensorboard"] = tensorboard_run(dev, counts, add)
    print("[language] main path launch counts: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, **result)


# --------------------------------------------------------------------------
# phase 11: serving artifacts
# --------------------------------------------------------------------------

PORT_KERNELS = ("segment_sum_kernel", "masked_gru_scan", "flash_gat_fwd")
# every `__global__` of `ignnition_tpu_torch/csrc/`, by a part of its name
ALL_PORT_KERNELS = PORT_KERNELS + ("gru_bwd_", "flash_gat_bwd_")


def profiled_device_kernels(fn, runs: int, warmup_step: bool = False) -> list:
    """The names of the device kernels of `runs` calls of `fn` in one
    torch.profiler profile, opened by 256 short sleep kernels that are not
    counted (a profile once lost its first device events: one call of the
    flagship forward showed 190 of its 216 launches). With `warmup_step` the
    profiler first records a warm-up step of the same calls and drops it, as
    its schedule's `warmup` is meant to; that does not stop the losses that
    `profiler_losses` counts, so only it asks for one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    steps = 2 if warmup_step else 1
    plan = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup_step else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=plan) as prof:
        for _ in range(steps):
            for _ in range(256):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            if warmup_step:
                prof.step()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name
            and not e.name.startswith("ProfilerStep")]


def profiler_losses(repeats: int = 40) -> None:
    """How often a profile of `profiled_device_kernels` loses device events,
    with and without its warm-up step: `repeats` profiles each, in turns, of
    3 calls of a function that launches 72 small kernels (as many as
    linkpred's serving forward). `main` never calls it."""
    x = torch.ones(256, device="cuda")

    def fn():
        for _ in range(72):
            x.add_(1.0)

    lost = {False: [], True: []}
    for _ in range(repeats):
        for warmup_step in lost:
            lost[warmup_step].append(3 * 72 - len(profiled_device_kernels(fn, 3, warmup_step)))
    for warmup_step, v in lost.items():
        print(f"profiler, warm-up step {warmup_step}: {sum(n > 0 for n in v)} of {repeats} "
              f"profiles lost device events, {sum(v)} events in all (each: {v})", flush=True)


def profiled_port_launches(fn, runs: int = 3) -> tuple:
    """({port kernel: device launches a call}, device launches a call) of
    `fn`, from `profiled_device_kernels`. Now and then a profile drops a run
    of device records (1 of 40 profiles, 81-88 of 216 events, by
    `profiler_losses` on an H100), so profiles are taken until two in a row
    hold the same kernels, and it raises if 5 do not. Kernel A and the
    id-keyed sum share one `__global__`, `segment_sum_kernel`."""
    last = None
    for _ in range(5):
        names = sorted(profiled_device_kernels(fn, runs))
        if names == last:
            break
        last = names
    else:
        raise AssertionError("torch.profiler: no two of 5 profiles in a row held the same "
                             "device kernels")
    ours = {}
    for n in names:
        for k in PORT_KERNELS:
            if k in n:
                ours[k] = ours.get(k, 0) + 1
    return {k: v / runs for k, v in sorted(ours.items())}, len(names) / runs


def artifact_size(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def serving_artifact(name, ir, params, meta, request, description, dev, card, root,
                     counts, add, want, f32: bool = False) -> dict:
    """Export, save, reload and serve one model's bf16 artifact (and with
    `f32` its f32 one); hold its predictions and kernel launches to the
    in-process `ServingModel` on the same weights and batch, and time both."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.serving import kernel_ops

    out, models = {}, {}
    for compute_dtype in (torch.bfloat16, None) if f32 else (torch.bfloat16,):
        tag = "bf16" if compute_dtype else "f32"
        server = igt.ServingModel(igt.build(ir), params, meta, ir,
                                  compute_dtype=compute_dtype, device=dev)
        arrays = server.build_batch(request)
        path = os.path.join(root, f"{name}-{tag}".replace(" ", "_"))
        t0 = time.perf_counter()
        igt.export_serving(igt.build(ir), params, meta, arrays, path,
                           compute_dtype=compute_dtype, description=description)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = igt.load_serving(path)
        load_s = time.perf_counter() - t0
        ops = kernel_ops(loaded.program)
        size = artifact_size(path)

        # the main path: a request through the artifact, its launches held
        p_in = server.predict(arrays, denormalize=False)
        rows = len(server.trim(p_in, arrays))
        counts.reset()
        preds = loaded.predict_samples(request)
        got = counts.read()
        add(got)
        if preds.shape != (rows,) or not np.all(np.isfinite(preds)):
            raise AssertionError(f"{name} artifact ({tag}): predictions {preds.shape} "
                                 f"(want ({rows},)) or non-finite")
        expect_counts(f"{name} artifact ({tag}) request ({rows} predictions, mean "
                      f"{preds.mean():.5f})", counts, **want)
        # one forward of each, by wrapper counts and by the profiler
        batch_art = to_device(loaded._check(arrays), dev)
        batch_in = to_device({k: v for k, v in arrays.items()
                              if k not in ("label", "label_mask", "label_perm")}, dev)
        per_forward = {}
        for who, fn in (("artifact", lambda: loaded.forward_device(batch_art)),
                        ("in-process", lambda: server.forward_device(batch_in))):
            counts.reset()
            fn()
            torch.cuda.synchronize()
            per_forward[who] = (counts.held(), *profiled_port_launches(fn))
        if per_forward["artifact"][:2] != per_forward["in-process"][:2]:
            raise AssertionError(f"{name} ({tag}): the artifact's forward launched "
                                 f"{per_forward['artifact'][:2]}, the in-process forward "
                                 f"{per_forward['in-process'][:2]} (wrapper counts, "
                                 f"the port's kernels by the profiler)")
        print(f"  {name} ({tag}): one forward launches the port's kernels "
              f"{ {k: v for k, v in per_forward['artifact'][0].items() if v} } (wrapper counts, "
              f"read over the capture for a replay), "
              f"{per_forward['artifact'][1]} (torch.profiler, by kernel name, 3 calls), in the "
              f"artifact and in process alike; {per_forward['artifact'][2]:.0f} device launches "
              f"a call in all in the artifact, {per_forward['in-process'][2]:.0f} in process; "
              f"the program calls {len(ops)} kernel operators")

        # predictions against the in-process forward, on the same weights and batch
        p_art = loaded.predict(arrays, denormalize=False)
        diff = float(np.max(np.abs(p_art - p_in)))
        scale = float(np.max(np.abs(p_in)))
        limit = (2.0 ** -8 if compute_dtype else 1e-6) * scale
        print(f"  {name} ({tag}): artifact vs in-process predictions max abs difference "
              f"{diff:.3e} (limit {limit:.3e} = {'2^-8' if compute_dtype else '1e-6'} x max "
              f"|pred| {scale:.4f}){'; bitwise equal' if diff == 0.0 else ''}")
        if not diff <= limit:
            raise AssertionError(f"{name} ({tag}): the artifact's predictions lie "
                                 f"{diff:.3e} from the in-process ones (limit {limit:.3e})")
        entry = dict(export_s=export_s, load_s=load_s, artifact_bytes=size, max_abs_diff=diff,
                     kernel_ops=len(ops), device_launches=per_forward["artifact"][2],
                     device_launches_in_process=per_forward["in-process"][2])
        models[tag] = (server, loaded)
        if compute_dtype is torch.bfloat16:
            fwd_art, fwd_in = forward_ms(loaded, batch_art), forward_ms(server, batch_in)
            req_art, req_in = [], []
            for _ in range(4):
                for who, model, acc in (("a", loaded, req_art), ("i", server, req_in)):
                    t1 = time.perf_counter()
                    model.predict_samples(request)
                    acc.append((time.perf_counter() - t1) * 1e3)
            entry.update(forward_ms=float(np.median(fwd_art)),
                         forward_ms_in_process=float(np.median(fwd_in)),
                         request_ms=float(np.median(req_art[1:])),
                         request_ms_in_process=float(np.median(req_in[1:])))
            print(f"[latency] {name} artifact (bf16): device forward median "
                  f"{entry['forward_ms']:.3f} ms against {entry['forward_ms_in_process']:.3f} ms "
                  f"in process (x{entry['forward_ms'] / entry['forward_ms_in_process']:.3f}, 20 "
                  f"runs each, CUDA events); whole request median {entry['request_ms']:.1f} ms "
                  f"against {entry['request_ms_in_process']:.1f} ms (x"
                  f"{entry['request_ms'] / entry['request_ms_in_process']:.3f}, 3 runs each, "
                  f"host clock); export {export_s:.2f} s, load {load_s:.2f} s, {size / 1e6:.2f} "
                  f"MB on disk; on {card}")
            entry.update(print_profile(f"{name} artifact forward",
                                       lambda: loaded.forward_device(batch_art),
                                       entry["forward_ms"]))
        else:
            print(f"  {name} (f32): export {export_s:.2f} s, load {load_s:.2f} s, "
                  f"{size / 1e6:.2f} MB on disk")
        out[tag] = entry
    out["models"] = models  # phase 14's forwards
    return out


def debug_on_card(dev, root: str) -> dict:
    """`igt.debug` on the card for `examples/routenet`'s description over one
    written sample: its `model.export.txt` calls kernel B's operator once an
    iteration; then `Runner.export_serving` there, reloaded, against
    `Runner.predict`, on that description cut to 2 iterations (an export of
    8 takes 5-14 s on the card's host)."""
    import ignnition_tpu_torch as igt
    import ignnition_tpu_torch.examples.routenet  # noqa: F401 (normalization_routenet)
    from ignnition_tpu_torch.config import RunConfig
    from ignnition_tpu_torch.data.synthetic import write_dataset
    from ignnition_tpu_torch.frontend import load_description

    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(root, "debug_data")
    write_dataset(data, 1, 4, seed=SEED, **API_SAMPLE)
    description = os.path.join(here, "examples", "routenet", "model_description.yaml")
    cfg = RunConfig(train_dataset=data, eval_dataset=data, predict_dataset=data,
                    json_path=description, model_dir=os.path.join(root, "debug_ck"),
                    debug_dir=os.path.join(root, "debug"), batch_size=2)
    model = igt.create_model(cfg)
    t0 = time.perf_counter()
    out = igt.debug(model)
    seconds = time.perf_counter() - t0
    program = open(os.path.join(out, "model.export.txt")).read()
    calls = program.count("torch.ops.ignnition_tpu_torch.masked_gru_scan.default(")
    files = sorted(os.listdir(out))
    print(f"[serving artifacts] igt.debug on the card in {seconds:.1f} s: {', '.join(files)}; "
          f"model.export.txt calls kernel B's operator {calls} times")
    if calls != model.ir.num_iterations or "model.svg" not in files:
        raise AssertionError(f"debug: kernel B's operator {calls} times (want "
                             f"{model.ir.num_iterations}), files {files}")
    short = load_description(description)
    short["message_passing"]["num_iterations"] = 2
    cfg = dataclasses.replace(cfg, json_path=os.path.join(root, "routenet_2_iterations.json"))
    with open(cfg.json_path, "w") as f:
        json.dump(short, f)
    model = igt.create_model(cfg)
    runner = igt.Runner(model)
    state = runner.trainer.init_state(torch.Generator().manual_seed(SEED))
    loaded = igt.load_serving(runner.export_serving(os.path.join(root, "runner"), state=state))
    arrays, _ = next(iter(runner.trainer.batches(data, cfg.batch_size, shuffle=False,
                                                 repeat=False, training=False)))
    got = loaded.trim(loaded.predict(arrays), arrays)
    want = runner.predict(state)[0]
    diff = float(np.max(np.abs(got[: len(want)] - want)))
    print(f"[serving artifacts] Runner.export_serving on the card, reloaded: first sample's "
          f"{len(want)} predictions against Runner.predict, max abs difference {diff:.3e}")
    if not diff <= 1e-5 * float(np.max(np.abs(want))):
        raise AssertionError(f"Runner.export_serving: {diff:.3e} from Runner.predict")
    return dict(debug_s=seconds, export_calls_b=calls, runner_artifact_diff=diff)


def serving_artifacts(dev, card: str, homogeneous_served: dict) -> dict:
    """Phase 11: bf16 artifacts of the flagship, the attention flagship,
    flagship_x4, graphprop CSR and linkpred (the last two on phase 8's first
    request of 1,024 graphs) and linkpred's f32 one exported, saved,
    reloaded and served on the card, then `igt.debug` and
    `Runner.export_serving`. An export of an 8-iteration model takes ~8-14
    s on the card's host, so only linkpred's, ~2 s, is made in f32
    too."""
    import shutil
    import tempfile

    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.frontend import load_description

    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    rng = np.random.default_rng(SEED + 11)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    flagship_ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    attention_ir = igt.parse_model_description(attention_description(), FEATURE_DIMS)
    flagship_params = igt.build(flagship_ir).init(torch.Generator().manual_seed(SEED))
    attention_params = igt.build(attention_ir).init(torch.Generator().manual_seed(SEED))
    sample, sample_x4 = make_sample(rng, **FLAGSHIP), make_sample(rng, **FLAGSHIP_X4)
    meta_of = lambda ir, s: igt.build_batch([s], ir, padding, training=False)[1]
    here = os.path.dirname(os.path.abspath(__file__))
    example = lambda kind: load_description(
        os.path.join(here, "examples", kind, "model_description.yaml"))
    b, a = dict(masked_gru_scan=ITERATIONS), ITERATIONS
    cases = [
        ("flagship", flagship_ir, flagship_params, meta_of(flagship_ir, sample), [sample],
         flagship_description(), b),
        ("attention flagship", attention_ir, attention_params, meta_of(attention_ir, sample),
         [sample], attention_description(), dict(b, flash_gat_fwd=ITERATIONS)),
        ("flagship_x4", flagship_ir, flagship_params, meta_of(flagship_ir, sample_x4),
         [sample_x4], flagship_description(), dict(b, csr_segment_sum=a)),
    ]
    for name, kind in (("graphprop CSR", "graphprop"), ("linkpred", "linkpred")):
        ir, params, meta, request = homogeneous_served[name]
        cases.append((name, ir, params, meta, request, example(kind),
                      homogeneous_launches(kind, ir, igt.build_batch(
                          request, ir, training=False, target=meta)[0], training=False)))
    root = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    result, models = {}, {}
    try:
        for name, ir, params, meta, request, description, want in cases:
            result[name] = serving_artifact(name, ir, params, meta, request, description, dev,
                                            card, root, counts, add, want,
                                            f32=name == "linkpred")
            models[name] = (result[name].pop("models"), request)
        result["debug"] = debug_on_card(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("[serving artifacts] main path launch counts: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, models=models, **result)


# --------------------------------------------------------------------------
# phase 12: the roofline, the memory model and the sharded step
# --------------------------------------------------------------------------

# (table rows, indices) of the row-gather calibration: 64-byte rows (bf16,
# D=32) at the x4 and the flagship stage-2 shapes
GATHER_SHAPES = ((8192, 524_288), (2048, 131_072))
# the library's row gathers timed there; the fastest sets the floor if it
# comes within 2x of the byte bound, else the bound does
GATHERS = {"torch.index_select": lambda a, i: torch.index_select(a, 0, i),
           "table[idx]": lambda a, i: a[i],
           "F.embedding": lambda a, i: torch.nn.functional.embedding(i, a)}
MEMORY_SIZES = {"flagship": (FLAGSHIP, 1), "flagship_x4": (FLAGSHIP_X4, 1),
                "flagship_x8": (dict(n_links=16384, n_paths=131072, path_len=8), 1)}
PARALLEL_STEPS = 3
# the meshes of the gloo world of 4 (one card: NCCL refuses two ranks on a
# device), then a world of one over NCCL
PARALLEL_MESHES = ((1, 2), (2, 1), (2, 2))
PARALLEL_SECONDS = 420  # a world's time limit: its ranks are killed past it
BF16_STEP_ATOL = 3e-2  # phase 4's bf16 limit on a step's loss


def calibrated_floors(dev, rng, seg, gru, gru_bwd, gat) -> dict:
    """The H100 floors of `utils/roofline.HardwareSpec` from this run's
    graph-replay device times (bf16; phase 2's timers, and the library's row
    gathers timed here), beside the constants the module holds. The row
    gather's floor is the fastest library gather where it comes within 2x of
    the byte bound (a 64-byte row read and written, its int64 index read),
    else the bound."""
    from ignnition_tpu_torch.utils.roofline import HardwareSpec

    bf16 = torch.bfloat16
    held = HardwareSpec()
    gathers = {}
    for rows, n in GATHER_SHAPES:
        table = torch.randn(rows, HS, device=dev).to(bf16)
        idx = torch.from_numpy(rng.integers(0, rows, n)).to(dev)
        for name, call in GATHERS.items():
            t = device_times(call, rotations((table, idx)))
            gathers[f"{name} [{rows},{HS}] x {n}"] = t["graph_ms"] * 1e6 / n
    gather_bound = (2 * HS * 2 + 8) / held.hbm_gbps
    library = min(gathers.values())
    L, d = FLAGSHIP["path_len"], HS
    scans = {
        n: (gru[bf16][k]["graph_ms"] if k else gru[bf16]["graph_ms"])
        + (gru_bwd[bf16][k]["graph_ms"] if k else gru_bwd[bf16]["graph_ms"])
        for n, k in ((FLAGSHIP["n_paths"], None), (FLAGSHIP_X4["n_paths"], "at_x4_shape"))
    }
    entries = FLAGSHIP["n_links"] * FLAGSHIP["n_paths"]
    measured = dict(
        gather_ns_per_row=library if library <= 2 * gather_bound else gather_bound,
        dense_attn_ps_per_entry=(gat["fwd"][bf16]["graph_ms"] + gat["bwd"][bf16]["graph_ms"])
        * 1e9 / (2 * entries),
        rnn_scan_ps_per_elem=min(t * 1e9 / (L * n * d) for n, t in scans.items()),
        rnn_scan_us_per_step=min(t * 1e3 / L for t in scans.values()),
        segsum_ns_per_row=seg["csr"][bf16]["graph_ms"] * 1e6 / 524_288,
    )
    print("[roofline] floors from this run's graph-replay times (bf16) beside "
          "utils/roofline.HardwareSpec's:")
    for k, v in measured.items():
        print(f"    {k}: {v:.5g} this run, {getattr(held, k):.5g} held ({v / getattr(held, k):.3f}x)")
    print("    row gathers, ns a row: " + ", ".join(f"{k} {v:.5g}" for k, v in gathers.items())
          + f"; the fastest {library:.5g} = {library / gather_bound:.2f}x the byte bound "
          f"{gather_bound:.5g} ({2 * HS * 2 + 8} bytes a row at {held.hbm_gbps:g} GB/s)"
          + "; B+C ms a call: " + ", ".join(f"[{L},{n},{d}] {t:.4f}" for n, t in scans.items()))
    return dict(measured=measured, held={k: getattr(held, k) for k in measured},
                gather_ns_by_shape=gathers, gather_library_ns=library,
                gather_bound_ns=gather_bound, scan_ms_by_paths=scans)


def _train_setup(desc, size, dtype, seed, graphs: int = 1, rows: int = 1):
    """(ir, trainer on the card, state, [(arrays, meta)] of `rows` batches)."""
    import ignnition_tpu_torch as igt

    ir = igt.parse_model_description(desc, FEATURE_DIMS)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    rng = np.random.default_rng(seed)
    batches = [igt.build_batch([make_sample(rng, **size) for _ in range(graphs)], ir, padding,
                               training=True) for _ in range(rows)]
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=dtype)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    return ir, trainer, state, batches


def roofline_steps(card: str, gather_library_ns: float) -> dict:
    """(a): the flagship, flagship_x4 and attention bf16 training steps timed
    (median of 20, CUDA events) and profiled; `roofline_report` over the
    step's wall time and over its device-busy time; the report's gather rows
    also at the fastest library gather's rate, what they take."""
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.utils.roofline import roofline_report

    out = {}
    for name, desc, size in (("flagship", flagship_description(), FLAGSHIP),
                             ("flagship_x4", flagship_description(), FLAGSHIP_X4),
                             ("attention", attention_description(), FLAGSHIP)):
        ir, trainer, state, [(arrays, meta)] = _train_setup(desc, size, torch.bfloat16,
                                                            SEED + 12)
        batch = to_device(arrays, trainer.device)
        timed = time_training_step(f"{name} (phase 12)", trainer.train_step_fn(meta), state,
                                   batch, arrays, card)
        reports = {"wall": roofline_report(ir, meta, timed["step_ms"])}
        if "device_busy_ms" in timed:
            reports["device_busy"] = roofline_report(ir, meta, timed["device_busy_ms"])
        for over, r in reports.items():
            print(f"[roofline] {name}, bf16 step over its {over} time {r['measured_ms']} ms: "
                  f"bound (sol) {r['sol_ms']} ms = {r['sol_pct']}% ({r['binding']}), "
                  f"access-pattern bound (apsol) {r['apsol_ms']} ms = {r['apsol_pct']}% "
                  f"(scan {r['rnn_scan_ms']}, segment sums {r['segsum_ms']}, gathers "
                  f"{r['gather_floor_ms_informational']}, dense attention "
                  f"{r['dense_attn_ms']} ms); {r['bytes_mb']} MB, {r['gflops']} GFLOP")
        library_ms = reports["wall"]["gather_rows_m"] * 1e6 * gather_library_ns * 1e-6
        print(f"    bytes by item (MB): {reports['wall']['bytes_items_mb']}; "
              f"GFLOP by item: {reports['wall']['flops_items_g']}; the "
              f"{reports['wall']['gather_rows_m']} M gather rows at the library's "
              f"{gather_library_ns:.5g} ns a row: {library_ms:.3f} ms")
        out[name] = dict(step_ms=timed["step_ms"], device_busy_ms=timed.get("device_busy_ms"),
                         roofline=reports, gathers_at_library_ms=library_ms)
    return out


MEMORY_RATIO = (1.0, 1.5)  # the hold on the estimate over the measured peak


def memory_model(card: str) -> dict:
    """(b): `memory_holds` in a process of its own (this script run with
    `--memory-model`), so that it reads a fresh process, as a user's is,
    whatever ran before it here: a process that has run other steps holds
    cuBLAS workspaces for streams that a new trainer may be handed again,
    and its steps then allocate less (the hold read 1.028 deep in the whole
    script and 0.863 in `phase12_alone`). Then `usable_fraction` in this
    process, as the earlier phases left it."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--memory-model", card],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout[-8000:] + proc.stderr[-4000:])
        raise AssertionError(f"the memory model's process exited with {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    out = json.loads(lines[-1])
    out["usable_fraction"] = usable_fraction(card)
    return out


def memory_holds(card: str) -> dict:
    """`estimate_train_hbm` (with the device batch's exact bytes) against
    the device memory that the first captured bf16 training step of a fresh
    trainer of the flagship, x4 and x8 allocates at its peak above what was
    allocated before its state and batch (its warm-up, then the capture and
    replay, measured from the second call); the estimate must lie within
    `MEMORY_RATIO` of it."""
    import gc

    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.utils.memory import estimate_train_hbm

    out = {}
    for name, (size, graphs) in MEMORY_SIZES.items():
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        ir, trainer, state, [(arrays, meta)] = _train_setup(
            flagship_description(), size, torch.bfloat16, SEED + 12, graphs)
        batch = to_device(arrays, trainer.device)
        step = trainer.train_step_fn(meta)
        step(state, batch)  # the optimizer's moments exist from here on
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base
        batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
        est = estimate_train_hbm(ir, meta, batch_bytes=batch_bytes)
        ratio = est["total_bytes"] / measured
        print(f"[memory] {name}: estimate {est['total_bytes'] / 2**20:.1f} MiB ("
              + ", ".join(f"{k[:-6]} {v / 2**20:.1f}" for k, v in est.items()
                          if k != "total_bytes")
              + f") against {measured / 2**20:.1f} MiB allocated at the first captured step's "
              f"peak above the {base / 2**20:.1f} MiB before it, in a fresh process: "
              f"estimate / measured {ratio:.3f} (held within {MEMORY_RATIO}), on {card}")
        out[name] = dict(estimate_bytes=est, measured_bytes=measured, ratio=ratio)
        del state, batch, step, trainer
        if not MEMORY_RATIO[0] <= ratio <= MEMORY_RATIO[1]:
            raise AssertionError(f"{name}: the memory estimate over the measured peak, {ratio:.3f}, "
                                 f"lies outside {MEMORY_RATIO}")
    return out


def memory_snapshot() -> None:
    """What the flagship's first captured bf16 step allocates at its peak,
    by the place that allocated it (`torch.cuda.memory`'s recorded history:
    the first frame of the port or of this script, and the allocator's
    caller where it names a library workspace), for a fresh trainer in a
    fresh process and for a second one beside it; then what one bf16 matmul
    on a new stream allocates (cuBLAS's workspace for that stream):
    `python3 -c "import chip_smoke as c; c.memory_snapshot()"`. Phase 12
    (b)'s estimate counts the workspaces it shows (`utils.memory`)."""
    import collections
    import gc

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.ops.cuda import _build

    _build.library()

    def place(frames):
        ours = [f for f in frames if f["filename"].endswith(".py")
                and ("ignnition_tpu_torch" in f["filename"] or "chip_smoke" in f["filename"])]
        lib = [f["name"][:40] for f in frames if "Workspace" in f["name"]]
        return (f"{os.path.basename(ours[0]['filename'])}:{ours[0]['line']}" if ours else "-",
                lib[0] if lib else "")

    for trainer_no in (1, 2):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(max_entries=500000)
        _, trainer, state, [(arrays, meta)] = _train_setup(flagship_description(), FLAGSHIP,
                                                           torch.bfloat16, SEED + 12)
        batch = to_device(arrays, trainer.device)
        step = trainer.train_step_fn(meta)
        step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
        torch.cuda.memory._record_memory_history(enabled=None)
        live, total, best, at_best = {}, 0, -1, {}
        for ev in trace:
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                total += ev["size"]
            elif ev["action"] == "free_requested" and ev["addr"] in live:
                total -= live.pop(ev["addr"])["size"]
            if total > best:
                best, at_best = total, dict(live)
        by_place = collections.Counter()
        for ev in at_best.values():
            by_place[place(ev.get("frames", []))] += ev["size"] / 2**20
        print(f"[memory] trainer {trainer_no}: {base / 2**20:.1f} MiB allocated before it; its "
              f"first captured step's peak {peak:.1f} MiB above that; the recorded peak by place "
              "(MiB): " + "; ".join(f"{k[0]}{' ' + k[1] if k[1] else ''} {v:.2f}"
                                     for k, v in by_place.most_common(8)))
        del trainer, state, batch, step
    x = torch.randn(64, 64, device="cuda", dtype=torch.bfloat16)
    for i in range(2):
        stream = torch.cuda.Stream()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with torch.cuda.stream(stream):
            x @ x
        torch.cuda.synchronize()
        print(f"[memory] a bf16 matmul on new stream {i}: "
              f"{(torch.cuda.memory_allocated() - before) / 2**20:.2f} MiB allocated")


def memory_model_process(card: str) -> None:
    """The body of `--memory-model`: `memory_holds`, its result as the last
    line (JSON)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.ops.cuda import _build

    _build.library()
    print(json.dumps(memory_holds(card)))


def usable_fraction(card: str) -> dict:
    """The share of the card's memory a training step can use, measured on
    the flagship_x8 bf16 step in this process as the earlier phases left it
    (their kernels built, their graphs captured). What the CUDA context,
    the libraries and the kernels take (the card's total less what is free
    and what PyTorch holds, `mem_get_info`) leaves the rest to PyTorch's
    allocator, which reserves more than the step allocates. Its overhead is
    read on two paths, each from a fresh trainer's state and batch:
      eager: 2 steps under `capture.eager()`;
      replayed: the path a user's training runs on the card, 5 steps
        through the trainer's graphs (a warm-up on its side stream, a
        capture into its pool with static copies of the inputs, 3 replays).
    The overhead is the allocator's peak reserved over the path, above what
    it held before the state was made, over what the estimate stands for:
    the eager path's peak allocated above the same point, plus, replayed,
    the static copies (`maybe_warn_capacity(captured=True)` adds them).
    Before each path the allocator's cache is emptied, so that no block that
    earlier work freed is taken again unseen, which would read the reserve
    low (a capture empties it too). usable = (total - outside) / total /
    the larger overhead, beside `utils.memory.USABLE_FRACTION`, which must
    not lie above it by more than 0.02. Printed, not held: the process's
    peak reserved over its peak allocated on the replayed path, with what
    earlier phases hold."""
    import gc

    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.training import capture
    from ignnition_tpu_torch.utils import memory

    size, graphs = MEMORY_SIZES["flagship_x8"]

    def path(calls: int, eager: bool) -> dict:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        _, trainer, state, [(arrays, meta)] = _train_setup(
            flagship_description(), size, torch.bfloat16, SEED + 12, graphs)
        batch = to_device(arrays, trainer.device)
        step = trainer.train_step_fn(meta)
        with capture.eager() if eager else contextlib.nullcontext():
            for _ in range(calls):
                step(state, batch)
        torch.cuda.synchronize()
        captured = trainer.graphs.captured[("train", meta, None)]
        out = dict(allocated=torch.cuda.max_memory_allocated() - allocated,
                   reserved=torch.cuda.max_memory_reserved() - reserved,
                   process=torch.cuda.max_memory_reserved() / torch.cuda.max_memory_allocated(),
                   before=(allocated, reserved), last=captured.last,
                   pool=captured.pool_bytes or 0, static=trainer.graphs.static_bytes())
        del state, batch, step, trainer, captured
        return out

    eager, replayed = path(2, eager=True), path(5, eager=False)
    if (eager["last"], replayed["last"]) != ("eager", "replay"):
        raise AssertionError(f"usable fraction: the paths ran {eager['last']} and "
                             f"{replayed['last']}, not eager and replay")
    gc.collect()
    need = eager["allocated"]
    overhead = {"eager": eager["reserved"] / need,
                "replayed": replayed["reserved"] / (need + replayed["static"])}
    free, total = torch.cuda.mem_get_info()
    outside = total - free - torch.cuda.memory_reserved()
    left = (total - outside) / total
    usable = {k: left / v for k, v in overhead.items()}
    least = min(usable.values())
    mib = lambda b: f"{b / 2**20:.0f} MiB"  # noqa: E731
    print(f"[memory] usable fraction of the card: the context, libraries and kernels take "
          f"{mib(outside)} of {total / 2**30:.2f} GiB ({left:.4f} left to the allocator). The "
          f"flagship_x8 step from a fresh state allocates {mib(need)} at its eager peak (above "
          f"the {mib(eager['before'][0])} allocated / {mib(eager['before'][1])} reserved "
          f"before it). Eager, the allocator reserves {mib(eager['reserved'])}: "
          f"{overhead['eager']:.4f}x, usable {usable['eager']:.4f}. Replayed (warm-up, "
          f"capture, 3 replays), it reserves {mib(replayed['reserved'])} (pool "
          f"{mib(replayed['pool'])}, static inputs {mib(replayed['static'])}) against "
          f"{mib(need + replayed['static'])} with the static copies: "
          f"{overhead['replayed']:.4f}x, usable {usable['replayed']:.4f}. The process's peak "
          f"reserved / peak allocated on the replayed path, earlier phases' pools included: "
          f"{replayed['process']:.4f}. utils.memory.USABLE_FRACTION holds "
          f"{memory.USABLE_FRACTION} (the lesser usable: {least:.4f}); on {card}")
    if memory.USABLE_FRACTION > least + 0.02:
        raise AssertionError(f"USABLE_FRACTION {memory.USABLE_FRACTION} lies above this card's "
                             f"{least:.4f}")
    return dict(outside_mib=outside / 2**20, total_gib=total / 2**30, need_mib=need / 2**20,
                overhead=overhead, usable=usable, least=least,
                process_ratio=replayed["process"], pool_mib=replayed["pool"] / 2**20,
                static_mib=replayed["static"] / 2**20, held=memory.USABLE_FRACTION)


def _parallel_rows(dtype):
    """The flagship's two data rows of the sharded steps (seeded)."""
    return _train_setup(flagship_description(), FLAGSHIP, dtype, SEED + 12, rows=2)


def parallel_reference(dtype, n_rows: int) -> dict:
    """The single-device steps on the card that a mesh of `n_rows` data rows
    must match: each step the mean of the rows' gradients (serial), one
    update; the losses, the parameters after every step and the first
    step's gradients."""
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params, with_leaves
    from ignnition_tpu_torch.parallel import stack_batches

    ir, trainer, state, batches = _parallel_rows(dtype)
    # the rows as the mesh's step gets them: stacked, re-padded to one meta
    stacked, meta = stack_batches(batches[:n_rows], ir)
    grads = trainer.grads_fn(meta)
    device_batches = [to_device({k: v[i] for k, v in stacked.items()}, trainer.device)
                      for i in range(n_rows)]
    losses, params, first = [], [], None
    for _ in range(PARALLEL_STEPS):
        total, loss = None, 0.0
        for batch in device_batches:
            g, m = grads(state.params, batch)
            g = list(flatten_params(g).values())
            total = g if total is None else [a + b for a, b in zip(total, g)]
            loss += float(m["loss"])
        mean = [t / n_rows for t in total]
        first = first or {k: v.float().cpu() for k, v in
                          zip(flatten_params(state.params), mean)}
        trainer.optimizer.step(state.params, with_leaves(state.params, mean), state.opt_state)
        losses.append(loss / n_rows)
        params.append({k: v.detach().float().cpu() for k, v in
                       flatten_params(state.params).items()})
    return dict(losses=losses, params=params, first_grads=first)


def parallel_rank(job_dir: str, port: str, rank: str, world: str, backend: str) -> None:
    """One rank of a sharded-step world (this script run with
    `--parallel-rank`): joins the world, steps the flagship over each mesh
    of the job in f32 and bf16 and writes, per mesh and dtype, its losses,
    its parameters after each step, the launches of its kernels, its step
    times and the all-reduce's share of a profiled step."""
    import pickle

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from ignnition_tpu_torch.model.builder import flatten_params
    from ignnition_tpu_torch.parallel import distributed, make_mesh, make_parallel_train_step
    from ignnition_tpu_torch.parallel import stack_batches
    from ignnition_tpu_torch.parallel.steps import GRADIENT_ALL_REDUCE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(rank), int(world)
    with open(os.path.join(job_dir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    distributed.initialize(f"localhost:{port}", world, rank, backend=backend)
    out = {"backend": dist.get_backend()}
    from torch.profiler import ProfilerActivity, profile

    # the profiler's start-up (CUPTI), outside the profiled steps: a rank's
    # first profile stalled its mesh ~10 s once
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    counts = Counts()
    for shape in job["meshes"]:
        mesh = make_mesh(*shape)
        for dtype in (torch.float32, torch.bfloat16):
            if mesh.coords is None:
                dist.barrier()
                continue
            ir, trainer, state, batches = _parallel_rows(dtype)
            stacked, meta = stack_batches(batches[:shape[0]], ir)
            step = make_parallel_train_step(trainer.model, trainer.optimizer, trainer.loss_fn,
                                            meta, mesh, compute_dtype=dtype)
            losses, params, times = [], [], []
            counts.reset()
            for _ in range(PARALLEL_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _, _, loss = step(state.params, state.opt_state, stacked,
                                  generator=trainer.generator)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
                losses.append(float(loss))
                params.append({k: v.detach().float().cpu()
                               for k, v in flatten_params(state.params).items()})
            launched, held = counts.read(), counts.held()
            # one more step under the profiler: the all-reduces' share (the
            # model axis's, forward and backward, and the gradients'; each
            # call waits for its collective on the host)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(state.params, state.opt_state, stacked, generator=trainer.generator)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            # the host-side records only: a record_function also has a device
            # record of the same key, whose host time is 0
            reduce_ms = dict.fromkeys(
                ("_AllReduceSum", "_AllReduceSumBackward", GRADIENT_ALL_REDUCE), 0.0)
            for e in prof.key_averages():
                if e.key in reduce_ms and e.device_type == torch.autograd.DeviceType.CPU:
                    reduce_ms[e.key] += e.cpu_time_total / 1e3
            out[(shape, str(dtype))] = dict(
                coords=mesh.coords, losses=losses, params=params if rank == 0 else None,
                checksum=[float(sum(float(v.double().sum()) for v in p.values()))
                          for p in params],
                launches=launched, held_launches=held, step_ms=times, profiled_step_ms=wall,
                allreduce_ms=reduce_ms, captured=step.captured, why_eager=step.why_eager)
            del state, step, trainer, batches, stacked
            dist.barrier()
    if job.get("compiled"):
        out["compiled"] = compiled_mesh_rank(make_mesh(1, 1), counts,
                                             torch.device("cuda", torch.cuda.current_device()))
    with open(os.path.join(job_dir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def spawn_parallel_world(world: int, backend: str, meshes, root: str, job: dict = None,
                         flag: str = "--parallel-rank") -> list:
    """Run `world` ranks of `parallel_rank` (each a process of this script;
    `flag` "--destshard-rank" runs `destshard_rank` with `job`); every
    rank's results, or a raise with every rank's output when one fails or
    the world outlives `PARALLEL_SECONDS` (its ranks are killed)."""
    import pickle
    import socket

    job_dir = os.path.join(root, f"{backend}_{world}{flag.replace('-', '_')}")
    os.makedirs(job_dir, exist_ok=True)
    with open(os.path.join(job_dir, "job.pkl"), "wb") as f:
        pickle.dump(dict(job or {}, meshes=meshes), f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    logs = [os.path.join(job_dir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, job_dir,
                 str(port), str(r), str(world), backend],
                stdout=log, stderr=subprocess.STDOUT))
    deadline, failed = time.monotonic() + PARALLEL_SECONDS, None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = (f"rank {bad[0]} exited with {procs[bad[0]].returncode}" if bad
                          else f"the world outlived {PARALLEL_SECONDS} s")
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is None and any(p.returncode for p in procs):
        failed = f"ranks exited with {[p.returncode for p in procs]}"
    if failed:
        for r in range(world):
            print(f"--- {backend} rank {r}:\n{open(logs[r]).read()[-4000:]}")
        raise AssertionError(f"sharded steps, {backend} world of {world}: {failed}")
    results = []
    for r in range(world):
        with open(os.path.join(job_dir, f"out_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _expected_parallel_launches(model_axis: int) -> dict:
    """A rank's launches in `PARALLEL_STEPS` flagship steps: B and C once an
    iteration; under edge sharding the id-keyed sum once an iteration (the
    stage-2 sum of this rank's sorted block), no kernel A (the gathers'
    sorts are off) and no D or E; without it the single-device path (the
    dense product, kernel A 7 times a step, phase 4)."""
    s, it = PARALLEL_STEPS, ITERATIONS
    if model_axis > 1:
        return dict(masked_gru_scan=it * s, masked_gru_scan_bwd=it * s, segment_sum_ids=it * s)
    return dict(masked_gru_scan=it * s, masked_gru_scan_bwd=it * s,
                csr_segment_sum=(it - 1) * s)


def sharded_steps(card: str) -> dict:
    """(c): the flagship at full width (hs 32, 8 iterations, 2,048 links and
    16,384 paths of length 8 a data row) stepped 3 times in f32 and in bf16
    over 1x2, 2x1 and 2x2 meshes of a gloo world of 4 and a 1x1 mesh of an
    NCCL world of 1, each held to the single-device steps on the card
    (`parallel_reference`): f32 losses at rtol 1e-5 and the parameters by
    the rule of `tests/test_torch_train.py` (elements whose first gradient
    is above 1e-3 of the leaf's largest at rtol 5e-4 / atol 5e-6, every
    element within 2 lr a step), bf16 losses within 3e-2; every rank of a
    mesh ends with the same parameters; each rank's launches of B, C and the
    id-keyed kernel counted."""
    import tempfile

    from ignnition_tpu_torch.parallel.steps import GRADIENT_ALL_REDUCE

    refs = {(dtype, rows): parallel_reference(dtype, rows)
            for dtype in (torch.float32, torch.bfloat16) for rows in (1, 2)}
    lr = 1e-3  # the flagship's initial learning rate
    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    t0 = time.perf_counter()
    worlds = {"gloo": spawn_parallel_world(4, "gloo", PARALLEL_MESHES, root)}
    # the NCCL world also runs phase 15's work (`compiled_mesh_rank`)
    worlds["nccl"] = spawn_parallel_world(1, "nccl", ((1, 1),), root, job={"compiled": True})
    print(f"[parallel] worlds spawned and run in {time.perf_counter() - t0:.1f} s (gloo: 4 "
          f"processes on one card, meshes {PARALLEL_MESHES}; nccl: 1 process)")
    total = {k: 0 for k in Counts().read()}
    out = {}
    for backend, ranks in worlds.items():
        meshes = PARALLEL_MESHES if backend == "gloo" else ((1, 1),)
        for shape in meshes:
            for dtype in (torch.float32, torch.bfloat16):
                key = (shape, str(dtype))
                got = [r[key] for r in ranks if key in r]
                if len(got) != shape[0] * shape[1]:
                    raise AssertionError(f"{backend} {shape}: {len(got)} ranks reported")
                ref = refs[(dtype, shape[0])]
                what = f"{backend} {shape[0]}x{shape[1]} {str(dtype)[6:]}"
                if len({tuple(g["checksum"]) for g in got}) != 1:
                    raise AssertionError(f"{what}: the ranks' parameters differ")
                lead = got[0]
                if dtype == torch.float32:
                    np.testing.assert_allclose(lead["losses"], ref["losses"], rtol=1e-5,
                                               err_msg=what)
                    firm = {k: g.abs() >= 1e-3 * g.abs().max()
                            for k, g in ref["first_grads"].items()}
                    worst_firm = worst_any = 0.0
                    for i in range(PARALLEL_STEPS):
                        for k, want in ref["params"][i].items():
                            have = lead["params"][i][k]
                            err = (have - want).abs()
                            if not bool((err[firm[k]] <= 5e-6 + 5e-4 * want.abs()[firm[k]]).all()):
                                raise AssertionError(f"{what}: step {i} {k} beyond the limits")
                            if float(err.max()) > 2 * lr * (i + 1):
                                raise AssertionError(f"{what}: step {i} {k} moved past 2 lr a step")
                            if firm[k].any():
                                worst_firm = max(worst_firm, float(err[firm[k]].max()))
                            worst_any = max(worst_any, float(err.max()))
                    held = (f"losses {lead['losses']} against {ref['losses']} (rtol 1e-5); "
                            f"parameters: firm elements max |diff| {worst_firm:.3e}, any "
                            f"element {worst_any:.3e} (limit {2 * lr:g} a step)")
                else:
                    diffs = [abs(a - b) for a, b in zip(lead["losses"], ref["losses"])]
                    if max(diffs) > BF16_STEP_ATOL:
                        raise AssertionError(f"{what}: a step's loss {max(diffs):.3e} from the "
                                             f"single-device step's")
                    held = (f"losses {lead['losses']} against {ref['losses']} (max |diff| "
                            f"{max(diffs):.3e}, atol {BF16_STEP_ATOL})")
                # a gloo mesh steps eagerly; the NCCL world of one replays
                # its third step (the launches held: those from Python and
                # each replay's recorded ones)
                for g in got:
                    if g["captured"] != (backend == "nccl") or (
                            backend == "gloo" and "gloo" not in g["why_eager"]):
                        raise AssertionError(f"{what}: captured {g['captured']}, "
                                             f"{g['why_eager']}")
                want = _expected_parallel_launches(shape[1])
                for g in got:
                    expect_counts(f"{what} rank {g['coords']}", g["held_launches"], **want)
                    for k, v in g["launches"].items():
                        total[k] += v
                # from the second step, or past the capture where it replays
                step_ms = float(np.median(lead["step_ms"][2 if lead["captured"] else 1:]))
                # the gradients are all-reduced over every mesh of 2 or more
                # ranks, the model axis's partials over a model axis of 2 or more
                must = ([GRADIENT_ALL_REDUCE] if shape[0] * shape[1] > 1 else []) + (
                    ["_AllReduceSum", "_AllReduceSumBackward"] if shape[1] > 1 else [])
                unseen = [k for k in must if not lead["allreduce_ms"][k] > 0]
                if unseen:
                    raise AssertionError(f"{what}: the profile of a step shows no host time "
                                         f"in {unseen}")
                reduce_ms = sum(lead["allreduce_ms"].values())
                share = reduce_ms / lead["profiled_step_ms"]
                print(f"[parallel] {what}: "
                      + ("captured into CUDA graphs (NCCL)" if lead["captured"] else
                         f"eager: {lead['why_eager']}"))
                print(f"[parallel] {what}: {held}; step {step_ms:.1f} ms (median of steps "
                      f"{3 if lead['captured'] else 2}-{PARALLEL_STEPS}, CUDA events, rank (0, "
                      f"0)); profiled step "
                      f"{lead['profiled_step_ms']:.1f} ms, all-reduces {reduce_ms:.1f} ms "
                      f"({share:.1%}: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                    lead["allreduce_ms"].items())
                      + f", torch.profiler host time), on {card}")
                out[what] = dict(losses=lead["losses"], reference_losses=ref["losses"],
                                 step_ms=step_ms, allreduce_share=share,
                                 launches_per_rank=[g["launches"] for g in got])
    print("[parallel] launch counts, every rank of every world: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, meshes=out, compiled_ranks=worlds["nccl"])


def phase12_alone() -> None:
    """Phase 12 after the phase-2 timers whose times it reads (kernel A at
    [524288,32], B and C, D and E), without the other phases:
    `python3 -c "import chip_smoke as c; c.phase12_alone()"`."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    _build.library()
    rng = np.random.default_rng(SEED)
    seg = check_segment_sums(dev, rng, "stage 2 forward at x4", 524_288,
                             FLAGSHIP_X4["n_links"], HS, timed=True)
    gru, gru_bwd = check_gru_scan(dev, rng), check_gru_scan_bwd(dev, rng)
    gat = check_attention_kernels(dev, rng)
    t1 = time.perf_counter()
    out = roofline_memory_parallel(dev, card, seg, gru, gru_bwd, gat)
    print(f"[time] build and timers {t1 - t0:.1f} s, phase 12 {time.perf_counter() - t1:.1f} s")
    print(json.dumps({"floors": out["floors"]["measured"],
                      "launches": out["parallel"]["launches"], "card": card}))


def roofline_memory_parallel(dev, card: str, seg, gru, gru_bwd, gat) -> dict:
    """Phase 12: the floors, (a) the roofline reports, (b) the memory model,
    (c) the sharded steps."""
    rng = np.random.default_rng(SEED + 12)
    floors = calibrated_floors(dev, rng, seg, gru, gru_bwd, gat)
    return dict(floors=floors, roofline=roofline_steps(card, floors["gather_library_ns"]),
                memory=memory_model(card), parallel=sharded_steps(card))


# --------------------------------------------------------------------------
# phase 13: destination sharding (v2)
# --------------------------------------------------------------------------

# the meshes of the gloo world of 4 on the one card: a data row is one graph
DEST_MESHES = ((1, 2), (1, 4), (2, 2))
DEST_STEPS = 3
DEST_ORDERS = ("naive", "reordered")
DEST_PAD = dict(mode="multiple", multiple=256, min_size=256)


def make_local_sample(rng, n_links, n_paths, path_len, window=64):
    """One flagship-scale graph in the "local_recovered" regime of
    `tools/project_scaling.make_flagship_sample` (that module imports the
    JAX package): each path draws its links from a window of +-`window`
    around an anchor, then link and path ids are scrambled, so that the
    dataset's order carries no locality and the partitioner must recover
    it."""
    from ignnition_tpu_torch.data.dataset import AdjacencyArrays, GraphSample

    anchors = np.sort(rng.integers(0, n_links, n_paths))
    offs = rng.integers(-window, window + 1, (n_paths, path_len))
    links = (anchors[:, None] + offs) % n_links
    links = rng.permutation(n_links)[links]
    links = links[rng.permutation(n_paths)]
    src_lp = links.reshape(-1).astype(np.int32)
    dst_lp = np.repeat(np.arange(n_paths, dtype=np.int32), path_len)
    seq_lp = np.tile(np.arange(path_len, dtype=np.int32), n_paths)
    src_pl, dst_pl, seq_pl = _reverse(src_lp, dst_lp, n_links)
    return GraphSample(
        num_nodes={"link": n_links, "path": n_paths},
        features={"link_capacity": rng.uniform(20, 40, (n_links, 1)).astype(np.float32),
                  "traffic": rng.uniform(0.2, 0.8, (n_paths, 1)).astype(np.float32)},
        adjacencies={"adj_links_paths": AdjacencyArrays(src_lp, dst_lp, seq_lp),
                     "adj_paths_links": AdjacencyArrays(src_pl, dst_pl, seq_pl)},
        label=rng.uniform(0.1, 1.0, n_paths).astype(np.float32),
    )


def destshard_inputs(ir, graphs) -> dict:
    """For each mesh and order: the data rows' merged batches (one graph a
    row, re-padded to one meta), their partitions stacked to [n_data,
    n_model, ...] with one local meta, the renumbering's orders, and the
    halo accounting (each adjacency's H and boundary fraction,
    `comm_bytes_per_step` v2 against v1 in f32)."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data.graph import merge_metas, repad_to_meta
    from ignnition_tpu_torch.parallel import (comm_bytes_per_step, halo_fractions,
                                              locality_order, partition_batch,
                                              partition_dims, reorder_sample)

    padding = igt.PaddingConfig(**DEST_PAD)
    out = {}
    for shape in DEST_MESHES:
        n_data, m = shape
        for order in DEST_ORDERS:
            t0 = time.perf_counter()
            rows, orders = [], []
            for g in graphs[:n_data]:
                if order == "reordered":
                    pad = {e: padding.pad_size(n) for e, n in g.num_nodes.items()}
                    o = locality_order(g, ir, n_model=m, node_pad=pad)
                    g = reorder_sample(g, ir, orders=o)[0]
                    orders.append(o)
                rows.append(igt.build_batch([g], ir, padding, training=True))
            t_order = time.perf_counter() - t0
            target = merge_metas([mt for _, mt in rows], ir)
            rows = [(repad_to_meta(a, mt, target, ir), target) for a, mt in rows]
            parts = [partition_batch(a, mt, ir, m) for a, mt in rows]
            dims = [partition_dims(p[0]) for p in parts]
            grown = {k: {a: max(d[k].get(a, 0) for d in dims)
                         for a in set().union(*(d[k] for d in dims))} for k in dims[0]}
            parts = [partition_batch(a, mt, ir, m, pad_to=grown) for a, mt in rows]
            stacked = {k: np.stack([p[0][k] for p in parts]) for k in parts[0][0]}
            comm = comm_bytes_per_step(ir, target, parts[0][0], m)
            frac = halo_fractions(parts[0][0], ir)
            out[(shape, order)] = dict(rows=rows, stacked=stacked, meta=parts[0][1],
                                       orders=orders, dims=partition_dims(parts[0][0]),
                                       comm=comm, frac=frac, seconds=time.perf_counter() - t0,
                                       order_seconds=t_order)
            halo = ", ".join(
                f"{a}: H {out[(shape, order)]['dims']['halo'].get(a, 0)}, boundary "
                f"{frac[a]['boundary_frac']:.1%}, v2 {comm[a]['v2_halo_bytes'] / 1e6:.2f} MB "
                f"vs v1 {comm[a]['v1_full_psum_bytes'] / 1e6:.2f} MB a step"
                for a in sorted(frac))
            print(f"[dest_shard] {n_data}x{m} {order}: {halo} (data row 0; partition "
                  f"{time.perf_counter() - t0:.1f} s on the host, of which renumbering and "
                  f"build_batch {t_order:.1f} s)")
    return out


def destshard_reference(ir, rows, dtype) -> dict:
    """The single-device steps on the card that a mesh of len(rows) data rows
    must match (each step the mean of the rows' gradients, one update): the
    losses, the parameters after every step, the first step's gradients,
    the f32 forward of each row at the initial weights and the peak memory
    of a step."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params, with_leaves

    trainer = igt.Trainer(igt.build(ir), igt.PaddingConfig(**DEST_PAD), compute_dtype=dtype)
    state = trainer.init_state(torch.Generator().manual_seed(SEED + 13))
    meta = rows[0][1]
    batches = [to_device(a, trainer.device) for a, _ in rows]
    forward = [trainer.model.apply(state.params, b, meta).detach().float().cpu()
               for b in batches] if dtype == torch.float32 else None
    grads = trainer.grads_fn(meta)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, params, first = [], [], None
    for _ in range(DEST_STEPS):
        total, loss = None, 0.0
        for b in batches:
            g, m = grads(state.params, b)
            g = list(flatten_params(g).values())
            total = g if total is None else [x + y for x, y in zip(total, g)]
            loss += float(m["loss"])
        mean = [t / len(batches) for t in total]
        first = first or {k: v.float().cpu() for k, v in zip(flatten_params(state.params), mean)}
        trainer.optimizer.step(state.params, with_leaves(state.params, mean), state.opt_state)
        losses.append(loss / len(batches))
        params.append({k: v.detach().to("cpu", torch.float32, copy=True) for k, v in
                       flatten_params(state.params).items()})
    peak = torch.cuda.max_memory_allocated()
    return dict(losses=losses, params=params, first_grads=first, forward=forward, peak=peak)


def destshard_rank(job_dir: str, port: str, rank: str, world: str, backend: str) -> None:
    """One rank of the destination-sharded world (this script run with
    `--destshard-rank`): joins the world and, per mesh, order and dtype,
    steps the flagship `DEST_STEPS` times from the reference's weights and
    writes its losses, parameters, kernel launches, step times, peak
    memory, the all_to_all's share of a profiled step and, in f32 over the
    naive order, `make_edgeshard_apply`'s forward at the initial weights."""
    import pickle

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.model.builder import flatten_params
    from ignnition_tpu_torch.parallel import (distributed, make_edgeshard_apply,
                                              make_edgeshard_train_step, make_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(rank), int(world)
    with open(os.path.join(job_dir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    distributed.initialize(f"localhost:{port}", world, rank, backend=backend)
    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    counts = Counts()
    out = {"backend": dist.get_backend()}
    for shape in job["meshes"]:
        mesh = make_mesh(*shape)
        for order in DEST_ORDERS:
            for dtype in (torch.float32, torch.bfloat16):
                if mesh.coords is None:
                    dist.barrier()
                    continue
                stacked, meta = job["inputs"][(shape, order)]
                trainer = igt.Trainer(igt.build(ir), igt.PaddingConfig(**DEST_PAD),
                                      compute_dtype=dtype)
                state = trainer.init_state(torch.Generator().manual_seed(SEED + 13))
                res = dict(coords=mesh.coords)
                if dtype == torch.float32 and order == "naive":
                    apply = make_edgeshard_apply(trainer.model, meta, mesh)
                    counts.reset()
                    res["forward"] = apply(state.params, stacked).float().cpu()
                    res["forward_launches"] = counts.read()
                step = make_edgeshard_train_step(trainer.model, trainer.optimizer,
                                                 trainer.loss_fn, meta, mesh,
                                                 compute_dtype=dtype)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                losses, params, times = [], [], []
                counts.reset()
                for _ in range(DEST_STEPS):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    _, _, loss = step(state.params, state.opt_state, stacked,
                                      generator=trainer.generator)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
                    losses.append(float(loss))
                    params.append({k: v.detach().to("cpu", torch.float32, copy=True)
                                   for k, v in flatten_params(state.params).items()})
                res["launches"] = counts.read()
                res["peak"] = torch.cuda.max_memory_allocated()
                # one more step under the profiler: the exchange's share (its
                # autograd Functions' host time, forward and backward: each
                # waits for its collective) and the gathers' scatter-add
                # backward on the device
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    step(state.params, state.opt_state, stacked, generator=trainer.generator)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                host = {}
                for e in prof.key_averages():
                    if e.device_type == DeviceType.CPU and (
                            e.key.startswith("_AllToAll") or e.key.startswith("_AllReduce")
                            or e.key == "parallel.all_reduce_gradients"):
                        host[e.key] = host.get(e.key, 0.0) + e.cpu_time_total / 1e3
                device, busy = {}, 0.0
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA:
                        ms = e.time_range.elapsed_us() / 1e3
                        device[e.name] = device.get(e.name, 0.0) + ms
                        busy += ms
                res.update(captured=step.captured, why_eager=step.why_eager)
                res.update(losses=losses, step_ms=times, profiled_step_ms=wall, host_ms=host,
                           device_busy_ms=busy,
                           scatter_add_ms=sum(v for k, v in device.items()
                                              if "index" in k and ("put" in k or "backward" in k)),
                           top_device=sorted(device.items(), key=lambda kv: -kv[1])[:5],
                           params=params if (rank == 0 and dtype == torch.float32) else None,
                           checksum=[float(sum(float(v.double().sum()) for v in p.values()))
                                     for p in params])
                out[(shape, order, str(dtype))] = res
                del state, step, trainer
                dist.barrier()
    with open(os.path.join(job_dir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _hold_f32_params(what, got_params, ref, lr=1e-3) -> str:
    """`tests/test_torch_train.py`'s rule for two implementations, step by
    step: the elements whose first gradient is above 1e-3 of the leaf's
    largest at rtol 5e-4 / atol 5e-6, every element within 2 lr a step."""
    firm = {k: g.abs() >= 1e-3 * g.abs().max() for k, g in ref["first_grads"].items()}
    worst_firm = worst_any = 0.0
    for i in range(DEST_STEPS):
        for k, want in ref["params"][i].items():
            err = (got_params[i][k] - want).abs()
            if not bool((err[firm[k]] <= 5e-6 + 5e-4 * want.abs()[firm[k]]).all()):
                raise AssertionError(f"{what}: step {i} {k} beyond the limits")
            if float(err.max()) > 2 * lr * (i + 1):
                raise AssertionError(f"{what}: step {i} {k} moved past 2 lr a step")
            if firm[k].any():
                worst_firm = max(worst_firm, float(err[firm[k]].max()))
            worst_any = max(worst_any, float(err.max()))
    return f"parameters: firm elements max |diff| {worst_firm:.3e}, any {worst_any:.3e}"


def destshard_steps(card: str) -> dict:
    """Phase 13: the flagship at full width (hs 32, 8 iterations) on one
    graph of 2,048 links and 16,384 paths of length 8 (131,072 edges a
    direction, locality latent and ids scrambled: `make_local_sample`) a
    data row, destination-sharded over 1x2, 1x4 and 2x2 meshes (two graphs)
    of a gloo world of 4 on the card, in the dataset's order and
    renumbered by `parallel.locality`, 3 steps each in f32 and bf16, held
    to the single-device steps on the card: f32 losses at rtol 1e-5 and
    parameters by `tests/test_torch_train.py`'s rule, bf16 losses within
    3e-2, `make_edgeshard_apply`'s f32 forward within 1e-5; every rank of a
    mesh ends with the same parameters; each rank's launches of A, B, C,
    the id-keyed kernel, D and E counted; the halo, the exchange's share of
    a profiled step and each rank's peak memory printed."""
    import tempfile

    import ignnition_tpu_torch as igt

    t0 = time.perf_counter()
    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    graphs = [make_local_sample(np.random.default_rng(SEED + 13 + g), **FLAGSHIP)
              for g in range(2)]
    inputs = destshard_inputs(ir, graphs)
    refs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for n_data in (1, 2):
            refs[(dtype, n_data)] = destshard_reference(
                ir, inputs[((n_data, 2), "naive")]["rows"], dtype)
    t_ref = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="chip_smoke_destshard_")
    job = {"inputs": {k: (v["stacked"], v["meta"]) for k, v in inputs.items()}}
    t1 = time.perf_counter()
    ranks = spawn_parallel_world(4, "gloo", DEST_MESHES, root, job=job,
                                 flag="--destshard-rank")
    print(f"[dest_shard] inputs and single-device references {t_ref:.1f} s; the world of 4 "
          f"(gloo, one card) {time.perf_counter() - t1:.1f} s")
    total = {k: 0 for k in Counts().read()}
    out = {}
    for shape in DEST_MESHES:
        n_data, m = shape
        for order in DEST_ORDERS:
            for dtype in (torch.float32, torch.bfloat16):
                key = (shape, order, str(dtype))
                got = [r[key] for r in ranks if key in r]
                if len(got) != n_data * m:
                    raise AssertionError(f"dest_shard {shape} {order}: {len(got)} ranks")
                ref = refs[(dtype, n_data)]
                what = f"dest_shard {n_data}x{m} {order} {str(dtype)[6:]}"
                if len({tuple(g["checksum"]) for g in got}) != 1:
                    raise AssertionError(f"{what}: the ranks' parameters differ")
                lead = got[0]
                if any(g["captured"] or "gloo" not in g["why_eager"] for g in got):
                    raise AssertionError(f"{what}: a rank's step is not eager over gloo")
                if order == DEST_ORDERS[0] and dtype == torch.float32:
                    print(f"[dest_shard] {n_data}x{m}: every rank's step eager: "
                          f"{lead['why_eager']}")
                if dtype == torch.float32:
                    np.testing.assert_allclose(lead["losses"], ref["losses"], rtol=1e-5,
                                               err_msg=what)
                    held = (f"losses {lead['losses']} against {ref['losses']} (rtol 1e-5); "
                            + _hold_f32_params(what, lead["params"], ref))
                else:
                    diffs = [abs(a - b) for a, b in zip(lead["losses"], ref["losses"])]
                    if max(diffs) > BF16_STEP_ATOL:
                        raise AssertionError(f"{what}: a step's loss {max(diffs):.3e} from the "
                                             f"single-device step's")
                    held = (f"losses {lead['losses']} against {ref['losses']} (max |diff| "
                            f"{max(diffs):.3e}, atol {BF16_STEP_ATOL})")
                if "forward" in lead:
                    worst = 0.0
                    for d in range(n_data):
                        mask = inputs[(shape, order)]["rows"][d][0]["node_mask_path"] > 0
                        have = lead["forward"][d][:mask.size][torch.from_numpy(mask)]
                        want = ref["forward"][d][torch.from_numpy(mask)]
                        torch.testing.assert_close(have, want, rtol=1e-5, atol=1e-5,
                                                   msg=lambda e: f"{what} forward: {e}")
                        worst = max(worst, float((have - want).abs().max()))
                    held += f"; make_edgeshard_apply forward max |diff| {worst:.3e}"
                    for g in got:
                        expect_counts(f"{what} forward rank {g['coords']}",
                                      g["forward_launches"], csr_segment_sum=ITERATIONS,
                                      masked_gru_scan=ITERATIONS)
                s, it = DEST_STEPS, ITERATIONS
                for g in got:
                    expect_counts(f"{what} rank {g['coords']}", g["launches"],
                                  csr_segment_sum=it * s, masked_gru_scan=it * s,
                                  masked_gru_scan_bwd=it * s)
                    for k, v in g["launches"].items():
                        total[k] += v
                step_ms = float(np.median(lead["step_ms"][1:]))
                exchange = sum(v for k, v in lead["host_ms"].items() if k.startswith("_AllToAll"))
                if not exchange > 0:
                    raise AssertionError(f"{what}: the profile shows no all_to_all")
                share = exchange / lead["profiled_step_ms"]
                peaks = [g["peak"] / 2**20 for g in got]
                print(f"[dest_shard] {what}: {held}; step {step_ms:.1f} ms (median of steps "
                      f"2-{DEST_STEPS}, CUDA events, rank {lead['coords']}); profiled step "
                      f"{lead['profiled_step_ms']:.1f} ms: all_to_all {exchange:.1f} ms "
                      f"({share:.1%}, host time of "
                      + ", ".join(f"{k} {v:.1f}" for k, v in sorted(lead["host_ms"].items()))
                      + f"), device busy {lead['device_busy_ms']:.1f} ms, the gathers' "
                      f"scatter-add backward {lead['scatter_add_ms']:.2f} ms on the device; top "
                      "device kernels " + ", ".join(f"{k[:40]} {v:.2f}" for k, v in
                                                    lead["top_device"][:3])
                      + f"; peak memory a rank {min(peaks):.0f}-{max(peaks):.0f} MiB against "
                      f"{ref['peak'] / 2**20:.0f} MiB single-device; on {card}")
                out[what] = dict(losses=lead["losses"], reference_losses=ref["losses"],
                                 step_ms=step_ms, all_to_all_share=share,
                                 peak_mib_per_rank=peaks,
                                 single_device_peak_mib=ref["peak"] / 2**20,
                                 launches_per_rank=[g["launches"] for g in got])
        for order in DEST_ORDERS:
            inp = inputs[(shape, order)]
            out[f"halo {n_data}x{m} {order}"] = dict(
                halo_rows=inp["dims"]["halo"],
                boundary_frac={a: r["boundary_frac"] for a, r in inp["frac"].items()},
                v2_halo_bytes={a: r["v2_halo_bytes"] for a, r in inp["comm"].items()},
                v1_full_psum_bytes={a: r["v1_full_psum_bytes"] for a, r in inp["comm"].items()})
    print("[dest_shard] launch counts, every rank of every mesh: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    print(f"[time] phase 13 (destination sharding) {time.perf_counter() - t0:.1f} s")
    return dict(launches=total, meshes=out)


def phase13_alone() -> None:
    """Phase 13 without the other phases (the kernels built first):
    `python3 -c "import chip_smoke as c; c.phase13_alone()"`."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    _build.library()
    print(f"[time] build {time.perf_counter() - t0:.1f} s")
    out = destshard_steps(card)
    print(json.dumps({"launches": out["launches"], "card": card}))


# --------------------------------------------------------------------------
# phase 14: the compiled steps (CUDA graphs) against the eager ones
# --------------------------------------------------------------------------

# batches of one meta a path, stepped eagerly and replayed: a warm-up, a
# capture and a replay
COMPILED_BATCHES = 3
COMPILED_RANDOM_STEPS = 3
COMPILED_ACCUM = 3  # microbatches of the accumulation step
# holds of a replayed step against the eager one, of each leaf's largest
# entry (the same kernels in the same order: bitwise equality is expected; a
# value frozen at capture, a learning rate or a bias correction, moves the
# parameters by some 1e-2 in 5 steps)
COMPILED_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-6}
SERVED_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}
# host calls that hand the device work, as torch.profiler names them
HOST_LAUNCHES = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel"),
                 "graph": ("cudaGraphLaunch", "cuGraphLaunch"),
                 "copy": ("cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")}


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `runs` calls of `fn` after `warmup`, each
    between two CUDA events."""
    times = []
    for i in range(warmup + runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def port_kernels_by_name(names, runs: int) -> dict:
    """{device kernel name: launches a call} of the port's kernels
    (`ALL_PORT_KERNELS`) among the device kernel `names` of `runs` calls."""
    got = {}
    for n in names:
        if any(k in n for k in ALL_PORT_KERNELS):
            got[n] = got.get(n, 0) + 1
    return {k: v / runs for k, v in sorted(got.items())}


def hold_replayed_kernels(what: str, fn, first: tuple = None) -> dict:
    """Hold the port's kernels that a replayed call of `fn` launches,
    counted by name in torch.profiler's device activity
    (`port_kernels_by_name`), to those of the same call made eagerly
    (`capture.eager()`); `first`: an (eager, replayed) pair of such counts
    already taken. A profile now and then loses device events
    (`profiler_losses`; one run lost 1 of an eager step's 24 kernel-B
    launches) and never adds one, so each side keeps, by name, the most that
    any of its profiles saw, and up to 3 more pairs of profiles
    (`profiled_device_kernels`, one call each) are taken until the two sides
    agree. Returns the replayed call's counts."""
    from ignnition_tpu_torch.training import capture

    seen = ({}, {})
    pairs = [first] if first is not None else []
    for attempt in range(4):
        if len(pairs) <= attempt:
            with capture.eager():
                eager = port_kernels_by_name(profiled_device_kernels(fn, 1), 1)
            pairs.append((eager, port_kernels_by_name(profiled_device_kernels(fn, 1), 1)))
        for side, counts in zip(seen, pairs[attempt]):
            for k, v in counts.items():
                side[k] = max(side.get(k, 0), v)
        if seen[0] and seen[0] == seen[1]:
            if attempt:
                print(f"    {what}: the port's kernels agreed after {attempt + 1} pairs of "
                      f"profiles (launches a call by profile, eager / replayed: "
                      + "; ".join(f"{sum(e.values()):g} / {sum(r.values()):g}"
                                  for e, r in pairs) + ")")
            return seen[1]
    raise AssertionError(f"{what}: the replayed call launched the port's kernels {seen[1]}, "
                         f"the eager call {seen[0]} (torch.profiler, by kernel name, the most "
                         f"of {len(pairs)} profiles each)")


def profiled_calls(fn, runs: int = 5) -> dict:
    """Device busy milliseconds, device activities (kernels, copies), the
    host calls that hand the device work (kernel launches, graph launches,
    copies and sets) and the port's kernels by name
    (`port_kernels_by_name`), each a call of `fn`, from torch.profiler over
    `runs` calls (`profiled_events`; the sleep kernel and its launch not
    counted)."""
    from torch.autograd import DeviceType

    busy, activities = 0.0, 0
    host = dict.fromkeys(HOST_LAUNCHES, 0)
    events = profiled_events(fn, runs)
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if "spin_kernel" not in e.name:
                busy += e.time_range.elapsed_us() / 1e3
                activities += 1
            continue
        for kind, names in HOST_LAUNCHES.items():
            if e.name.startswith(names):
                host[kind] += 1
    host["kernel"] = max(0, host["kernel"] - 1)  # the sleep kernel's launch
    names = [e.name for e in events if e.device_type == DeviceType.CUDA]
    htod = sum(e.time_range.elapsed_us() / 1e3 for e in events
               if e.device_type == DeviceType.CUDA and "HtoD" in e.name)
    out = dict(busy_ms=busy / runs, device_activities=activities / runs,
               port_kernels=port_kernels_by_name(names, runs),
               nccl_kernels=sorted({n for n in names if "nccl" in n.lower()}),
               htod_ms=htod / runs)
    out.update({f"host_{k}_launches": v / runs for k, v in host.items()})
    return out


def leaf_gap(got, want) -> tuple:
    """(the worst leaf, its gap by `leaf_gaps`) between two trees of the
    same layout."""
    from ignnition_tpu_torch.model.builder import flatten_params

    gaps = leaf_gaps(flatten_params(got), flatten_params(want))
    worst = max(gaps, key=gaps.get)
    return worst, gaps[worst]


def loss_gap(got: list, want: list) -> float:
    """The largest |difference| of two loss sequences over the largest |loss|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def one_meta(ir, padding, groups, training=True) -> tuple:
    """(arrays of each group of samples, the one meta they are all padded to)."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.data.graph import merge_metas

    meta = merge_metas([igt.build_batch(g, ir, padding, training=training)[1] for g in groups],
                       ir)
    return [igt.build_batch(g, ir, padding, training=training, target=meta)[0]
            for g in groups], meta


def eager_vs_replayed_steps(name, ir, padding, batches, meta, edge_messages, card, counts,
                            add) -> dict:
    """(a) for one path: `COMPILED_BATCHES` bf16 steps over the batches from
    one initial state, eagerly (`capture.eager()`) and through the public
    step (a warm-up, a capture, replays), held step by step: the losses and
    every leaf of the parameters and the optimizer state within
    `COMPILED_TOL`; the wrappers' counters of the warm-up and the capture
    equal to an eager step's, and none in a replay (no wrapper runs). Then
    each way's step time (median of 20 after 3, CUDA events), device busy
    and idle share, device activities, host launches and the port's kernels
    by name a step (torch.profiler): the replayed step's kernels held to
    the eager step's (`hold_replayed_kernels`). And the capture's seconds,
    graph pool and static input buffers against the eager step's peak."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.training import capture

    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
    tree = trainer.model.init(torch.Generator().manual_seed(SEED))
    device_batches = [to_device(a, trainer.device) for a in batches]
    step = trainer.train_step_fn(meta)
    captured = trainer.graphs.captured[("train", meta, None)]
    runs = {}
    for way in ("eager", "replayed"):
        state = trainer.init_state(params=tree)
        losses, launches, seen = [], [], []
        with capture.eager() if way == "eager" else contextlib.nullcontext():
            for batch in device_batches:
                counts.reset()
                state, m = step(state, batch)
                got = counts.read()
                add(got)
                launches.append(got)
                losses.append(float(m["total"]))
                seen.append(captured.last)
        runs[way] = dict(state=state, losses=losses, launches=launches, seen=seen)
    eager, replayed = runs["eager"], runs["replayed"]
    want_seen = ["warm-up", "capture"] + ["replay"] * (COMPILED_BATCHES - 2)
    if replayed["seen"] != want_seen or set(eager["seen"]) != {"eager"}:
        raise AssertionError(f"(a) {name}: the calls ran as {eager['seen']} and "
                             f"{replayed['seen']}, not eagerly and as {want_seen}")
    # the wrappers' counters: every eager step alike and not empty, the
    # warm-up and the capture (which records) as an eager step, a replay none
    per_step = eager["launches"][0]
    none = dict.fromkeys(per_step, 0)
    want_launches = [per_step, per_step] + [none] * (COMPILED_BATCHES - 2)
    if (not any(per_step.values()) or eager["launches"] != [per_step] * COMPILED_BATCHES
            or replayed["launches"] != want_launches):
        raise AssertionError(f"(a) {name}: the wrappers counted {replayed['launches']} in "
                             f"the replayed run, {eager['launches']} in the eager run")
    tol = COMPILED_TOL[torch.bfloat16]
    gaps = dict(loss=loss_gap(replayed["losses"], eager["losses"]))
    for tree_name in ("params", "opt_state"):
        worst, gap = leaf_gap(getattr(replayed["state"], tree_name),
                              getattr(eager["state"], tree_name))
        gaps[tree_name] = (worst, gap)
    bitwise = gaps["loss"] == 0.0 and all(g == 0.0 for _, g in (gaps["params"],
                                                                 gaps["opt_state"]))
    per_step = {k: v for k, v in per_step.items() if v}
    print(f"[compiled] (a) {name}: {COMPILED_BATCHES} bf16 steps over {COMPILED_BATCHES} batches "
          f"of one meta, eager and {' / '.join(replayed['seen'])}: loss+reg "
          + " ".join(f"{v:.5f}" for v in replayed["losses"])
          + f"; largest gap of the loss {gaps['loss']:.3e}, of a parameter leaf "
          f"{gaps['params'][1]:.3e} ({gaps['params'][0]}), of an optimizer-state leaf "
          f"{gaps['opt_state'][1]:.3e} ({gaps['opt_state'][0]}) of its largest entry (limit "
          f"{tol:g}){'; bitwise equal' if bitwise else ''}; the wrappers counted "
          f"{per_step} in each eager step, the warm-up and the capture, none in a replay")
    worst_gap = max(gaps["loss"], gaps["params"][1], gaps["opt_state"][1])
    if not worst_gap <= tol:
        raise AssertionError(f"(a) {name}: the replayed steps lie {worst_gap:.3e} from the "
                             f"eager ones (limit {tol:g})")

    batch = device_batches[0]
    out = dict(loss_gap=gaps["loss"], params_gap=gaps["params"][1],
               opt_state_gap=gaps["opt_state"][1], bitwise=bitwise,
               capture_s=captured.capture_seconds,
               graph_pool_mib=captured.pool_bytes / 2**20,
               static_inputs_mib=trainer.graphs.static_bytes() / 2**20)
    ports = {}
    for way in ("eager", "replayed"):
        state = runs[way]["state"]
        run = lambda: step(state, batch)  # noqa: E731
        with capture.eager() if way == "eager" else contextlib.nullcontext():
            ms = median_ms(run)
            prof = profiled_calls(run)
            if way == "eager":
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                run()
                torch.cuda.synchronize()
                out["eager_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        ports[way] = prof.pop("port_kernels")
        out[way] = dict(step_ms=ms, edge_messages_per_s=edge_messages / ms * 1e3,
                        device_busy_ms=prof["busy_ms"],
                        device_idle_share=max(0.0, 1.0 - prof["busy_ms"] / ms),
                        **{k: v for k, v in prof.items() if k != "busy_ms"})
    kernels = hold_replayed_kernels(f"(a) {name}", lambda: step(runs["replayed"]["state"], batch),
                                    first=(ports["eager"], ports["replayed"]))
    if captured.last != "replay":
        raise AssertionError(f"(a) {name}: the profiled step ran as {captured.last}")
    out["port_kernel_launches"] = sum(kernels.values())
    e, r = out["eager"], out["replayed"]
    print(f"[compiled] (a) {name}: step {e['step_ms']:.3f} ms eager, {r['step_ms']:.3f} ms "
          f"replayed (x{e['step_ms'] / r['step_ms']:.2f}; median of 20 after 3, CUDA events), "
          f"{e['edge_messages_per_s'] / 1e6:.1f} -> {r['edge_messages_per_s'] / 1e6:.1f} M "
          f"edge-messages/s; device busy {e['device_busy_ms']:.3f} -> "
          f"{r['device_busy_ms']:.3f} ms, idle {e['device_idle_share']:.1%} -> "
          f"{r['device_idle_share']:.1%}; device activities a step "
          f"{e['device_activities']:.0f} -> {r['device_activities']:.0f}; host launches a step: "
          f"kernels {e['host_kernel_launches']:.0f} -> {r['host_kernel_launches']:.0f}, graphs "
          f"{e['host_graph_launches']:.0f} -> {r['host_graph_launches']:.0f}, copies "
          f"{e['host_copy_launches']:.0f} -> {r['host_copy_launches']:.0f} (torch.profiler, 5 "
          f"steps); the port's kernels a step by name, replayed as eager: "
          f"{out['port_kernel_launches']:.0f} launches of {len(kernels)} kernels (torch.profiler);"
          f" capture {out['capture_s']:.2f} s, graph pool {out['graph_pool_mib']:.0f} MiB and "
          f"static inputs {out['static_inputs_mib']:.1f} MiB against the eager step's peak "
          f"{out['eager_peak_mib']:.0f} MiB; on {card}")
    return out


def compiled_step_paths(homogeneous_samples: dict) -> dict:
    """(a)'s paths: {name: (ir, padding, batches, meta, edge-messages a
    step)}, each `COMPILED_BATCHES` training batches of different contents
    padded to one meta. The RouteNet family draws new graphs at its sizes;
    the homogeneous models take phase 8's 2 requests of 1,024 graphs each and
    the first of them with its graphs rotated."""
    import ignnition_tpu_torch as igt

    rng = np.random.default_rng(SEED + 14)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    flagship_ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    families = [
        ("flagship", flagship_ir, lambda: make_sample(rng, **FLAGSHIP)),
        ("flagship_x4", flagship_ir, lambda: make_sample(rng, **FLAGSHIP_X4)),
        ("attention", igt.parse_model_description(attention_description(), FEATURE_DIMS),
         lambda: make_sample(rng, **FLAGSHIP)),
        ("qsize", igt.parse_model_description(qsize_description(), QSIZE_FEATURE_DIMS),
         lambda: make_qsize_sample(rng, **QSIZE)),
        ("mlp_message", igt.parse_model_description(mlp_message_description(), FEATURE_DIMS),
         lambda: make_sample(rng, **FLAGSHIP)),
    ]
    paths = {}
    for name, ir, make in families:
        batches, meta = one_meta(ir, padding, [[make()] for _ in range(COMPILED_BATCHES)])
        edges = sum(int(np.sum(v > 0)) for k, v in batches[0].items()
                    if k.startswith("edge_mask_"))
        paths[name] = (ir, padding, batches, meta, ITERATIONS * edges)
    for name in ("graphprop CSR", "graphprop blocks", "linkpred"):
        ir, requests = homogeneous_samples[name]
        shift = HOMOGENEOUS_GRAPHS // 3
        groups = list(requests) + [r[shift:] + r[:shift] for r in requests]
        batches, meta = one_meta(ir, igt.PaddingConfig(), groups[:COMPILED_BATCHES])
        edges = int(np.sum(batches[0][f"edge_mask_{NODE_ADJ}"] > 0))
        passes = sum(len(mp.sources) for stage in ir.stages for mp in stage.passes)
        paths[name] = (ir, igt.PaddingConfig(), batches, meta,
                       ir.num_iterations * passes * edges)
    return paths


def eager_vs_replayed_forwards(served: dict, homogeneous_samples: dict, card: str) -> dict:
    """(b): phase 11's `ServingModel` and `LoadedServingModel` of the
    flagship, attention, x4, graphprop CSR and linkpred (bf16; linkpred also
    f32): two requests of different contents each (phase 11's, and for the
    RouteNet family its graph with other features, since a new graph's link
    in-degrees would leave the served meta; for the homogeneous models phase
    8's second request), the replayed predictions held to the eager ones
    (`SERVED_TOL` of the largest |prediction|); the device forward (median of
    20, CUDA events) and the whole request (median of 3, host clock), eager
    and replayed; the replayed forward's kernels held to the eager one's
    (`hold_replayed_kernels`)."""
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.training import capture

    rng = np.random.default_rng(SEED + 15)
    out = {}
    for name, (models, request) in served.items():
        if name in homogeneous_samples:
            second = homogeneous_samples[name][1][1]
        else:
            second = [dataclasses.replace(s, features={
                k: (v * rng.uniform(0.5, 1.5, v.shape)).astype(v.dtype)
                for k, v in s.features.items()}) for s in request]
        for tag, pair in models.items():
            dtype = torch.bfloat16 if tag == "bf16" else torch.float32
            for who, model in zip(("in process", "artifact"), pair):
                requests = [request, second]
                arrays = [model.build_batch(r) for r in requests]
                with capture.eager():
                    want = [model.predict(a, denormalize=False) for a in arrays]
                got = [model.predict(a, denormalize=False) for a in arrays]
                ran = model.graphs.captured[model.meta].last
                if ran != "replay":
                    raise AssertionError(f"(b) {name} {who} ({tag}): the forward ran as {ran}")
                scale = max(float(np.max(np.abs(w))) for w in want)
                diff = max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))
                limit = SERVED_TOL[dtype] * scale
                if not diff <= limit:
                    raise AssertionError(f"(b) {name} {who} ({tag}): replayed predictions lie "
                                         f"{diff:.3e} from the eager ones (limit {limit:.3e})")
                inputs = to_device({k: v for k, v in model._check(arrays[0]).items()}
                                   if who == "artifact" else
                                   {k: v for k, v in arrays[0].items()
                                    if k not in ("label", "label_mask", "label_perm")},
                                   model.device)
                entry = dict(max_abs_diff=diff, limit=limit)
                for way in ("eager", "replayed"):
                    with capture.eager() if way == "eager" else contextlib.nullcontext():
                        entry[f"forward_ms_{way}"] = median_ms(
                            lambda: model.forward_device(inputs))
                        times = []
                        for _ in range(4):
                            t1 = time.perf_counter()
                            model.predict_samples(request)
                            times.append((time.perf_counter() - t1) * 1e3)
                        entry[f"request_ms_{way}"] = float(np.median(times[1:]))
                kernels = hold_replayed_kernels(f"(b) {name} {who} ({tag})",
                                                lambda: model.forward_device(inputs))
                ran = model.graphs.captured[model.meta].last
                if ran != "replay":
                    raise AssertionError(f"(b) {name} {who} ({tag}): the profiled forward ran "
                                         f"as {ran}")
                entry["port_kernel_launches"] = sum(kernels.values())
                print(f"[compiled] (b) {name} {who} ({tag}): 2 requests, replayed vs eager "
                      f"predictions max abs {diff:.3e} (limit {limit:.3e} = "
                      f"{'2^-8' if dtype == torch.bfloat16 else '1e-6'} x max |pred| "
                      f"{scale:.4f}){'; bitwise equal' if diff == 0.0 else ''}; forward "
                      f"{entry['forward_ms_eager']:.3f} -> {entry['forward_ms_replayed']:.3f} ms "
                      f"(median of 20, CUDA events), request {entry['request_ms_eager']:.1f} -> "
                      f"{entry['request_ms_replayed']:.1f} ms (median of 3, host clock); the "
                      f"port's kernels a forward by name, replayed as eager: "
                      f"{entry['port_kernel_launches']:.0f} launches (torch.profiler); {card}")
                out[f"{name} {who} ({tag})"] = entry
    return out


def random_layers_replayed(dev, card: str) -> dict:
    """(c): phase 10 (a)'s model (Dropout, AlphaDropout, GaussianNoise in its
    readout), f32. Its training loss captured alone over fixed parameters,
    from one generator state, eagerly and replayed: the first three calls
    alike, and two successive replays draw other masks (other losses). Then 3
    training steps eagerly and through the public step from one generator
    state: the replayed trajectory is held to the eager one (1e-6). The
    graph-safe generator gives the eager sequence: each replay advances the
    registered generator's offset by what the capture recorded."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.training import capture

    igt.register_layer("ChipScale", chip_scale_init, chip_scale_apply)  # as phase 10 does
    ir = igt.parse_model_description(layers_description(), FEATURE_DIMS)
    rng = np.random.default_rng(SEED + 16)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    arrays, meta = igt.build_batch([make_sample(rng, **FLAGSHIP)], ir, padding, training=True)
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=None)
    batch = to_device(arrays, dev)
    tree = trainer.model.init(torch.Generator().manual_seed(SEED))
    state = trainer.init_state(params=tree)

    def training_loss(params, b):
        with torch.no_grad():
            return trainer._loss(params, b, meta)[0]

    probe = trainer.graphs.step(training_loss, ("training loss", meta), "the training loss")
    losses = {}
    for way in ("eager", "replayed"):
        trainer.generator.manual_seed(SEED)
        with capture.eager() if way == "eager" else contextlib.nullcontext():
            losses[way] = [float(probe(state.params, batch)) for _ in range(4)]
    if probe.last != "replay":
        raise AssertionError(f"(c) the training loss ran as {probe.last}")
    same_sequence = losses["replayed"] == losses["eager"]
    print(f"[compiled] (c) the training loss over fixed parameters, 4 calls from one generator "
          f"state: eager {losses['eager']}, warm-up / capture / replay / replay "
          f"{losses['replayed']}: {'the same sequence' if same_sequence else 'ANOTHER SEQUENCE'}")
    if not len(set(losses["replayed"][1:])) == 3:
        raise AssertionError(f"(c) successive replays drew the same masks: {losses['replayed']}")

    runs = {}
    step = trainer.train_step_fn(meta)
    for way in ("eager", "replayed"):
        s = trainer.init_state(params=tree)
        trainer.generator.manual_seed(SEED)
        with capture.eager() if way == "eager" else contextlib.nullcontext():
            totals = [float(step(s, batch)[1]["total"]) for _ in range(COMPILED_RANDOM_STEPS)]
        runs[way] = (s, totals)
    gap = loss_gap(runs["replayed"][1], runs["eager"][1])
    worst, leaf = leaf_gap(runs["replayed"][0].params, runs["eager"][0].params)
    print(f"[compiled] (c) {COMPILED_RANDOM_STEPS} f32 steps from one generator state: loss+reg "
          f"eager {runs['eager'][1]}, replayed {runs['replayed'][1]}; largest gap of the loss "
          f"{gap:.3e}, of a parameter leaf {leaf:.3e} ({worst}) (limit 1e-6)")
    if not (same_sequence and max(gap, leaf) <= COMPILED_TOL[torch.float32]):
        raise AssertionError(f"(c) the replayed draws or trajectory leave the eager ones: "
                             f"{losses}, {max(gap, leaf):.3e}")
    return dict(losses=losses, trajectory_loss_gap=gap, trajectory_params_gap=leaf)


def accumulation_and_evaluation(dev, card: str) -> dict:
    """(d): the flagship in f32: `accum_train_step_fn` over `COMPILED_ACCUM`
    microbatches, 3 steps over two stacked groups of one meta, and
    `eval_step_fn` over two batches, eagerly and replayed; held at 1e-6 of
    the largest entry (losses, parameters, predictions)."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.parallel import stack_batches
    from ignnition_tpu_torch.training import capture

    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    rng = np.random.default_rng(SEED + 17)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    batches, meta = one_meta(ir, padding, [[make_sample(rng, **FLAGSHIP)]
                                           for _ in range(2 * COMPILED_ACCUM)])
    trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=None)
    tree = trainer.model.init(torch.Generator().manual_seed(SEED))
    groups = [stack_batches([(a, meta) for a in batches[i::2]], ir) for i in range(2)]
    stacked_meta = groups[0][1]
    stacked = [to_device(g, dev) for g, _ in groups]
    step = trainer.accum_train_step_fn(stacked_meta, COMPILED_ACCUM)
    captured = trainer.graphs.captured[("accum", stacked_meta, COMPILED_ACCUM, None)]
    runs = {}
    for way in ("eager", "replayed"):
        s = trainer.init_state(params=tree)
        with capture.eager() if way == "eager" else contextlib.nullcontext():
            totals = [float(step(s, stacked[i % 2])[1]["total"]) for i in range(3)]
        runs[way] = (s, totals)
    if captured.last != "replay":
        raise AssertionError(f"(d) the accumulation step ran as {captured.last}")
    gap = loss_gap(runs["replayed"][1], runs["eager"][1])
    worst, leaf = leaf_gap(runs["replayed"][0].params, runs["eager"][0].params)
    print(f"[compiled] (d) accumulation over {COMPILED_ACCUM} microbatches, 3 f32 steps over 2 "
          f"groups: loss+reg {runs['replayed'][1]}; largest gap of the loss {gap:.3e}, of a "
          f"parameter leaf {leaf:.3e} ({worst}) (limit 1e-6)")
    if not max(gap, leaf) <= COMPILED_TOL[torch.float32]:
        raise AssertionError(f"(d) the replayed accumulation lies {max(gap, leaf):.3e} from "
                             "the eager one")
    state = runs["replayed"][0]
    evaluate = trainer.eval_step_fn(meta)
    device_batches = [to_device(a, dev) for a in batches[:2]]
    worst_eval, ran = 0.0, []
    for i in range(4):
        b = device_batches[i % 2]
        preds, loss = evaluate(state.params, b)
        ran.append(trainer.graphs.captured[("eval", meta)].last)
        with capture.eager():
            want_p, want_l = evaluate(state.params, b)
        worst_eval = max(worst_eval, float((preds - want_p).abs().max())
                         / float(want_p.abs().max()), abs(float(loss) - float(want_l))
                         / abs(float(want_l)))
    print(f"[compiled] (d) evaluation step, 4 calls over 2 batches ({' / '.join(ran)}): largest "
          f"gap of the predictions and loss {worst_eval:.3e} of the largest (limit 1e-6)")
    if ran[-1] != "replay" or not worst_eval <= COMPILED_TOL[torch.float32]:
        raise AssertionError(f"(d) the evaluation step ran as {ran}, {worst_eval:.3e} from "
                             "eager")
    ms = {}
    for way in ("eager", "replayed"):
        with capture.eager() if way == "eager" else contextlib.nullcontext():
            ms[way] = median_ms(lambda: step(state, stacked[0]))
    print(f"[compiled] (d) the accumulation step ({COMPILED_ACCUM} microbatches, f32): "
          f"{ms['eager']:.3f} ms eager, {ms['replayed']:.3f} ms replayed (median of 20 after 3, "
          f"CUDA events); {card}")
    return dict(accum_loss_gap=gap, accum_params_gap=leaf, eval_gap=worst_eval,
                accum_step_ms=ms)


def compiled_steps(dev, card: str, homogeneous_samples: dict, served: dict,
                   pipeline: dict) -> dict:
    """Phase 14: (a) the training steps of eight paths eager against
    replayed, (b) the serving forwards, (c) the random layers, (d)
    accumulation and evaluation, and the device-cached `train()` loop of
    phase 9 (b) eager against replayed."""
    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    t0 = time.perf_counter()
    paths = compiled_step_paths(homogeneous_samples)
    print(f"[compiled] {len(paths)} paths of {COMPILED_BATCHES} batches each made in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    steps = {name: eager_vs_replayed_steps(name, *spec, card, counts, add)
             for name, spec in paths.items()}
    forwards = eager_vs_replayed_forwards(served, homogeneous_samples, card)
    random_layers = random_layers_replayed(dev, card)
    accum = accumulation_and_evaluation(dev, card)
    loop = {way: pipeline[key]["step_ms"] for way, key in (
        ("eager", 'cache_batches "device", eager'), ("replayed", 'cache_batches "device"'))}
    print(f"[compiled] (d) train(cache_batches=\"device\") (phase 9 (b)): step interval median "
          f"{loop['eager']:.2f} ms eager, {loop['replayed']:.2f} ms replayed; {card}")
    print("[compiled] main path launch counts: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, steps=steps, forwards=forwards, random_layers=random_layers,
                accumulation=accum, train_device_cache_ms=loop)


# --------------------------------------------------------------------------
# phase 15: the compiled sharded steps (CUDA graphs over NCCL)
# --------------------------------------------------------------------------

COMPILED_MESH_CALLS = 5  # calls of each sharded function, eagerly and then replayed
MESH_FUNCTIONS = ("data-parallel step", "destination-sharded step", "data-parallel forward",
                  "destination-sharded forward")


def compiled_mesh_inputs(ir) -> tuple:
    """(padding, {"dp": (stacked, meta), "es": (stacked, local meta)}): one
    flagship graph (2,048 links, 16,384 paths of length 8) stacked for a 1x1
    mesh, and partitioned into its one cell (`edgeshard._partition`: one
    shard, no halo)."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.parallel import edgeshard, stack_batches

    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    rng = np.random.default_rng(SEED + 15)
    arrays, meta = igt.build_batch([make_sample(rng, **FLAGSHIP)], ir, padding, training=True)
    stacked, meta = stack_batches([(arrays, meta)], ir)
    part, local = edgeshard._partition(arrays, meta, ir, 1)
    return padding, dict(dp=(stacked, meta), es=({k: v[None] for k, v in part.items()}, local))


def _mesh_function(name, trainer, mesh, inputs):
    """(call(state) -> loss or predictions, the sharded step) of one of
    `MESH_FUNCTIONS`, built with the trainer's graphs."""
    from ignnition_tpu_torch import parallel as par

    stacked, meta = inputs["dp" if name.startswith("data") else "es"]
    kw = dict(compute_dtype=trainer.compute_dtype, graphs=trainer.graphs)
    t = trainer
    if name.endswith("step"):
        make = (par.make_parallel_train_step if name.startswith("data")
                else par.make_edgeshard_train_step)
        step = make(t.model, t.optimizer, t.loss_fn, meta, mesh, **kw)
        return (lambda state: step(state.params, state.opt_state, stacked,
                                   generator=t.generator)[2]), step
    make = par.make_parallel_apply if name.startswith("data") else par.make_edgeshard_apply
    step = make(t.model, meta, mesh, **kw)
    return (lambda state: step(state.params, stacked)), step


def halo_exchange_replayed(mesh, dev) -> dict:
    """The halo exchange's collectives through a sharded step of the world
    of one: `all_to_all_start` / `all_to_all_wait` and the differentiable
    `all_to_all` with its backward, 3 calls eagerly and 3 through the graphs
    (a warm-up, a capture, a replay); returns how they ran and whether the
    outputs and gradients of each call agree bitwise."""
    from ignnition_tpu_torch.ops import _collectives as col
    from ignnition_tpu_torch.parallel.steps import ShardedStep
    from ignnition_tpu_torch.training import capture

    group = mesh.model_group

    def exchange(generator, w, inputs):
        pending = col.all_to_all_start(inputs["x"] * w, group)
        y = col.all_to_all_wait(pending)
        z = col.all_to_all(y * 2.0, group)
        (g,) = torch.autograd.grad((z * z).sum(), w)
        # no output carries the autograd graph: a warm-up's graph through
        # the exchanges, kept past it, fails the capture of the next call
        return {"y": y.detach().clone(), "g": g}

    x = torch.randn(512, HS, device=dev, generator=torch.Generator(dev).manual_seed(SEED))
    w = torch.full((HS,), 0.5, device=dev, requires_grad=True)
    sharded = ShardedStep("the halo exchange", mesh, dev, None,
                          lambda i: sharded.run(("halo",), exchange, w, {"x": x + i}))
    runs = {}
    for way in ("eager", "replayed"):
        with capture.eager() if way == "eager" else contextlib.nullcontext():
            runs[way] = []
            for i in range(3):
                out = sharded(i)
                runs[way].append((sharded.last.last, out["y"].cpu(), out["g"].cpu()))
    equal = all(torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
                for a, b in zip(runs["eager"], runs["replayed"]))
    return dict(captured=sharded.captured, why_eager=sharded.why_eager,
                ran=[r[0] for r in runs["replayed"]], bitwise=equal)


def compiled_mesh_rank(mesh, counts, dev) -> dict:
    """Phase 15's work, in the NCCL world of one that phase 12 spawns (its
    1x1 mesh): each of `MESH_FUNCTIONS` at full width from seed-0 weights, in
    f32 and bf16, called `COMPILED_MESH_CALLS` times eagerly
    (`capture.eager()`) and then through the trainer's graphs from the same
    state: how each call ran, each call's launches from Python, the gap of
    each replayed call's output (and parameters) from the eager one's, of
    each leaf's largest entry; then, in bf16, each way's call time (median
    of 20 after 3, CUDA events) and profile (busy, host launches, NCCL
    kernels); in both dtypes the port's kernels by name held replayed
    against eager (`hold_replayed_kernels`), and the capture's seconds,
    pool and static inputs. The holds are phase 15's, in the parent."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.model.builder import flatten_params
    from ignnition_tpu_torch.training import capture

    ir = igt.parse_model_description(flagship_description(), FEATURE_DIMS)
    tree = igt.build(ir).init(torch.Generator().manual_seed(SEED))
    padding, inputs = compiled_mesh_inputs(ir)
    snap = lambda tree: {k: v.detach().to("cpu", torch.float32, copy=True)  # noqa: E731
                         for k, v in flatten_params(tree).items()}
    out = {"halo": halo_exchange_replayed(mesh, dev)}
    for dtype in (torch.float32, torch.bfloat16):
        for name in MESH_FUNCTIONS:
            trainer = igt.Trainer(igt.build(ir), padding, compute_dtype=dtype)
            call, step = _mesh_function(name, trainer, mesh, inputs)
            runs = {}
            for way in ("eager", "eager again", "replayed"):
                state = trainer.init_state(params=tree)
                trainer.generator.manual_seed(SEED)
                got = dict(outputs=[], params=[], launches=[], ran=[])
                with capture.eager() if way != "replayed" else contextlib.nullcontext():
                    for _ in range(COMPILED_MESH_CALLS):
                        counts.reset()
                        y = call(state)
                        got["launches"].append(counts.read())
                        got["outputs"].append(y.detach().to("cpu", torch.float32, copy=True))
                        got["ran"].append(step.last.last)
                        if name.endswith("step"):
                            got["params"].append(snap(state.params))
                got["state"] = state
                runs[way] = got
            eager, replayed = runs["eager"], runs["replayed"]

            def run_gaps(got, want):
                """Each call's output gap and each call's parameter gap (the
                optimizer state's after the last), of each leaf's largest."""
                outs = [float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
                        for a, b in zip(got["outputs"], want["outputs"])]
                params = [max(leaf_gaps(a, b).values())
                          for a, b in zip(got["params"], want["params"])]
                if name.endswith("step"):
                    params.append(max(leaf_gaps(snap(got["state"].opt_state),
                                                snap(want["state"].opt_state)).values()))
                return outs, params

            gaps, param_gaps = run_gaps(replayed, eager)
            control = max(sum(run_gaps(runs["eager again"], eager), []))
            last = step.last
            res = dict(captured=step.captured, why_eager=step.why_eager, ran_eager=eager["ran"],
                       ran_replayed=replayed["ran"], launches_eager=eager["launches"],
                       launches_replayed=replayed["launches"], output_gaps=gaps,
                       param_gaps=param_gaps, control_gap=control,
                       bitwise=not any(gaps) and not any(param_gaps),
                       capture_s=last.capture_seconds,
                       pool_mib=None if last.pool_bytes is None else last.pool_bytes / 2**20,
                       static_mib=trainer.graphs.static_bytes() / 2**20,
                       recorded=dict(last.recorded))
            state = replayed["state"]
            ports = None
            if dtype == torch.bfloat16:  # timed and profiled in bf16, the steps' dtype
                ports = {}
                for way in ("eager", "replayed"):
                    with capture.eager() if way == "eager" else contextlib.nullcontext():
                        ms = median_ms(lambda: call(state))
                        prof = profiled_calls(lambda: call(state))
                    ports[way] = prof.pop("port_kernels")
                    res[way] = dict(ms=ms, idle_share=max(0.0, 1.0 - prof["busy_ms"] / ms),
                                    **prof)
                ports = (ports["eager"], ports["replayed"])
            what = f"(15) {name} {str(dtype)[6:]}"
            res["port_kernels"] = hold_replayed_kernels(what, lambda: call(state), first=ports)
            if step.last.last != "replay":
                raise AssertionError(f"{what}: the profiled call ran as {step.last.last}")
            out[(name, str(dtype))] = res
            del runs, state, step, trainer
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    return out


def compiled_mesh(card: str, ranks: list) -> dict:
    """Phase 15: what `compiled_mesh_rank` brought back from the NCCL world of
    one, held and printed: every function captured (the mesh is NCCL), its
    calls eager x5 and warm-up, capture, replay x3; each replayed call's
    output and parameters within `COMPILED_TOL` of each leaf's largest entry
    of the eager call's; the wrappers' counters of the warm-up and the
    capture equal to an eager call's and none in a replay; the halo
    exchange's collectives replayed bitwise. Prints each way's ms, busy,
    idle share, host launches and NCCL kernels a call (bf16), the port's
    kernels, the capture's seconds, pool and static inputs. Returns the
    launches from Python (for the `kernels` line) and the figures."""
    got = ranks[0]["compiled"]
    halo = got.pop("halo")
    print(f"[compiled mesh] the NCCL world of one (a 1x1 mesh) of phase 12; {card}")
    if not (halo["captured"] and halo["bitwise"]
            and halo["ran"] == ["warm-up", "capture", "replay"]):
        raise AssertionError(f"(15) the halo exchange's collectives: {halo}")
    print("  (15) the halo exchange (all_to_all_start / all_to_all_wait, all_to_all and its "
          "backward) through a sharded step: warm-up, capture, replay, bitwise equal to eager")
    total = {k: 0 for k in Counts().read()}
    out = {}
    want_ran = ["warm-up", "capture"] + ["replay"] * (COMPILED_MESH_CALLS - 2)
    for (name, dtype), r in got.items():
        what = f"(15) {name} {dtype[6:]}"
        if not r["captured"] or r["why_eager"] is not None:
            raise AssertionError(f"{what}: not captured on NCCL ({r['why_eager']})")
        if r["ran_eager"] != ["eager"] * COMPILED_MESH_CALLS or r["ran_replayed"] != want_ran:
            raise AssertionError(f"{what}: the calls ran as {r['ran_eager']} and "
                                 f"{r['ran_replayed']}")
        per_call = r["launches_eager"][0]
        none = dict.fromkeys(per_call, 0)
        if (not any(per_call.values())
                or r["launches_eager"] != [per_call] * COMPILED_MESH_CALLS
                or r["launches_replayed"] != [per_call] * 2 + [none] * (COMPILED_MESH_CALLS - 2)
                or r["recorded"] != per_call):
            raise AssertionError(f"{what}: the wrappers counted {r['launches_replayed']} "
                                 f"replayed, {r['launches_eager']} eagerly")
        for launches in r["launches_eager"] + r["launches_replayed"]:
            for k, v in launches.items():
                total[k] += v
        worst = max(r["output_gaps"] + r["param_gaps"])
        tol = COMPILED_TOL[torch.bfloat16 if "bfloat16" in dtype else torch.float32]
        print(f"  {what}: {COMPILED_MESH_CALLS} calls eager and {' / '.join(want_ran)}: largest "
              f"gap of an output {max(r['output_gaps']):.3e}"
              + (f", of a parameter or optimizer-state leaf {max(r['param_gaps']):.3e}"
                 if r["param_gaps"] else "")
              + f" of its largest entry (limit {tol:g}; eager against eager again "
              f"{r['control_gap']:.3e})"
              + ("; bitwise equal" if r["bitwise"] else "")
              + f"; launches a call from Python {({k: v for k, v in per_call.items() if v})}, "
              "as many in the warm-up and the capture, none in a replay")
        if not worst <= tol:
            raise AssertionError(f"{what}: a replayed call lies {worst:.3e} from the eager one")
        out[f"{name} {dtype[6:]}"] = dict(bitwise=r["bitwise"], worst_gap=worst,
                                          capture_s=r["capture_s"], pool_mib=r["pool_mib"],
                                          static_mib=r["static_mib"])
        if "eager" not in r:
            print(f"    the port's kernels a call by name, replayed as eager: "
                  f"{sum(r['port_kernels'].values()):.0f} launches of {len(r['port_kernels'])} "
                  f"kernels (torch.profiler); capture {r['capture_s']:.2f} s, graph pool "
                  f"{r['pool_mib']:.0f} MiB, static inputs {r['static_mib']:.1f} MiB; {card}")
            continue
        e, p = r["eager"], r["replayed"]
        print(f"    {e['ms']:.3f} ms eager -> {p['ms']:.3f} ms replayed (x{e['ms'] / p['ms']:.2f};"
              f" median of 20 after 3, CUDA events); device busy {e['busy_ms']:.3f} -> "
              f"{p['busy_ms']:.3f} ms, idle {e['idle_share']:.1%} -> {p['idle_share']:.1%}; "
              f"host launches a call: kernels {e['host_kernel_launches']:.0f} -> "
              f"{p['host_kernel_launches']:.0f}, graphs {e['host_graph_launches']:.0f} -> "
              f"{p['host_graph_launches']:.0f}, copies {e['host_copy_launches']:.0f} -> "
              f"{p['host_copy_launches']:.0f}; host-to-device copies {e['htod_ms']:.3f} -> "
              f"{p['htod_ms']:.3f} ms of the busy time (torch.profiler, 5 calls); the port's "
              "kernels a "
              f"call by name, replayed as eager: {sum(r['port_kernels'].values()):.0f} launches "
              f"of {len(r['port_kernels'])} kernels; NCCL kernels "
              f"{e['nccl_kernels'] or 'none'} -> {p['nccl_kernels'] or 'none'}; capture "
              f"{r['capture_s']:.2f} s, graph pool {r['pool_mib']:.0f} MiB, static inputs "
              f"{r['static_mib']:.1f} MiB; {card}")
        out[f"{name} {dtype[6:]}"].update(
            eager_ms=e["ms"], replayed_ms=p["ms"], eager_busy_ms=e["busy_ms"],
            replayed_busy_ms=p["busy_ms"], eager_idle=e["idle_share"],
            replayed_idle=p["idle_share"], host_kernel_launches=(
                e["host_kernel_launches"], p["host_kernel_launches"]),
            htod_ms=(e["htod_ms"], p["htod_ms"]),
            nccl_kernels=(e["nccl_kernels"], p["nccl_kernels"]))
    print("[compiled mesh] launch counts from Python: "
          + ", ".join(f"{k} {v}" for k, v in total.items()))
    return dict(launches=total, functions=out)


def phase15_alone() -> None:
    """Phase 15 without the other phases (the kernels built first): its NCCL
    world of one, which here steps no mesh of phase 12:
    `python3 -c "import chip_smoke as c; c.phase15_alone()"`."""
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    _build.library()
    t1 = time.perf_counter()
    ranks = spawn_parallel_world(1, "nccl", (), tempfile.mkdtemp(prefix="chip_smoke_mesh_"),
                                 job={"compiled": True})
    out = compiled_mesh(card, ranks)
    print(f"[time] build {t1 - t0:.1f} s, phase 15 {time.perf_counter() - t1:.1f} s")
    print(json.dumps({"launches": out["launches"], "card": card}))


# --------------------------------------------------------------------------
# phase 16: the rest of the JAX package's surface
# --------------------------------------------------------------------------

SURFACE_SEED = SEED + 16
# of each leaf's largest entry: the slot form's f32 gradients against the
# per-edge form's, both through the kernels, or, where more, the per-edge
# form's own f32 distance from its plain version in f64 (the control, read
# in the same run: the gradient's f32 resolution there)
SLOT_ATTN_GRAD_TOL = 1e-5
REMAT_STEPS = 3  # f32 steps with and without iteration remat
REMAT_PARAM_TOL = 1e-6


def mlp_attention_description(num_iterations: int = ITERATIONS, hs: int = HS) -> dict:
    """The mlp_message family with stage 2 aggregating by attention: its
    32-32 per-edge network into attention."""
    desc = mlp_message_description(num_iterations, hs)
    desc["message_passing"]["stages"][1]["stage_mp"][0]["aggregation"] = {"type": "attention"}
    return desc


def _only_step(trainer):
    """A fresh trainer's one captured step (`CapturedStep`)."""
    (step,) = trainer.graphs.captured.values()
    return step


def kernel_switches(card: str, counts, add) -> dict:
    """(b): the flagship bf16 step under 'auto' (warm-up, capture, replays),
    then under every switch at 'never' (`plain_on_card`: eagerly, and says
    why; no launch from Python and none of the port's kernels in a profile),
    then under 'auto' again: the graph captured before replays (no launch
    from Python; the port's kernels in its profile as before); then the
    fused-rnn switch alone at 'never' on the flagship step and the
    flash-attn switch alone on the attention family's, each captured and
    replayed without its kernels (`never_alone`)."""
    from ignnition_tpu_torch.batch import to_device

    ir, trainer, state, [(arrays, meta)] = _train_setup(flagship_description(), FLAGSHIP,
                                                        torch.bfloat16, SURFACE_SEED)
    batch = to_device(arrays, trainer.device)
    step = trainer.train_step_fn(meta)
    ran, losses = [], []
    for _ in range(3):
        counts.reset()
        state, m = step(state, batch)
        add(counts.read())
        ran.append(_only_step(trainer).last)
        losses.append(float(m["total"]))
    if ran != ["warm-up", "capture", "replay"]:
        raise AssertionError(f"(b) auto: the step ran {ran}")
    auto_ms = median_ms(lambda: step(state, batch))
    auto = profiled_calls(lambda: step(state, batch))
    with plain_on_card():
        counts.reset()
        state, m = step(state, batch)
        losses.append(float(m["total"]))
        captured, launched = _only_step(trainer), counts.read()
        if captured.last != "eager" or "IGNNITION_TPU_PALLAS" not in (captured.why_eager or ""):
            raise AssertionError(f"(b) never: the step ran {captured.last} "
                                 f"({captured.why_eager})")
        if any(launched.values()):
            raise AssertionError(f"(b) never: the wrappers launched {launched}")
        for _ in range(3):
            names = profiled_device_kernels(lambda: step(state, batch), 1)
            if names:
                break
        ours = sorted({n for n in names if any(k in n for k in ALL_PORT_KERNELS)})
        if ours or not names:
            raise AssertionError(f"(b) never: {len(names)} device kernels, the port's {ours}")
        never_ms = median_ms(lambda: step(state, batch), runs=5, warmup=1)
        why = captured.why_eager
    counts.reset()
    state, m = step(state, batch)
    losses.append(float(m["total"]))
    back, launched = _only_step(trainer).last, counts.read()
    replayed = port_kernels_by_name(profiled_device_kernels(lambda: step(state, batch), 1), 1)
    if back != "replay" or any(launched.values()) or set(replayed) != set(auto["port_kernels"]):
        raise AssertionError(f"(b) auto again: the step ran {back}, launched {launched} from "
                             f"Python, the port's kernels {replayed} against "
                             f"{auto['port_kernels']}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"(b) losses {losses}")
    print(f"[surface] (b) the flagship bf16 step: 'auto' replays at {auto_ms:.3f} ms (busy "
          f"{auto['busy_ms']:.3f} ms; {sum(auto['port_kernels'].values()):g} launches of the "
          f"port's kernels, {len(auto['port_kernels'])} of them by name); every switch "
          f"'never' runs eagerly ({why}) at {never_ms:.3f} ms with {len(names)} device kernels "
          f"and none of the port's (torch.profiler); 'auto' again replays the graph captured "
          f"before, no launch from Python; losses {[round(v, 5) for v in losses]}; on {card}")
    alone = {"fused-rnn": never_alone("the flagship", "fused-rnn", trainer, step, state, batch,
                                      card, counts, add)}
    ir, trainer, state, [(arrays, meta)] = _train_setup(attention_description(), FLAGSHIP,
                                                        torch.bfloat16, SURFACE_SEED)
    alone["flash-attn"] = never_alone("attention", "flash-attn", trainer,
                                      trainer.train_step_fn(meta), state,
                                      to_device(arrays, trainer.device), card, counts, add)
    return dict(auto_ms=auto_ms, auto_busy_ms=auto["busy_ms"], never_ms=never_ms,
                never_device_kernels=len(names), why_eager=why, never_alone=alone)


# kernel switch -> (its kernels' launch counters, parts of their device names)
SWITCH_KERNELS = {"fused-rnn": (("masked_gru_scan", "masked_gru_scan_bwd"),
                                ("masked_gru_scan", "gru_bwd_")),
                  "flash-attn": (("flash_gat_fwd", "flash_gat_bwd"),
                                 ("flash_gat_fwd", "flash_gat_bwd_"))}


def never_alone(what, switch, trainer, step, state, batch, card, counts, add) -> dict:
    """(b): the bf16 step of `trainer` with one kernel switch alone at
    'never', whose plain versions read nothing back to the host: a warm-up,
    a capture and a replay (a graph of its own: the switch is part of the
    key), none of the switch's kernels launched from Python or seen by the
    profiler in a replay, the other kernels of the port still there."""
    counters, parts = SWITCH_KERNELS[switch]
    ran, launched = [], {}
    with kernel_switch(switch, "never"):
        for _ in range(3):
            counts.reset()
            state, m = step(state, batch)
            got = counts.read()
            add(got)
            for k, v in got.items():
                launched[k] = launched.get(k, 0) + v
            ran.append(_only_step(trainer).last)
        captured = _only_step(trainer)
        ms = median_ms(lambda: step(state, batch))
        replayed = profiled_calls(lambda: step(state, batch))
    ours = replayed["port_kernels"]
    theirs = sorted(n for n in ours if any(p in n for p in parts))
    print(f"[surface] (b) {what} bf16 step, IGNNITION_TPU_{switch.upper().replace('-', '_')}="
          f"'never' alone: {ran} (why eager: {captured.why_eager}); replayed {ms:.3f} ms, busy "
          f"{replayed['busy_ms']:.3f} ms; the port's kernels in a replay {ours}; launched from "
          f"Python over the three calls {launched}; loss {float(m['total']):.5f}; on {card}")
    if (ran != ["warm-up", "capture", "replay"] or captured.why_eager is not None
            or any(launched[k] for k in counters) or theirs or not ours
            or not np.isfinite(float(m["total"]))):
        raise AssertionError(f"(b) {what}, {switch} 'never' alone: ran {ran}, launched "
                             f"{launched}, the switch's kernels {theirs} in a replay of {ours}")
    return dict(ran=ran, replayed_ms=ms, busy_ms=replayed["busy_ms"], port_kernels=ours)


def _attention_branch_taken(fn) -> tuple:
    """(calls of `GnnModel._slot_attention`, those that gave the slot form)
    while `fn()` runs."""
    from ignnition_tpu_torch.model.builder import GnnModel

    real, seen = GnnModel._slot_attention, [0, 0]

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        seen[0] += 1
        seen[1] += out is not None
        return out

    GnnModel._slot_attention = spy
    try:
        fn()
    finally:
        GnnModel._slot_attention = real
    return tuple(seen)


def slot_attention(card: str, counts, add) -> dict:
    """(c): slot-rate attention at two full-width sizes where the JAX
    package takes it (its gate on this batch: a slice map, slots under
    `SLOT_PAD_CAP` times the edges, and no incidence matrix for a message
    table): the attention family at x4 (8,192 links, 65,536 paths; past the
    dense cap) and the mlp_message family's 32-32 network into attention at
    the flagship size. Kernel A on this batch's slice-sort companions (the
    slot form's slice-gather backward, with its long row of invalid slots),
    exactly against its plain version (`check_slot_map_backward`). The
    step-0 f32 gradients of the slot form through the kernels against the
    per-edge form's, within `SLOT_ATTN_GRAD_TOL` of each leaf's largest entry
    or the per-edge form's own f32 distance from its plain f64, whichever is
    more (`kernel2`, whose gradient is f32 noise, of the step's largest
    gradient entry); each form's distance from the slot form's plain
    versions in f64, through the kernels and through the plain versions in
    f32, printed. At 2 iterations
    (`ITEM1_CHECK_ITERATIONS`: phases 7 and 8 hold f32 there, the mlp_message
    family amplifying f32 rounding at 8); then each form's bf16 step at 8
    iterations, captured and replayed: its time, device busy and kernel-A
    launches a step."""
    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.frontend import ir as t_ir
    from ignnition_tpu_torch.model.builder import flatten_params, map_params

    adj, out = "adj_paths_links", {}
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    for name, make_desc, size in (("attention x4", attention_description, FLAGSHIP_X4),
                                  ("mlp_message into attention", mlp_attention_description,
                                   FLAGSHIP)):
        rng = np.random.default_rng(SURFACE_SEED)
        sample = make_sample(rng, **size)
        res = {}
        for iterations in (ITEM1_CHECK_ITERATIONS, ITERATIONS):
            ir = igt.parse_model_description(make_desc(iterations), FEATURE_DIMS)
            arrays, meta = igt.build_batch([sample], ir, padding, training=True)
            slots, edges = meta.maxlen(adj) * meta.nodes("link"), meta.edges(adj)
            if (f"dense_inc_{adj}" in arrays or f"slice_src_{adj}" not in arrays
                    or slots > t_ir.SLOT_PAD_CAP * edges):
                raise AssertionError(f"(c) {name}: not the slot-rate gate's batch")
            params = igt.build(ir).init(torch.Generator().manual_seed(SURFACE_SEED))
            batch = to_device(arrays, "cuda")
            if iterations != ITERATIONS:
                # kernel A as this batch's slice-gather backward (the long row
                # of invalid slots), exactly against its plain version
                checked = check_slot_map_backward(torch.device("cuda"), rng, arrays, meta, adj,
                                                  "path", HS, tag=f"[surface] (c) {name}:")
                res["slot_map_backward"] = {str(k)[6:]: v for k, v in checked.items()}
                grads, kernel_a = {}, {}
                for form, on in (("slot", True), ("per-edge", False)):
                    with builder_switch("_SLOT_ATTN", on):
                        tr = igt.Trainer(igt.build(ir), padding, compute_dtype=None)
                        st = tr.init_state(params=map_params(lambda v: v.clone(), params))
                        counts.reset()
                        taken = _attention_branch_taken(
                            lambda: grads.__setitem__(form, tr.grads_fn(meta)(st.params, batch)))
                        seen = counts.read()
                        add(seen)
                        kernel_a[form] = (seen["csr_segment_sum"], seen["csr_segment_sum_windows"])
                    if taken != ((iterations, iterations) if on else (0, 0)):
                        raise AssertionError(f"(c) {name} {form}: `_slot_attention` {taken}")
                if not sum(kernel_a["slot"]):
                    raise AssertionError(f"(c) {name}: the slot form launched no kernel A")
                # the plain versions on the card (kernel A's windowed
                # backward among them): the slot form in f32 and in f64, and
                # the per-edge form in f64
                plain = {}
                for form, on, dtype in (("slot f32", True, None), ("slot f64", True, torch.float64),
                                        ("per-edge f64", False, torch.float64)):
                    with builder_switch("_SLOT_ATTN", on), plain_on_card():
                        tr = igt.Trainer(igt.build(ir), padding, compute_dtype=dtype)
                        st = tr.init_state(params=map_params(lambda v: v.clone(), params))
                        plain[form] = flatten_params(tr.grads_fn(meta)(st.params, batch)[0])
                got, edge = (flatten_params(grads[f][0]) for f in ("slot", "per-edge"))
                exact = plain["slot f64"]
                # `kernel2` reaches the loss only where a destination's scores
                # change sign (a shift per destination leaves its softmax
                # unchanged): its gradient is f32 noise in every form, held
                # to the tolerance of the step's largest gradient entry
                noise = "aggregation/s1/m0/kernel2"
                firm = lambda t: {k: v for k, v in t.items() if k != noise}
                scale = max(float(v.abs().max()) for v in exact.values())
                gaps = leaf_gaps(firm(got), firm(exact))
                own = leaf_gaps(firm(plain["slot f32"]), firm(exact))
                control = leaf_gaps(firm(edge), firm(plain["per-edge f64"]))
                between = leaf_gaps(firm(got), firm(edge))
                limits = {k: max(SLOT_ATTN_GRAD_TOL, control[k]) for k in between}
                noise_gap = float((got[noise] - edge[noise]).abs().max()) / scale
                worst = max(between, key=lambda k: between[k] / limits[k])
                far = max(gaps, key=gaps.get)
                past = {k: (between[k], control[k]) for k in between
                        if between[k] > SLOT_ATTN_GRAD_TOL}
                res.update(f32_worst_leaf=worst, f32_worst_gap=between[worst],
                           f32_worst_control=control[worst], f32_past_tol=past,
                           f32_kernel2_gap_of_step_scale=noise_gap,
                           f32_from_plain_f64=(far, gaps[far], own[far]))
                print(f"[surface] (c) {name}: {slots} slots for {edges} edges "
                      f"({slots / edges:.2f}x, under {t_ir.SLOT_PAD_CAP}x), no incidence matrix: "
                      f"the JAX gate's slot-rate attention; step-0 f32 gradients at {iterations} "
                      f"iterations through the kernels (kernel A (whole, windowed) "
                      f"{kernel_a['slot']} in the slot form's step), of each leaf's largest "
                      f"entry: slot against per-edge worst {worst} {between[worst]:.3e} (the "
                      f"per-edge form's own from its plain f64 {control[worst]:.3e}); past "
                      f"{SLOT_ATTN_GRAD_TOL:g}: "
                      + (", ".join(f"{k} {g:.3e} (control {c:.3e})" for k, (g, c) in past.items())
                         or "none")
                      + f"; {noise} {noise_gap:.3e} of the step's largest gradient entry "
                      f"{scale:.3e}. From the slot form's plain f64: worst {far} {gaps[far]:.3e} "
                      f"through the kernels, {own[far]:.3e} through the plain versions in f32. "
                      f"Held: slot against per-edge within {SLOT_ATTN_GRAD_TOL:g} or the control")
                if any(between[k] > limits[k] for k in between) or noise_gap > SLOT_ATTN_GRAD_TOL:
                    raise AssertionError(f"(c) {name}: gradients {between} against {limits}, "
                                         f"{noise} {noise_gap}")
                continue
            for form, on in (("slot", True), ("per-edge", False)):
                with builder_switch("_SLOT_ATTN", on):
                    tr = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
                    st = tr.init_state(params=map_params(lambda v: v.clone(), params))
                    step = tr.train_step_fn(meta)
                    for _ in range(2):
                        counts.reset()
                        st, m = step(st, batch)
                        add(counts.read())
                    counts.reset()
                    st, m = step(st, batch)
                    held = counts.held()
                    ms = median_ms(lambda: step(st, batch))
                    prof = print_profile(f"(c) {name}, {form} form, bf16 step",
                                         lambda: step(st, batch), ms)
                    ran = _only_step(tr).last
                a = held["csr_segment_sum"]
                res[form] = dict(replayed_ms=ms, busy_ms=prof.get("device_busy_ms"), kernel_a=a,
                                 windowed=held["csr_segment_sum_windows"], ran=ran,
                                 loss=float(m["total"]))
                print(f"[surface] (c) {name}, {form} form, bf16 step at {ITERATIONS} "
                      f"iterations ({ran}): {ms:.3f} ms, busy {res[form]['busy_ms']} ms, kernel A "
                      f"{a} a step ({held['csr_segment_sum_windows']} windowed), B "
                      f"{held['masked_gru_scan']}, C {held['masked_gru_scan_bwd']}, loss "
                      f"{float(m['total']):.5f}; on {card}")
                if ran != "replay" or not np.isfinite(res[form]["loss"]):
                    raise AssertionError(f"(c) {name} {form}: {ran}, loss {res[form]['loss']}")
        out[name] = res
    return out


def remat_at_x8(card: str, counts, add) -> dict:
    """(d): flagship_x8's bf16 step with and without `_ITER_REMAT`, each from
    a fresh trainer captured and replayed: peak MiB above what was
    allocated before (the warm-up, the capture and a replay), the capture's
    pool, the replayed time, the kernels a step; then `REMAT_STEPS` f32
    steps of each from the same parameters, the parameters held within
    `REMAT_PARAM_TOL`."""
    import gc

    import ignnition_tpu_torch as igt
    from ignnition_tpu_torch.batch import to_device
    from ignnition_tpu_torch.model.builder import flatten_params, map_params

    size = ITEM1_SIZES["flagship_x8"][0]
    ir, _, _, [(arrays, meta)] = _train_setup(flagship_description(), size, torch.bfloat16,
                                              SURFACE_SEED)
    padding = igt.PaddingConfig(mode="multiple", multiple=256, min_size=256)
    params = igt.build(ir).init(torch.Generator().manual_seed(SURFACE_SEED))
    batch = to_device(arrays, "cuda")
    out, final = {}, {}
    for remat in ("never", "always"):
        with builder_switch("_ITER_REMAT", remat):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tr = igt.Trainer(igt.build(ir), padding, compute_dtype=torch.bfloat16)
            st = tr.init_state(params=map_params(lambda v: v.clone(), params))
            step = tr.train_step_fn(meta)
            for _ in range(2):
                counts.reset()
                st, m = step(st, batch)
                add(counts.read())
            counts.reset()
            st, m = step(st, batch)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            held = counts.held()
            captured = _only_step(tr)
            ms = median_ms(lambda: step(st, batch))
            out[remat] = dict(peak_mib=peak, pool_mib=captured.pool_bytes / 2**20, step_ms=ms,
                              launches=held, ran=captured.last, loss=float(m["total"]))
            print(f"[surface] (d) flagship_x8 bf16 step, IGNNITION_TPU_ITER_REMAT={remat} "
                  f"({captured.last}): peak {peak:.1f} MiB above the {base / 2**20:.1f} MiB "
                  f"before it (pool {captured.pool_bytes / 2**20:.1f} MiB), {ms:.3f} ms "
                  f"replayed; B {held['masked_gru_scan']}, C {held['masked_gru_scan_bwd']}, A "
                  f"{held['csr_segment_sum']} a step; loss {float(m['total']):.5f}; on {card}")
            if captured.last != "replay" or not np.isfinite(out[remat]["loss"]):
                raise AssertionError(f"(d) remat {remat}: {captured.last}, {out[remat]}")
            del tr, st, step
            f32 = igt.Trainer(igt.build(ir), padding, compute_dtype=None)
            st = f32.init_state(params=map_params(lambda v: v.clone(), params))
            step = f32.train_step_fn(meta)
            for _ in range(REMAT_STEPS):
                st, m = step(st, batch)
            final[remat] = {k: v.detach().double().cpu() for k, v in
                            flatten_params(st.params).items()}
            del f32, st, step
    gap = max(float((final["always"][k] - v).abs().max()) for k, v in final["never"].items())
    print(f"[surface] (d) f32 parameters after {REMAT_STEPS} steps (warm-up, capture, replay), "
          f"with remat against without: largest gap {gap:.3e} (held within {REMAT_PARAM_TOL:g}); "
          f"peak {out['always']['peak_mib']:.1f} MiB against {out['never']['peak_mib']:.1f} MiB "
          f"({out['always']['peak_mib'] / out['never']['peak_mib']:.3f}x), step "
          f"{out['always']['step_ms'] / out['never']['step_ms']:.3f}x the time")
    if gap > REMAT_PARAM_TOL:
        raise AssertionError(f"(d) remat: f32 parameters {gap:.3e} apart")
    return dict(out, f32_param_gap=gap)


def rest_of_surface(dev, card: str, memory: dict) -> dict:
    """Phase 16: the rest of the JAX package's surface. (a) `plain_on_card`
    (phase 10) goes through the kernel switches; (b) `kernel_switches`; (c)
    `slot_attention`; (d) `remat_at_x8`; (e) phase 12 (b)'s memory hold,
    read in a fresh process, within `MEMORY_RATIO` at every size."""
    counts = Counts()
    total = {k: 0 for k in counts.read()}

    def add(got):
        for k, v in got.items():
            total[k] += v

    out = dict(switches=kernel_switches(card, counts, add),
               slot_attention=slot_attention(card, counts, add),
               remat=remat_at_x8(card, counts, add))
    ratios = {k: v["ratio"] for k, v in memory.items() if k != "usable_fraction"}
    print(f"[surface] (e) the memory estimate over the first captured step's peak in a fresh "
          f"process (phase 12 (b)): " + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
          + f", each within {MEMORY_RATIO}")
    if not all(MEMORY_RATIO[0] <= v <= MEMORY_RATIO[1] for v in ratios.values()):
        raise AssertionError(f"(e) memory ratios {ratios}")
    out["memory_ratios"] = ratios
    return dict(launches=total, **out)


def phase16_alone() -> None:
    """Phase 16 without the other phases (the kernels built first; (e) reads
    the memory hold's process itself):
    `python3 -c "import chip_smoke as c; c.phase16_alone()"`."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    _build.library()
    t1 = time.perf_counter()
    out = rest_of_surface(torch.device("cuda", 0), card, memory_model(card))
    print(f"[time] build {t1 - t0:.1f} s, phase 16 {time.perf_counter() - t1:.1f} s")
    print(json.dumps({"launches": out["launches"], "card": card}))


def ptxas_entries(log: str) -> list:
    """(kernel name past the file's prefix, "N registers, ...", spill line)
    for each kernel that `-Xptxas=-v` reported on."""
    name = "?"
    spill = ""
    out = []
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            found = re.search(r"_cu_[0-9a-f]{8}\d+(.*)", name)  # past the file's prefix
            name = found.group(1) if found else name
        elif "spill" in line:
            spill = line
        elif "registers" in line:
            out.append((name, line.split("Used", 1)[-1].strip(), spill))
            spill = ""
    return out


def print_ptxas(log: str) -> None:
    """One line per kernel of what `-Xptxas=-v` reported: its (mangled) name,
    registers and spills."""
    for name, used, spill in ptxas_entries(log):
        print(f"  ptxas: {name[:56]}: {used}; {spill}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ignnition_tpu_torch.data import native_loader
    from ignnition_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 1: card and build ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s)"
          f" -> {_build.library_path().name}")
    print_ptxas(_build.build_log)
    t0 = time.perf_counter()
    if not native_loader.available():
        raise AssertionError("the native batch helpers did not load")
    lib = os.path.realpath(native_loader.library_path())
    want_dir = os.path.realpath(_build.BUILD_DIR)
    if os.path.dirname(lib) != want_dir:
        raise AssertionError(f"the native batch helpers load from {lib}, not {want_dir}")
    print(f"[build] native batch helpers (g++) built and loaded in "
          f"{time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib)}")

    # ---- phase 2: kernels against their plain versions ----
    seconds = {"build": time.perf_counter() - t_start}
    rng = np.random.default_rng(SEED)
    e_slices = FLAGSHIP["n_paths"] * FLAGSHIP["path_len"]
    print(f"[kernels] at the main paths' shapes on {card}")
    x4_links, links = FLAGSHIP_X4["n_links"], FLAGSHIP["n_links"]
    seg = check_segment_sums(dev, rng, "stage 2 forward at x4", 524_288, x4_links, HS,
                             timed=True)
    seg_bwd = check_segment_sums(dev, rng, "slice-gather backward", e_slices, links, HS,
                                 gathered=True, timed=True)
    # per-edge attention at x4: the softmax denominator is [E, 8] -> [N, 8]
    seg_w8 = check_segment_sums(dev, rng, "attention x4 denominator", 524_288, x4_links, 8,
                                timed=True)
    seg_w48 = check_segment_sums(dev, rng, "a width off 128", e_slices, links, 48, timed=True)
    # graph pooling: 1,024 graphs of 128 rows (phase 8 holds the kernels at
    # its batches' own shapes)
    seg_pool = check_segment_sums(dev, rng, "graph pooling", 131_072, HOMOGENEOUS_GRAPHS, HS,
                                  kind="even", timed=True)
    for d in (8, 20, 128, 256):
        check_segment_sums(dev, rng, f"width {d}", e_slices, links, d)
    check_segment_sums(dev, rng, "a quarter of the edges in one row", e_slices, links, HS,
                       kind="skewed")
    check_segment_sums(dev, rng, "every edge in one row", e_slices, links, HS,
                       kind="one_of_many")
    check_segment_sums(dev, rng, "a single row", e_slices, 1, HS, kind="even")
    check_segment_sums(dev, rng, "one row of 2 edges", 2, 1, HS, kind="even")
    check_segment_sums(dev, rng, "65,536 rows of 2 edges", e_slices, 65_536, HS, kind="even")
    seg_win = check_segment_sum_windows(dev, rng, FLAGSHIP_X4["n_paths"],
                                        FLAGSHIP_X4["path_len"], x4_links)
    check_ids_call_is_one_launch(dev, rng)
    gru = check_gru_scan(dev, rng)
    gru_bwd = check_gru_scan_bwd(dev, rng)
    gat = check_attention_kernels(dev, rng)

    seconds["kernels"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 3: serving ----
    served = serve(dev, card)
    seconds["serving"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 4: training ----
    trained = train(dev, card)
    seconds["training"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 5: the attention family ----
    attended = attention(dev, card)
    seconds["attention"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 6: the Q-size model ----
    qsized = qsize(dev, card)
    seconds["qsize"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 7: the mlp_message family ----
    mlped = mlp_message(dev, card)
    seconds["mlp_message"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 8: graphprop and linkpred; the blocks_g4 and x8 sizes ----
    homog = homogeneous(dev, card)
    seconds["homogeneous"] = time.perf_counter() - t_start - sum(seconds.values())
    at_batch = homog.pop("kernels_at_batch_shapes")
    homog_served = homog.pop("served")
    homog_samples = homog.pop("samples")
    item1 = item1_sizes(dev, card)
    at_x8 = item1["flagship_x8"].pop("kernels_at_its_shapes")
    seconds["blocks_g4 and x8"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 9: the entry points ----
    api = entry_points(dev, card, trained["steps"]["flagship"]["step_ms"])
    seconds["entry points"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 10: the description language ----
    language = description_language(dev, card)
    seconds["description language"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 11: serving artifacts and the debug verb ----
    artifacts = serving_artifacts(dev, card, homog_served)
    served_models = artifacts.pop("models")
    seconds["serving artifacts"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 12: the roofline, the memory model and the sharded step ----
    meshed = roofline_memory_parallel(dev, card, seg, gru, gru_bwd, gat)
    seconds["roofline, memory, mesh"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 13: destination sharding ----
    dest = destshard_steps(card)
    seconds["dest_shard"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 14: the compiled steps against the eager ones ----
    compiled = compiled_steps(dev, card, homog_samples, served_models, api["pipeline"])
    seconds["compiled steps"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 15: the compiled sharded steps (run in phase 12's NCCL world) ----
    compiled_meshed = compiled_mesh(card, meshed["parallel"].pop("compiled_ranks"))
    seconds["compiled sharded steps"] = time.perf_counter() - t_start - sum(seconds.values())

    # ---- phase 16: the rest of the JAX package's surface ----
    surface = rest_of_surface(dev, card, meshed["memory"])
    seconds["rest of the surface"] = time.perf_counter() - t_start - sum(seconds.values())
    print("[time] seconds by phase (host clock): "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; {sum(seconds.values()):.1f} in all")

    bf16 = torch.bfloat16
    csrc = "ignnition_tpu_torch/csrc/"
    pallas = "ignnition_tpu/ops/pallas/"
    sources = {
        "csr_segment_sum": (csrc + "segment_sum.cu", pallas + "segment_kernels.py:337",
                            seg["csr"]),
        "csr_segment_sum_windows": (csrc + "segment_sum.cu",
                                    pallas + "segment_kernels.py:337", seg_win),
        "segment_sum_ids": (csrc + "segment_sum.cu", pallas + "segment_kernels.py:150",
                            seg_w48["ids"]),
        "masked_gru_scan": (csrc + "gru_scan.cu", pallas + "rnn_kernels.py:260", gru),
        "masked_gru_scan_bwd": (csrc + "gru_scan_bwd.cu", pallas + "rnn_kernels.py:279",
                                gru_bwd),
        "flash_gat_fwd": (csrc + "flash_gat.cu", pallas + "attention_kernels.py:136",
                          gat["fwd"]),
        "flash_gat_bwd": (csrc + "flash_gat.cu", pallas + "attention_kernels.py:212",
                          gat["bwd"]),
    }
    kernels = []
    for name, (source, replaces, checked) in sources.items():
        on_serving = served["launches"].get(name, 0)
        on_training = trained["launches"].get(name, 0)
        on_attention = attended["launches"][name]
        on_qsize = qsized["launches"][name]
        on_mlp = mlped["launches"][name]
        on_homogeneous = homog["launches"][name]
        on_item1 = item1["launches"][name]
        on_api = api["launches"][name]
        on_language = language["launches"][name]
        on_export = artifacts["launches"][name]
        on_parallel = meshed["parallel"]["launches"][name]
        on_dest = dest["launches"][name]
        on_compiled = compiled["launches"][name]
        on_compiled_mesh = compiled_meshed["launches"][name]
        on_surface = surface["launches"][name]
        launches = (on_serving + on_training + on_attention + on_qsize + on_mlp
                    + on_homogeneous + on_item1 + on_api + on_language + on_export
                    + on_parallel + on_dest + on_compiled + on_compiled_mesh + on_surface)
        if launches == 0:
            raise AssertionError(f"kernel {name} was launched on no main path")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=launches,
            launches_serving=on_serving, launches_training=on_training,
            launches_attention=on_attention, launches_qsize=on_qsize,
            launches_mlp_message=on_mlp, launches_homogeneous=on_homogeneous,
            launches_blocks_g4_and_x8=on_item1, launches_api=on_api,
            launches_description_language=on_language,
            launches_serving_export=on_export, launches_parallel=on_parallel,
            launches_dest_shard=on_dest, launches_compiled_steps=on_compiled,
            launches_compiled_sharded_steps=on_compiled_mesh,
            launches_rest_of_the_surface=on_surface,
            **checked[bf16], f32=checked[torch.float32],
        ))
    by_name = {k["name"]: k for k in kernels}
    both = lambda checked: dict(bf16=checked[bf16], f32=checked[torch.float32])
    by_name["csr_segment_sum"].update(
        at_slice_gather_backward_shape=both(seg_bwd["csr"]), at_width_8=both(seg_w8["csr"]),
        at_width_48=both(seg_w48["csr"]))
    by_name["csr_segment_sum_windows"].update(
        at_mlp_message_slot_map=both(mlped["slot_map_backward"]),
        **{f"at_slot_attention_{k.replace(' ', '_')}": v["slot_map_backward"]
           for k, v in surface["slot_attention"].items()})
    by_name["segment_sum_ids"].update(
        at_width_32=both(seg_bwd["ids"]), at_x4_shape=both(seg["ids"]),
        at_width_8=both(seg_w8["ids"]), at_pooling_shape=both(seg_pool["ids"]),
        at_graphprop_csr_mean_pooling=both(at_batch["graphprop CSR"]["pooling"]["ids"]),
        at_graphprop_blocks_mean_pooling=both(at_batch["graphprop blocks"]["pooling"]["ids"]))
    by_name["csr_segment_sum"].update(
        at_graphprop_csr=both(at_batch["graphprop CSR"]["csr"]["csr"]),
        at_linkpred=both(at_batch["linkpred"]["csr"]["csr"]))
    for k, which in ((by_name["flash_gat_fwd"], "fwd"), (by_name["flash_gat_bwd"], "bwd")):
        k["over_4_graph_blocks"] = gat["blocks"][which][bf16]
        k["at_small_graph"] = gat["small"][which][bf16]
        k["at_graphprop_blocks"] = both(at_batch["graphprop blocks"]["blocks"][which])
    for name, checked in at_x8.items():
        by_name[name]["at_x8_shape"] = both(checked)
    print(json.dumps({"kernels": kernels, "latency": served["latency"],
                      "training": trained["steps"],
                      "attention": {k: v for k, v in attended.items() if k != "launches"},
                      "qsize": {k: v for k, v in qsized.items() if k != "launches"},
                      "mlp_message": {k: v for k, v in mlped.items()
                                      if k not in ("launches", "slot_map_backward")},
                      "homogeneous": {k: v for k, v in homog.items() if k != "launches"},
                      "blocks_g4_and_x8": {k: v for k, v in item1.items() if k != "launches"},
                      "api": {k: v for k, v in api.items() if k != "launches"},
                      "description_language": {k: v for k, v in language.items()
                                               if k != "launches"},
                      "serving_artifacts": {k: v for k, v in artifacts.items()
                                            if k != "launches"},
                      "roofline_memory_mesh": {
                          "floors": meshed["floors"]["measured"],
                          "floors_held": meshed["floors"]["held"],
                          "gather_library_ns": meshed["floors"]["gather_library_ns"],
                          "roofline": {k: {over: {f: r[f] for f in (
                              "measured_ms", "sol_ms", "sol_pct", "apsol_ms", "apsol_pct")}
                              for over, r in v["roofline"].items()}
                              for k, v in meshed["roofline"].items()},
                          "memory": {k: {"estimate_mib": v["estimate_bytes"]["total_bytes"]
                                         / 2**20, "measured_mib": v["measured_bytes"] / 2**20,
                                         "ratio": v["ratio"]}
                                     for k, v in meshed["memory"].items()
                                     if k != "usable_fraction"},
                          "usable_fraction": meshed["memory"]["usable_fraction"],
                          "parallel": {k: {f: v[f] for f in ("losses", "step_ms",
                                                            "allreduce_share")}
                                       for k, v in meshed["parallel"]["meshes"].items()}},
                      "dest_shard": dest["meshes"],
                      "compiled_steps": {k: v for k, v in compiled.items() if k != "launches"},
                      "compiled_sharded_steps": compiled_meshed["functions"],
                      "rest_of_the_surface": {k: v for k, v in surface.items()
                                              if k != "launches"},
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(*sys.argv[2:7])
    elif sys.argv[1:2] == ["--destshard-rank"]:
        destshard_rank(*sys.argv[2:7])
    elif sys.argv[1:2] == ["--memory-model"]:
        memory_model_process(sys.argv[2])
    else:
        main()
