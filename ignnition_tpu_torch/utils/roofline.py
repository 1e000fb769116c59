"""Speed-of-light accounting for a training step (counterpart of
`ignnition_tpu/utils/roofline.py`, whose `StepCost`, `train_step_cost` and
`roofline_report` this module copies: the port's lowerings follow the same
data-layer thresholds, so the itemization still applies). The hardware
changes: `HardwareSpec` describes an NVIDIA H100 80GB HBM3, its floors
measured on the card; and a step of 4-byte values has its FLOPs charged at
the card's f32 peak, where the JAX package charges every FLOP at bf16's.

Computes, from the IR + a BatchMeta, an itemized lower bound on the
MANDATORY work of one full training step (forward + backward + optimizer):

  * HBM bytes — every value stream an implementation must move at least
    once, under an OPTIMISTIC fusion convention (anything that fits on chip
    is assumed resident; node-rate tables count once per iteration;
    edge-rate streams count once per direction of AD):
      - aggregation input: the per-edge message stream E*D when the message
        is genuinely per-edge, or for SEQUENCE (ordered/interleave)
        aggregations whose RNN consumes per-slot inputs; node tables
        (n*D) when a source-local message feeds a commutative aggregation
        (sum/attention/convolution/concat) that can stream from the table;
      - index companions: E * 4 bytes, read in forward and backward;
      - updated state tables: n_d*D written fwd, cotangent read bwd;
      - per-edge MLP activations: E*units per interior layer boundary
        (1x fwd + 2x bwd: residual read + cotangent);
      - readout activations at domain row rate;
      - optimizer: ~20 bytes/param (p/m/v read+write, grad read).
  * FLOPs — 2*rows*in*out per Dense matmul, 12*D^2 per GRU element
    (16*D^2 LSTM), x3 for training (backward of a matmul is ~2x forward);
    aggregation adds E*D. Charged at the bf16 tensor-core peak, or at the
    f32 peak for a step of 4-byte values (the port's f32 matmuls run
    without TF32).
  * gather rows (INFORMATIONAL, not part of the bound) — rows moved through
    data-dependent indices per step, charged at the byte bound of a 64-byte
    row gather (`HardwareSpec.gather_ns_per_row`): no library gather comes
    within 2x of it on the card, so the bound, not their time, is the floor.
  * rnn scan floor — scanned (sequence) recurrent updates are charged a
    CALIBRATED per-scan cost (`HardwareSpec.rnn_scan_ps_per_elem` /
    `rnn_scan_us_per_step`: kernels B and C, forward and backward) instead
    of the FLOPs+seq_stream items. Additive in apsol: the scan is a strict
    data dependence behind the same iteration's gathers.
  * the sorted segment sums and the dense attention softmax likewise carry
    their kernels' measured per-row and per-entry costs (kernel A; kernels
    D and E).

The bound is deliberately UNACHIEVABLE-optimistic (perfect fusion, zero
re-materialization, no padding): achieved % of it is a conservative
statement of headroom. Padded sizes from BatchMeta are used as stand-ins
for real sizes.

Each floor is the best achievable cost on the card, the JAX package's
convention: the minimum over the shapes measured, from graph-replay device
times of `chip_smoke.py`'s phase 2 timers (phase 12 prints them again from
its own run beside these constants). The row gather is the exception: its
floor is its byte bound, since the library's gathers run ~15x slower.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict

# the H100 floors (see HardwareSpec), each the minimum over the shapes
# measured, from graph-replay device times in bf16 on NVIDIA H100 80GB HBM3,
# 700.00 W (nvidia-smi's name and power limit) by
# `python3 -c "import chip_smoke as c; c.phase12_alone()"` (PERF.md §6 names
# the run)
# the row gather's byte bound: a 64-byte row read, the row written and its
# int64 index read (136 bytes) at 3.35 TB/s. The library's gathers take
# 0.6065 ns a row at best (torch.index_select [8192,32] x 524288), ~15x the
# bound: none comes within 2x of it, so the bound is the floor and the
# library's time is what the gathers take
GATHER_NS = 136 / 3350.0  # 0.04060 ns a row
DENSE_ATTN_PS = 0.6613  # kernels D + E at [2048, 16384]: 0.0443 ms a pass pair
RNN_PS = 50.95  # kernels B + C: 0.8547 ms at [8,65536,32] (61.67 ps at [8,16384,32])
RNN_US = 32.32  # kernels B + C: 0.2586 ms at [8,16384,32] (106.8 us at [8,65536,32])
SEGSUM_NS = 0.02444  # kernel A: 0.01281 ms at [524288,32] -> [8192,32]


@dataclass
class HardwareSpec:
    """NVIDIA H100 80GB HBM3 (SXM) defaults; override via env for another
    card. The peaks are the card's stated figures (PERF.md §6): HBM
    3.35 TB/s, 989 TFLOP/s bf16 dense on the tensor cores, 67 TFLOP/s f32.
    The floors were measured on NVIDIA H100 80GB HBM3, 700.00 W (as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them), graph replay in bf16, by chip_smoke.py's phase-2 timers (the
    constants above: shapes and times beside each)."""

    name: str = "H100"
    hbm_gbps: float = float(os.environ.get("IGNNITION_TPU_HBM_GBPS", 3350.0))
    # the tensor-core peaks: the FLOP items of a 2-byte step are charged at
    # the bf16 one, those of a 4-byte step at the f32 one
    mxu_tflops_bf16: float = float(
        os.environ.get("IGNNITION_TPU_MXU_TFLOPS", 989.0)
    )
    tflops_f32: float = 67.0
    # a 64-byte row gather's byte bound (GATHER_NS) — informational
    gather_ns_per_row: float = float(
        os.environ.get("IGNNITION_TPU_GATHER_NS", GATHER_NS)
    )
    # kernels D + E (one forward, one backward pass) over the int8
    # incidence [2048, 16384], D=32, bf16: (D + E) / (2 * entries)
    dense_attn_ps_per_entry: float = float(
        os.environ.get("IGNNITION_TPU_DENSE_ATTN_PS", DENSE_ATTN_PS)
    )
    # kernels B + C (the masked GRU scan, forward and backward) at
    # [8, 16384, 32] and [8, 65536, 32] u=32, bf16, full lengths: per
    # element (B + C) / (L * N * D), per step (B + C) / L; each the
    # minimum over the two shapes
    rnn_scan_ps_per_elem: float = float(
        os.environ.get("IGNNITION_TPU_RNN_SCAN_PS", RNN_PS)
    )
    rnn_scan_us_per_step: float = float(
        os.environ.get("IGNNITION_TPU_RNN_SCAN_US", RNN_US)
    )
    # kernel A (the CSR segment sum) at [524288, 32] -> [8192, 32], bf16 in,
    # f32 out: time / rows
    segsum_ns_per_row: float = float(
        os.environ.get("IGNNITION_TPU_SEGSUM_NS", SEGSUM_NS)
    )


@dataclass
class StepCost:
    bytes_by: Dict[str, float] = field(default_factory=dict)
    flops_by: Dict[str, float] = field(default_factory=dict)
    gather_rows: float = 0.0
    # [n_dst, n_src]-entry passes of the dense attention lowering (2 per
    # iteration: one forward, one backward recompute) — charged at the
    # calibrated HardwareSpec.dense_attn_ps_per_entry
    dense_attn_entry_passes: float = 0.0
    # masked recurrent time scans: (steps_per_iter, elems_per_iter, width,
    # iters, gate_scale) per scanned update — charged per iteration at
    # max(steps * us_per_step, elems * width * ps_per_elem) with the
    # calibrated HardwareSpec constants (gate_scale 1.0 GRU, 4/3 LSTM)
    rnn_scans: list = field(default_factory=list)
    # rows through sorted segmented reductions (one per non-dense adjacency
    # per iteration), charged at HardwareSpec.segsum_ns_per_row — part of
    # the access-pattern floor alongside gather_rows
    segsum_rows: float = 0.0

    def add_bytes(self, item: str, n: float):
        self.bytes_by[item] = self.bytes_by.get(item, 0.0) + float(n)

    def add_flops(self, item: str, n: float):
        self.flops_by[item] = self.flops_by.get(item, 0.0) + float(n)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by.values())

    @property
    def total_flops(self) -> float:
        return sum(self.flops_by.values())

    def bound_seconds(self, hw: HardwareSpec,
                      dtype_bytes: int = 2) -> Dict[str, float]:
        t_bytes = self.total_bytes / (hw.hbm_gbps * 1e9)
        peak = hw.mxu_tflops_bf16 if dtype_bytes <= 2 else hw.tflops_f32
        t_flops = self.total_flops / (peak * 1e12)
        return {
            "t_bytes_ms": t_bytes * 1e3,
            "t_flops_ms": t_flops * 1e3,
            "sol_ms": max(t_bytes, t_flops) * 1e3,
            "binding": "bytes" if t_bytes >= t_flops else "flops",
            "gather_floor_ms_informational": (
                self.gather_rows * hw.gather_ns_per_row * 1e-9 * 1e3
            ),
        }


def _mlp_dims(mlp, in_dim, last_units=None):
    """[(in, out)] per Dense layer of an MLPSpec (point-wise kinds keep
    width). last_units overrides the LAST Dense layer, matching nn/mlp.py's
    actual parameter shapes."""
    dims = []
    d = in_dim
    layers = mlp.layers
    last_dense = max(
        (j for j, l in enumerate(layers) if l.kind == "Dense"), default=None
    )
    for j, l in enumerate(layers):
        if l.kind == "Dense":
            u = l.units
            if j == last_dense and last_units is not None:
                u = last_units
            dims.append((d, int(u)))
            d = int(u)
    return dims, d


def _param_count(model_ir) -> float:
    """Rough trainable-parameter count (Dense kernels + RNN cells)."""
    state = model_ir.state_dims()
    total = 0.0
    for stage in model_ir.stages:
        for mp in stage.passes:
            d = state[mp.destination]
            msg_dim = 0
            for src in mp.sources:
                in_dim = state[src.entity]
                cur = in_dim
                for op in src.ops:
                    if op.kind == "mlp":
                        dims, cur = _mlp_dims(op.mlp, cur)
                        total += sum(i * o + o for i, o in dims)
                msg_dim = max(msg_dim, cur)
            if mp.update.kind == "recurrent":
                g = 3 if mp.update.rnn.cell_type == "GRU" else 4
                total += g * d * (msg_dim + d + 2)
            else:
                dims, _ = _mlp_dims(mp.update.mlp, msg_dim + d, last_units=d)
                total += sum(i * o + o for i, o in dims)
    for op in model_ir.readout:
        if getattr(op, "mlp", None) is not None:
            in_dim = sum(state.get(x, state.get(model_ir.entity_names[0], 32))
                         for x in op.inputs)
            dims, _ = _mlp_dims(op.mlp, in_dim)
            total += sum(i * o + o for i, o in dims)
    return total


def train_step_cost(model_ir, meta, dtype_bytes: int = 2) -> StepCost:
    """Itemized mandatory bytes/FLOPs of one training step (conventions in
    the module docstring)."""
    from ..data.graph import (
        _DENSE_INC_MAX_ENTRIES, _DENSE_INC_MIN_EDGES, dense_agg_adjacencies,
    )
    from ..frontend.ir import is_slot_eligible, is_source_local

    c = StepCost()
    state = model_ir.state_dims()
    iters = model_ir.num_iterations
    b = dtype_bytes
    dense_adjs = dense_agg_adjacencies(model_ir)

    for stage in model_ir.stages:
        for mp in stage.passes:
            d_dst = state[mp.destination]
            n_d = meta.nodes(mp.destination)
            # concat is a sequence aggregation too (builder._SEQUENCE_AGGS:
            # the RNN runs over per-slot sequences); leaving it out would
            # undercount its RNN elements ~in-degree-fold
            seq_agg = mp.aggregation.kind in ("ordered", "interleave", "concat")
            concat2 = (
                mp.aggregation.kind == "concat"
                and mp.aggregation.concat_axis == 2
            )
            total_msg_elems = 0.0  # per-iteration RNN elements (ordered)
            final_dims = []  # per-source final message widths
            for src in mp.sources:
                E = meta.edges(src.adj_name)
                d_src = state[src.entity]
                n_s = meta.nodes(src.entity)
                local = is_source_local(src.ops)
                # dense-incidence eligibility (both data-layer gates: entry
                # cap AND the minimum edge count below which the matrix is
                # never emitted, graph.py _DENSE_INC_MIN_EDGES) — used by
                # the local streaming branch below AND the segsum charge
                dense_ok = (
                    local
                    and src.adj_name in dense_adjs
                    and E >= _DENSE_INC_MIN_EDGES
                    and (
                        src.adj_name in dict(meta.inc_blocks)
                        or n_d * n_s <= _DENSE_INC_MAX_ENTRIES
                    )
                )

                # message chain
                cur = d_src
                rows = n_s if local else E
                chain_in = d_src
                named_dims: Dict[str, int] = {}
                # slot-eligible per-edge chains (model/builder._slot_messages,
                # shared predicate frontend.ir.is_slot_eligible) evaluate
                # over the in-degree-sliced layout: ONE slice-map gather
                # (+ its sorted-segment-sum transpose) replaces the per-edge
                # input gathers, so their mandatory row movement is 2E per
                # iteration total, not per input stream
                slot_ok = is_slot_eligible(src.ops)
                for op in src.ops:
                    if op.kind == "mlp":
                        chain_in = sum(
                            state.get(mp.destination) if x == "hs_dest"
                            else (src.edge_param_dim or 0) if x == "edge_params"
                            else d_src if x == "hs_source"
                            # a previous op's named output (not the source
                            # STATE width)
                            else named_dims.get(x, d_src)
                            for x in op.inputs
                        ) or cur
                        dims, cur = _mlp_dims(op.mlp, chain_in)
                        if op.output_name:
                            named_dims[op.output_name] = cur
                        for (i, o) in dims:
                            c.add_flops("message_mlp", 3 * 2 * rows * i * o * iters)
                        # interior activations cross HBM (1 fwd + 2 bwd)
                        for (_i, o) in dims[:-1]:
                            c.add_bytes("message_acts", 3 * rows * o * b * iters)
                if not local:
                    # per-edge inputs must be gathered: the input stream and
                    # its cotangent are edge-rate
                    c.add_bytes("edge_stream", 3 * E * chain_in * b * iters)
                    if slot_ok and seq_agg:
                        pass  # the seq stream below IS the one slice gather
                    else:
                        c.gather_rows += 2 * E * iters
                msg_dim = cur
                final_dims.append(cur)

                if seq_agg:
                    if mp.update.kind == "recurrent":
                        # the calibrated rnn_scan term (below) ALREADY
                        # includes the [L, N, D] input stream (fwd read +
                        # remat re-read + cotangent write) — charging
                        # seq_stream too would double-count it (r5; same
                        # convention as dense_attn's incidence read)
                        pass
                    else:
                        # sequence consumption is inherently edge-slot-rate
                        # even for source-local messages: fwd read + bwd
                        # residual + bwd cotangent
                        c.add_bytes("seq_stream", 3 * E * msg_dim * b * iters)
                    c.gather_rows += 2 * E * iters
                    if concat2:
                        # axis-2 concat shares one slot grid across sources
                        # (features widen, slots do not) — counting each
                        # source's E would OVERcount RNN elements and break
                        # the lower-bound property
                        total_msg_elems = max(total_msg_elems, E)
                    else:
                        total_msg_elems += E
                elif local:
                    # commutative aggregation streaming from the node-rate
                    # message table: table read fwd + cotangent bwd
                    c.add_bytes("node_tables", 2 * n_s * msg_dim * b * iters)
                    # ...but streaming-from-the-table requires a dense/
                    # blocks incidence lowering. When the shape is
                    # ineligible (entry cap — e.g. flagship_x4's 537M-entry
                    # matrix), the best available lowering gathers the
                    # edge-rate message stream (fwd) and routes its
                    # cotangent (bwd): charge the descriptor floor for that
                    # movement, the same best-available-lowering convention
                    # the slot paths set in round 3
                    if not dense_ok:
                        c.gather_rows += 2 * E * iters
                    elif mp.aggregation.kind == "attention":
                        # the flash lowering's calibrated per-entry constant
                        # ALREADY includes the one incidence-matrix read per
                        # pass (dense_attn_entry_passes below) — adding the
                        # bytes item too would double-charge the matrix
                        pass
                    else:
                        # the dense lowering's mandatory traffic is the
                        # incidence matrix itself, read once per direction
                        # of AD per iteration (M @ s fwd, M^T @ ct bwd) —
                        # blocks shrink it to the per-graph diagonal.
                        # 1 byte/entry: the data layer stores non-attention
                        # incidence matrices as int8 (r5, convert-on-load
                        # fused into the matmul — tools/exp_int8_inc.py)
                        blk = dict(meta.inc_blocks).get(src.adj_name)
                        entries = (
                            blk[0] * blk[1] * blk[2] if blk else n_d * n_s
                        )
                        c.add_bytes(
                            "dense_inc_matrix", entries * 1 * 2 * iters
                        )
                else:
                    pass  # edge stream already counted above

                # index companions (int32), fwd + bwd
                c.add_bytes("indices", 2 * E * 4 * iters)
                # aggregation adds
                c.add_flops("aggregation", 2 * E * msg_dim * iters)
                # every non-dense adjacency pays ONE sorted segmented
                # per-source reduction of E rows per iteration (the
                # aggregation itself for sum-style lowerings; the slice/
                # windowed transpose's final pass for ordered/slot paths) —
                # charged at the measured packed-kernel floor (r5,
                # tools/exp_segsum_floor.py). Dense/flash lowerings fold it
                # into the incidence matmul / flash constant instead.
                if seq_agg or not dense_ok:
                    c.segsum_rows += E * iters

                if mp.aggregation.kind == "attention":
                    # per-node score matmuls + width-1 edge score stream
                    c.add_flops("attention", 3 * 2 * (n_s + n_d) * d_dst
                                * d_dst * iters)
                    c.add_bytes("attention_scores", 3 * E * b * iters)
                    # the dense lowering (the fastest measured one for
                    # direct-message attention, flash kernel) pays one
                    # score/exp pass over every [n_dst, n_src] entry per
                    # direction of AD — a VPU-bound cost outside the
                    # two-resource model (charged in apsol via
                    # dense_attn_ps_per_entry; the one incidence-matrix
                    # read per pass is INSIDE that calibrated constant,
                    # so no separate bytes item is added)
                    if (
                        src.adj_name in dense_adjs
                        and E >= _DENSE_INC_MIN_EDGES
                    ):
                        blk = dict(meta.inc_blocks).get(src.adj_name)
                        entries = (
                            blk[0] * blk[1] * blk[2] if blk else n_d * n_s
                        )
                        if entries <= _DENSE_INC_MAX_ENTRIES:
                            c.dense_attn_entry_passes += entries * 2 * iters
                elif mp.aggregation.kind == "convolution":
                    c.add_flops("convolution", 3 * 2 * n_s * d_src * d_dst
                                * iters)

            # update
            if mp.update.kind == "recurrent" and seq_agg:
                # scanned (sequence) recurrent update: charged via the
                # calibrated scan floor (bound_seconds), NOT the FLOPs
                # model — the scan's gate FLOPs, input stream and per-step
                # state round trips are all inside the measured constant.
                # L: the sequential chain length per iteration. max over
                # sources keeps the bound a LOWER bound for concat/
                # interleave merges (whose combined sequence is up to the
                # SUM of the per-source lengths).
                L = max(
                    (meta.maxlen(src.adj_name) for src in mp.sources
                     if dict(meta.max_len).get(src.adj_name)),
                    default=1,
                )
                gate_scale = (
                    1.0 if mp.update.rnn.cell_type == "GRU" else 4.0 / 3.0
                )
                c.rnn_scans.append(
                    (L, total_msg_elems, d_dst, iters, gate_scale)
                )
            elif mp.update.kind == "recurrent":
                per_elem = (12 if mp.update.rnn.cell_type == "GRU" else 16)
                c.add_flops("rnn_update", 3 * per_elem * d_dst * d_dst
                            * n_d * iters)
            else:
                # the update consumes the AGGREGATED message, whose width is
                # the message chains' final output (the source STATE dims
                # would undercount wide message MLPs)
                msg_dim = max(final_dims) if final_dims else d_dst
                dims, _ = _mlp_dims(mp.update.mlp, msg_dim + d_dst,
                                    last_units=d_dst)
                for (i, o) in dims:
                    c.add_flops("ff_update", 3 * 2 * n_d * i * o * iters)
            # updated state: written fwd, cotangent read bwd
            c.add_bytes("state_tables", 2 * n_d * d_dst * b * iters)

    # readout at domain row rate
    for op in model_ir.readout:
        if getattr(op, "mlp", None) is None:
            continue
        ent = next((x for x in op.inputs if x in state), None)
        rows = meta.nodes(ent) if ent else max(meta.label_pad, meta.num_graphs)
        in_dim = sum(state.get(x, 0) for x in op.inputs) or state.get(
            ent, 32
        )
        dims, _ = _mlp_dims(op.mlp, in_dim)
        for (i, o) in dims:
            c.add_flops("readout", 3 * 2 * rows * i * o)
        for (_i, o) in dims[:-1]:
            c.add_bytes("readout_acts", 3 * rows * o * b)

    # optimizer: p/m/v read+write + grad read, f32 master weights
    c.add_bytes("optimizer", 20 * _param_count(model_ir))
    return c


def roofline_report(model_ir, meta, measured_ms: float,
                    hw: HardwareSpec = None,
                    dtype_bytes: int = 2) -> Dict[str, object]:
    """One dict per bench family: itemized model + bound + achieved %."""
    hw = hw or HardwareSpec()
    c = train_step_cost(model_ir, meta, dtype_bytes)
    bounds = c.bound_seconds(hw, dtype_bytes)
    # access-pattern-aware speed of light: the classic two resources PLUS
    # the row-gather floor (a resource the two-resource model cannot see),
    # plus the calibrated dense-attention softmax term where that lowering applies (VPU-bound
    # work over [n_dst, n_src] entries — additive because it overlaps
    # neither the gather descriptors nor the counted byte streams)
    dense_attn_ms = (
        c.dense_attn_entry_passes * hw.dense_attn_ps_per_entry * 1e-12 * 1e3
    )
    # calibrated masked-scan floor: per iteration each scan costs
    # max(sequential-step floor, per-element rate) — additive because the
    # scan is a strict data dependence behind the slice gathers of the same
    # iteration (and its traffic/FLOPs were removed from the byte/FLOP
    # items above)
    rnn_scan_ms = sum(
        iters * max(
            L * hw.rnn_scan_us_per_step * 1e-3,
            elems * width * gate_scale * hw.rnn_scan_ps_per_elem * 1e-9,
        )
        for (L, elems, width, iters, gate_scale) in c.rnn_scans
    )
    # access-pattern floor: the descriptor-bound gathers PLUS the
    # granularity-bound sorted segmented reductions (distinct sequential
    # passes over the same edge streams)
    segsum_ms = c.segsum_rows * hw.segsum_ns_per_row * 1e-9 * 1e3
    ap_floor_ms = bounds["gather_floor_ms_informational"] + segsum_ms
    apsol = max(bounds["sol_ms"], ap_floor_ms) + dense_attn_ms + rnn_scan_ms
    return {
        "hw": hw.name,
        "bytes_mb": round(c.total_bytes / 1e6, 2),
        "gflops": round(c.total_flops / 1e9, 2),
        "t_bytes_ms": round(bounds["t_bytes_ms"], 3),
        "t_flops_ms": round(bounds["t_flops_ms"], 3),
        "sol_ms": round(bounds["sol_ms"], 3),
        "binding": bounds["binding"],
        "measured_ms": round(measured_ms, 3),
        "sol_pct": round(100.0 * bounds["sol_ms"] / measured_ms, 1)
        if measured_ms else None,
        "apsol_ms": round(apsol, 3),
        "apsol_pct": round(100.0 * apsol / measured_ms, 1)
        if measured_ms else None,
        "gather_rows_m": round(c.gather_rows / 1e6, 2),
        "gather_floor_ms_informational": round(
            bounds["gather_floor_ms_informational"], 3
        ),
        "dense_attn_ms": round(dense_attn_ms, 3),
        "rnn_scan_ms": round(rnn_scan_ms, 3),
        "segsum_ms": round(segsum_ms, 3),
        "segsum_rows_m": round(c.segsum_rows / 1e6, 2),
        "bytes_items_mb": {k: round(v / 1e6, 2)
                           for k, v in sorted(c.bytes_by.items())},
        "flops_items_g": {k: round(v / 1e9, 2)
                          for k, v in sorted(c.flops_by.items())},
    }
