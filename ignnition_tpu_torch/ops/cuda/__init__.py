"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and a launch counter, each entry a `torch.library` operator
(`torch.ops.ignnition_tpu_torch.*`): `segment_kernels` (kernel A, the CSR
segment sum, and the id-keyed sum), `rnn_kernels` (kernels B and C, the
masked GRU scan and its backward), `attention_kernels` (kernels D and E,
flash-GAT forward and backward). `_build` compiles
`ignnition_tpu_torch/csrc/` at first use.

A wrapper counts a launch where it launches its kernel from Python: on an
eager call, and on a call recorded into a CUDA graph. A replay of the graph
runs the recorded launches again without any wrapper running, so the
counters do not see it (`training.capture` keeps what each capture
recorded).

Three switches choose between a kernel and its plain version, under the JAX
package's variables and values (`auto`, `never`, `always`), read from the
environment when this package is imported and kept in one table here
(`modes`, `set_mode`): `IGNNITION_TPU_PALLAS` (also
`ops.segment.set_pallas_mode`) for kernel A, its windowed form and the
id-keyed kernel, and with `IGNNITION_TPU_FLASH_ATTN` for D and E;
`IGNNITION_TPU_FUSED_RNN` (also `rnn_kernels.set_mode`) for B and C. `auto`
launches the kernel on a CUDA tensor and gives a CPU tensor the plain
version, through the operator; `never` calls the plain version on any device,
past the operator, so that autograd differentiates it; `always` launches the
kernel and raises where it cannot run, on a CPU tensor too. The JAX package's
size floors are the TPU's and apply to none of them."""

import os

MODES = ("auto", "never", "always")
# switch -> its environment variable
VARIABLES = {
    "pallas": "IGNNITION_TPU_PALLAS",
    "flash-attn": "IGNNITION_TPU_FLASH_ATTN",
    # the JAX package's default is 'never', for the TPU's reason (its fused
    # scan slowed the step around it); here it is 'auto': kernel B runs 5.2x
    # ahead of cuDNN's GRU on an H100
    "fused-rnn": "IGNNITION_TPU_FUSED_RNN",
}
# the switches as they stand
_MODES = {switch: os.environ.get(var, "auto") for switch, var in VARIABLES.items()}


def launch_counts() -> dict:
    """The wrappers' launch counters by kernel name."""
    from . import attention_kernels as ak
    from . import rnn_kernels as rk
    from . import segment_kernels as sk

    return {
        "csr_segment_sum": sk.launch_count,
        "csr_segment_sum_windows": sk.windows_launch_count,
        "segment_sum_ids": sk.ids_launch_count,
        "masked_gru_scan": rk.launch_count,
        "masked_gru_scan_bwd": rk.bwd_launch_count,
        "flash_gat_fwd": ak.fwd_launch_count,
        "flash_gat_bwd": ak.bwd_launch_count,
    }


def check_mode(mode: str, switch: str) -> str:
    """`mode` if it is one of `MODES`, else the JAX package's ValueError."""
    if mode not in MODES:
        raise ValueError(f"invalid {switch} mode '{mode}'")
    return mode


def set_mode(switch: str, mode: str) -> None:
    """Set one switch ('pallas', 'flash-attn' or 'fused-rnn') to 'auto',
    'never' or 'always'."""
    if switch not in _MODES:
        raise KeyError(switch)
    _MODES[switch] = check_mode(mode, switch)


def modes() -> tuple:
    """The switches as they stand: (pallas, flash-attn, fused-rnn)."""
    return tuple(_MODES[s] for s in VARIABLES)


def mode(switch: str) -> str:
    """The mode a switch's kernels follow. D and E ('flash-attn') follow the
    pallas switch too, as the JAX `_use_flash_attn` does: 'never' where
    either says so, else 'always' where either says so, else 'auto'."""
    if switch != "flash-attn":
        return check_mode(_MODES[switch], switch)
    both = (check_mode(_MODES["pallas"], "pallas"), check_mode(_MODES[switch], switch))
    return next((m for m in ("never", "always") if m in both), "auto")


def takes_plain(t, switch: str, name: str) -> bool:
    """Whether the wrapper `name` calls its plain version on `t` under its
    switch's mode: under `never`. Under `always` a tensor off the card
    raises, so that no call falls back in silence; under `auto` the operator
    chooses by device."""
    m = mode(switch)
    if m == "never":
        return True
    if m == "always" and t.device.type != "cuda":
        raise RuntimeError(
            f"{name}: the {switch} mode is 'always', but its kernel cannot run on a "
            f"{t.device.type} tensor"
        )
    return False
