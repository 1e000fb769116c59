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
recorded)."""


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
