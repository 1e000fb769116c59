"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and a launch counter, each entry a `torch.library` operator
(`torch.ops.ignnition_tpu_torch.*`): `segment_kernels` (kernel A, the CSR
segment sum, and the id-keyed sum), `rnn_kernels` (kernels B and C, the
masked GRU scan and its backward), `attention_kernels` (kernels D and E,
flash-GAT forward and backward). `_build` compiles
`ignnition_tpu_torch/csrc/` at first use."""
