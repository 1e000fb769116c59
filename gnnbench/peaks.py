"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), frozen: every roofline share of the
benchmark is stated against them, at the peak of the type its configuration
computes in."""

FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # FLOP/s: tensor cores; CUDA cores
HBM_BYTES = 3.35e12  # bytes/s of device memory
ELEMENT = {"bfloat16": 2, "float32": 4}  # bytes of an activation


def bound_s(flops: float, n_bytes: float, dtype: str) -> float:
    """The least seconds a piece of work in `dtype` can take: the larger of
    its operations at the peak rate and its bytes at the memory rate."""
    return max(flops / FLOPS[dtype], n_bytes / HBM_BYTES)
