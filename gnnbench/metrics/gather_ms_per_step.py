"""Device milliseconds a step of PyTorch's index and gather kernels (the row
gathers of `ops.segment`), in the traced window; 0 where none ran."""

PATTERNS = ("indexSelect", "index_select", "vectorized_gather", "gather_kernel",
            "index_elementwise_kernel")


def read(w):
    if w.trace is None:
        return None
    t = sum(e - s for _, s, e in w.trace.kernels(PATTERNS))
    return 1e3 * t / w.trace.steps
