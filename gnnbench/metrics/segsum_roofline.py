"""Kernel A and the id-keyed kernel (`segment_sum_kernel`): the share of their
device time in the traced window that the segment sums the step requires
(`cost/<config>.py` `segment_sums`, counted from the raw samples) would take
at the card's memory rate. Listed only for cells in which these kernels run
every one of those sums: where some run on other kernels, the required bytes
would count work this kernel never did."""

from .. import peaks
from ..harness import modules

KERNELS = ("segment_sum_kernel",)


def read(w):
    sums = getattr(modules("cost", w.config), "segment_sums", None)
    if w.trace is None or sums is None:
        return None
    spent = sum(e - s for _, s, e in w.trace.kernels(KERNELS))
    if spent <= 0:
        return None
    least = sum(sum(sums(w.raws[b], w.config)) for b in w.traced_order) / peaks.HBM_BYTES
    return 100.0 * least / spent
