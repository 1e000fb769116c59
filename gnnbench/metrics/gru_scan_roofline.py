"""Kernels B and C (the masked GRU scan forward, `masked_gru_scan*`, and
backward, `gru_bwd_*`): the share of their device time in the traced window
that the scans the step requires (`cost/<config>.py` `gru_scans`, counted
from the raw samples) would take at the card's peaks: the larger of their
operations at the compute type's peak and their bytes at 3.35 TB/s."""

from .. import peaks
from ..harness import modules

KERNELS = ("masked_gru_scan", "gru_bwd_")


def read(w):
    scans = getattr(modules("cost", w.config), "gru_scans", None)
    if w.trace is None or scans is None:
        return None
    spent = sum(e - s for _, s, e in w.trace.kernels(KERNELS))
    if spent <= 0:
        return None
    least = sum(peaks.bound_s(*scans(w.raws[b], w.config), w.config["compute_dtype"])
                for b in w.traced_order)
    return 100.0 * least / spent
