"""The whole step's share of the card's peak: over the measured window's
steps, the sum of each step's least time (`peaks.bound_s` of its required
operations and bytes, `cost/<config>.py`), over the window's wall time and
the chips; the peak is that of the configuration's compute type."""

from .. import peaks


def read(w):
    if w.window_s <= 0 or not w.order:
        return None
    dtype = w.config["compute_dtype"]
    least = sum(peaks.bound_s(w.costs[b]["flops"], w.costs[b]["bytes"], dtype) for b in w.order)
    return 100.0 * least / (w.window_s * w.chips)
