"""Host milliseconds a traced step inside the program's span
`igt.capture.check` (`training.capture`: the test of the bound tensors and
the switches that picks how a call runs), summed from the profiler's host
records, less the profiler's own buffer requests inside it; nothing where the
program opens no such span."""

SPAN = "igt.capture.check"
# the profiler's own host work, as torch versions name it: it holds the
# thread that launches, inside whatever span is open (the window's first)
PROFILERS_OWN = ("Activity Buffer Request", "Activity_Buffer_Request")


def ms_per_step(w, span: str):
    """Host milliseconds a traced step in the spans named `span`, less the
    profiler's own work inside them, or None."""
    if w.trace is None or not w.trace.steps:
        return None
    spans = [(s, e) for name, s, e in w.trace.host if name == span]
    if not spans:
        return None
    own = [(s, e) for name, s, e in w.trace.host if name in PROFILERS_OWN]
    held = sum(max(0.0, min(e, oe) - max(s, os)) for s, e in spans for os, oe in own)
    return 1e3 * (sum(e - s for s, e in spans) - held) / w.trace.steps


def read(w):
    return ms_per_step(w, SPAN)
