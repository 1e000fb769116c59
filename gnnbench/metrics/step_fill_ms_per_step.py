"""Host milliseconds a traced step inside the program's span
`igt.capture.fill` (`training.capture`: the copies into the graph's static
inputs enqueued), summed from the profiler's host records; nothing where the
program opens no such span."""

from .step_check_ms_per_step import ms_per_step

SPAN = "igt.capture.fill"


def read(w):
    return ms_per_step(w, SPAN)
