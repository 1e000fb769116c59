"""Copies into the compiled step's static inputs a filled call, from the
program's counters (`ignnition_tpu_torch.utils.trace`): `capture.input_copies`
over the calls that fill them, `capture.calls.capture` and
`capture.calls.replay`, over the run (every call of the measured and the
traced window is a replay). Nothing where the program in this process keeps
no such counters, or ran every call eagerly (no CUDA graph); an error where
it keeps them but counted no call, or counted fills and no copies."""

import sys

MODULE = "ignnition_tpu_torch.utils.trace"


def read(w):
    tracing = sys.modules.get(MODULE)
    if tracing is None:
        return None
    c = tracing.counters()
    if not any(k.startswith("capture.calls.") for k in c):
        raise RuntimeError(f"{MODULE} is loaded but counted no call of the compiled step")
    fills = c.get("capture.calls.capture", 0) + c.get("capture.calls.replay", 0)
    if not fills:
        return None
    if "capture.input_copies" not in c:
        raise RuntimeError(f"{MODULE} counted {fills} filled calls and no input copies")
    return c["capture.input_copies"] / fills
