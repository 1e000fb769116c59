"""Device milliseconds a step of the memory copies (host to device and device
to device: the static inputs of the replayed graph), in the traced window."""


def read(w):
    if w.trace is None:
        return None
    t = sum(e - s for name, s, e in w.trace.device if name.startswith("Memcpy"))
    return 1e3 * t / w.trace.steps
