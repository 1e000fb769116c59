"""Host milliseconds of each call into the compiled step (the harness's span
around the call: the copies into the graph's inputs enqueued and the replay
launched), averaged over the measured window's steps."""


def read(w):
    if not w.host_step_s:
        return None
    return 1e3 * sum(w.host_step_s) / len(w.host_step_s)
