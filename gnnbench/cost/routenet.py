"""RouteNet's training step: the operations and bytes it requires.

Operations are those of the matrix products (2 m n k each; elementwise work
is left out), the backward taken as twice the forward. For a GRU row with
input width i and state width h: 2 * 3h * (i + h) forward.

Bytes are the least traffic of a step that keeps nothing on the chip between
passes, in the configuration's compute type (`peaks.ELEMENT`): every pass reads its source
table and its edge index (source and destination, 4 bytes each) and writes
its destination table, forward and again backward; the step reads its
features and labels once, and the optimizer reads and writes the float32
weights and both moments and reads the gradient (28 bytes a weight).
Intermediates (saved gates, per-edge messages) are not counted.
"""

from __future__ import annotations

from .. import counts, peaks


def step(raws, config) -> dict:
    desc = config["description"]
    hs = desc["entities"][0]["hidden_state_dimension"]
    elem = peaks.ELEMENT[config["compute_dtype"]]
    iters = int(desc["message_passing"]["num_iterations"])
    e = counts.edges(raws, "adj_links_paths")
    n_links, n_paths = counts.nodes(raws, "link"), counts.nodes(raws, "path")
    gru_row = 2 * 3 * hs * (hs + hs)
    layers = next(n for n in desc["neural_networks"]
                  if n["nn_name"] == desc["readout"][0]["nn_name"])["nn_architecture"]
    widths = [hs] + [int(l["units"]) for l in layers]
    readout_row = sum(2 * a * b for a, b in zip(widths, widths[1:]))
    n_weights = 2 * (hs * 3 * hs * 2 + 2 * 3 * hs) + sum(
        a * b + b for a, b in zip(widths, widths[1:]))
    flops = 3 * (iters * gru_row * (e + n_links) + readout_row * n_paths)
    per_pass = 2 * ((n_links + n_paths) * hs * elem + e * 8)
    n_bytes = (iters * 2 * per_pass + (n_links + 2 * n_paths) * 4 + 28 * n_weights)
    return {"flops": float(flops), "bytes": float(n_bytes)}


def segment_sums(raws, config) -> list:
    """[bytes of each segment sum] that kernel A runs in one step: the
    transpose of each iteration's gather of link states into the paths'
    ordered scans, but the first iteration's (its link states are features),
    each a sum of the E real path-link edges' gradient rows of the state width
    into the links (the invalid slots that the program also sums are no
    required work). Stage 2's sum of path states into links is not among
    them: its forward runs on other kernels (the incidence product, or
    another path past the dense cap) and its backward is a gather. A sum of r
    rows of width c into m rows reads the rows and their 4-byte index and
    writes the result: r c e + r 4 + m c e bytes (its r c adds never bind)."""
    desc = config["description"]
    hs = desc["entities"][0]["hidden_state_dimension"]
    elem = peaks.ELEMENT[config["compute_dtype"]]
    iters = int(desc["message_passing"]["num_iterations"])
    e, links = counts.edges(raws, "adj_links_paths"), counts.nodes(raws, "link")
    return [e * hs * elem + e * 4 + links * hs * elem] * (iters - 1)


def gru_scans(raws, config) -> tuple:
    """(operations, bytes) of one step's ordered scans: every iteration, one
    scan over each path's links from the path's state, over the batch's real
    time steps T (the path-link edges), state and input width h:
      forward:  2 * 3h * 2h operations a time step; read the inputs (T h),
                the initial states and the lengths, write the final states;
      backward: twice the forward's operations; read the inputs, the initial
                states and the final states' gradient, write the inputs'
                gradient and the initial states' gradient, but in the first
                iteration, whose inputs and initial states are features.
    Activations and weights in the compute type (`peaks.ELEMENT`)."""
    desc = config["description"]
    h = desc["entities"][0]["hidden_state_dimension"]
    iters = int(desc["message_passing"]["num_iterations"])
    e_b = peaks.ELEMENT[config["compute_dtype"]]
    t = counts.edges(raws, "adj_links_paths")
    n = counts.nodes(raws, "path")
    weights = (h * 3 * h * 2 + 2 * 3 * h) * e_b
    fwd_ops = 2 * 3 * h * 2 * h * t
    fwd_bytes = (t * h + 2 * n * h) * e_b + n * 4 + weights

    def bwd_bytes(first):
        return (t * h + 2 * n * h + (0 if first else t * h + n * h)) * e_b + n * 4 + 2 * weights

    ops = iters * 3 * fwd_ops
    return ops, iters * fwd_bytes + bwd_bytes(True) + (iters - 1) * bwd_bytes(False)
