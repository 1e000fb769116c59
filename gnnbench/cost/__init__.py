"""The work a training step requires, one module per configuration
(`cost/<config>.py`), counted from the raw samples and frozen with the
benchmark:

  step(raws, config) -> {"flops", "bytes"}    the whole step (mfu_roofline_pct)
  segment_sums(raws, config) -> [bytes]       each segment sum (segsum_roofline)
  gru_scans(raws, config) -> (flops, bytes)   the ordered GRU scans (gru_scan_roofline)

A configuration without some kind of work leaves its function out, and the
metric of that work reads nothing."""
