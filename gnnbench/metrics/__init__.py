"""Per-layer metrics, one module per metric (`metrics/<name>.py`), each with
`read(window) -> float | None` over the run's `harness.Window`: None where
there is nothing to read, and the harness then leaves the metric out."""
