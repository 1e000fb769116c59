"""The examples of `examples/<name>/main.py` on the port's api: each reads
the unchanged `examples/<name>/model_description.yaml` of the checkout and
takes `--device` (the GPU by default, `--device cpu` for the CPU). Run them
from the checkout's root as `python -m ignnition_tpu_torch.examples.routenet
--synthetic`."""

import os

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples")


def description(name: str) -> str:
    """The path of `examples/<name>/model_description.yaml`."""
    return os.path.normpath(os.path.join(EXAMPLES_DIR, name, "model_description.yaml"))
