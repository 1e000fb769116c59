"""The benchmark's own tests, on the CPU at small sizes:

    python3 -m pytest gnnbench/tests -q

Tests that need a card carry the `cuda` marker and decide inside a fixture
whether there is one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card only")
    return torch.device("cuda", 0)


def medium(cell):
    """`cell` with its graphs at their full sizes but few to a batch: the size
    at which the control's readings stand where they do at the cell's own."""
    from gnnbench import generate

    cell.mix = generate.family(cell.mix).medium(cell.mix)
    return cell


def small(cell):
    """`cell` with its traffic cut to a size the CPU runs in seconds and its
    compute in float32, where the program and the reference agree to
    rounding."""
    from gnnbench import generate

    cell.mix = generate.family(cell.mix).small(cell.mix)
    cell.config = {**cell.config, "compute_dtype": "float32"}
    return cell
