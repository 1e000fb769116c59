"""The comparison fails its control and every fault a training cell can have,
and passes a sound run: whole runs of the harness on the CPU at a small size
(the look for a card skipped), with the timed path broken underneath.

The control is the reference one precision below its configuration's (TF32
for float32, float8 for bfloat16), put in the program's place. The
faults (`faults.py`): a step that leaves its state unchanged; half of the
batch left out, the mean taken over the rest; every prediction altered where
it is produced."""

import time

import pytest
import torch

from conftest import medium, small
from gnnbench import compare, faults, generate, harness, weights

CELLS = ["routenet_x4_train", "routenet_train"]
SEED = 2 ** 36 + 99


def run(cell, hook=None):
    c = small(harness.load_cell(cell))
    return harness.execute(c, SEED, 0.2, False, torch.device("cpu"), time.perf_counter(),
                           step_hook=hook)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, kind):
    def hook(step):
        prog = step.__self__
        faults.plant(prog, kind)
        return prog.step

    r = run(cell, hook)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, 17])
def test_the_control_is_not_correct(cell, seed):
    c = medium(harness.load_cell(cell))
    dev = torch.device("cpu")
    raws = [generate.batch(c.mix, seed, i) for i in range(harness.CHECKED)]
    w = weights.make(harness.modules("reference", c.config).param_spec(c.config), seed, dev)
    ref = harness.reference_side(c, raws, w, dev)
    control = harness.reference_side(c, raws, w, dev, rounding="control")
    values = compare.gaps(control, ref)
    assert not compare.judge(values, c.run["limits"]), values
