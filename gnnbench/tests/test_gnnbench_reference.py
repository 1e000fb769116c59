"""Each plain reference against the program at a tiny size on the CPU, in
float32: three training steps from the same weights on the same batches."""

import pytest
import torch

from conftest import small
from gnnbench import compare, generate, harness, port, weights

SEED = 3 * 2 ** 33 + 5


@pytest.mark.parametrize("seed", [SEED, 11])
def test_reference_agrees_with_the_program(seed):
    c = small(harness.load_cell("routenet_x4_train"))
    dev = torch.device("cpu")
    raws = [generate.batch(c.mix, seed, i) for i in range(harness.CHECKED)]
    spec = harness.modules("reference", c.config).param_spec(c.config)
    prog = port.Program(c.config, dev, "float32")
    harness.check_leaves(prog.leaf_shapes(), spec)
    w = weights.make(spec, seed, dev)
    got = harness.first_steps(prog, [prog.batch(r) for r in raws], w, harness.beta_1(c.config))
    got["loss"] = [float(x) for x in got["loss"]]
    ref = harness.reference_side(c, raws, w, dev)
    values = compare.gaps(got, ref)
    assert values["loss_gap"] < 1e-5 and values["grad_gap"] < 1e-4 and values["step_gap"] < 1e-4
    assert compare.losses_gap(got, ref) < 1e-4
    assert all(v.abs().max() > 0 for v in ref["delta"].values())  # every leaf moved
