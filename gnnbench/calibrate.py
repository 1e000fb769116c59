"""The readings that the limits of `workloads/<cell>.json` are set from, at
the cell's own size, in one process:

    python3 gnnbench/calibrate.py --workload <cell> --seeds 1,2,3 [--faults 1]

For every seed, the comparison's numbers (`compare.gaps`) of the program's
first steps as a run makes them (the lower readings), of the control (the
reference one precision below its configuration's, in the program's place),
and with --faults 1 of the program with each fault of `faults.py` planted.
One JSON line a seed and reading. Not run by the benchmark's runs.
"""

import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from gnnbench import compare, faults, generate, harness, port, weights

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    config = cell.config
    spec = harness.modules("reference", config).param_spec(config)
    kinds = ("sound",) + (faults.KINDS if args.faults else ())
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        raws = [generate.batch(cell.mix, seed, i) for i in range(harness.CHECKED)]
        w = weights.make(spec, seed, device)
        ref = harness.reference_side(cell, raws, w, device)
        for kind in kinds:
            prog = port.Program(config, device, config["compute_dtype"])
            if kind != "sound":
                faults.plant(prog, kind)
            got = harness.first_steps(prog, [prog.batch(r) for r in raws], w,
                                      harness.beta_1(config))
            got["loss"] = [float(x) for x in got["loss"]]
            prog.release()
            print(json.dumps({"cell": cell.name, "seed": seed, "reading": kind,
                              **compare.gaps(got, ref),
                              "losses_gap": compare.losses_gap(got, ref)}), flush=True)
        control = harness.reference_side(cell, raws, w, device, rounding="control")
        print(json.dumps({"cell": cell.name, "seed": seed, "reading": "control",
                          **compare.gaps(control, ref),
                          "losses_gap": compare.losses_gap(control, ref),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
