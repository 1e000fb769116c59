"""Run one cell of the benchmark:

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of standard
output, and each number of the comparison beside its limit as the last lines
of standard error. Exits non-zero, printing no result, without the CUDA
devices the cell asks for.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    root = str(Path(__file__).resolve().parents[1])
    # the checkout's root, not this directory, heads the path
    sys.path[:] = [root] + [p for p in sys.path if Path(p or ".").resolve() != Path(root, "gnnbench")]
    from gnnbench.harness import main

    sys.exit(main(t0=T0))
