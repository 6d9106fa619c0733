"""Run one cell of the benchmark once and print its result line.

    python3 riskbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards;
without them it prints no result and exits with 2.  The last line of
standard output is the result (JSON); the compared numbers and their limits
are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the host's thread pools (torch's intra-op
# pool, BLAS) take one thread each, so the host's load is the same from run
# to run.  The library defaults read the same within the runs' spread
# (PERF.md, section 7).
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from riskbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    return harness.run(a.workload, a.seed, a.seconds, bool(a.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
