"""Decompose K1's cost on an NVIDIA GPU with the substep ladder (K3).

The counterpart of ``benchmarks/kernel_decomposition.py``, at its shapes:
1,000,000 paths, 10 points at 0.1 .. 1.0, 4 substeps, the parameters
(spot, sigma, rate, rho, kappa, theta, v0) = ``PARAMS``.  For each rung of
``ops/heston_ladder.RUNGS`` (``csrc/heston_ladder.cu``) it prints

  * the single-launch time t1: CUDA events around one call of the wrapper,
    warm median of 5;
  * the marginal time (t5 - t1) / 4, t_k the event time around k
    back-to-back launches with generations 0 .. k-1 (the JAX script's
    method): a launch whose kernel outlasts the wrapper's host time hides
    that host time behind the one before it, so a gap between the two is
    launch overhead;
  * path-steps per second at the marginal time;
  * the SASS instructions per path-substep (``ops/sass.IssueSlots``) and
    their issue-slot time;
  * the byte bound, 10 x N x 8 B / 3.35 TB/s;
  * the instructions and the marginal time the rung adds over the rung
    before it;

then one JSON line.  It refuses to run without a card.  Run from the
repository root:

    python -m montecarlo_risk_engine_tpu_torch.tools.kernel_decomposition
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from montecarlo_risk_engine_tpu_torch.models.base import params_from_numpy
from montecarlo_risk_engine_tpu_torch.ops import cuda_build
from montecarlo_risk_engine_tpu_torch.ops.heston_ladder import BATCHED, RUNGS, heston_ladder_paths
from montecarlo_risk_engine_tpu_torch.ops.sass import HBM_BYTES_PER_S, IssueSlots

NUM_PATHS = 1_000_000
NUM_POINTS = 10
NUM_STEPS = 4
PARAMS = (100.0, 0.5, 0.03, -0.7, 2.0, 0.06, 0.04)
TIMELINE = tuple(0.1 * (i + 1) for i in range(NUM_POINTS))
SEED, PHASE = 7, 43  # the JAX script's _seed_words(7, 43, 0)
PATH_SUBSTEPS = NUM_PATHS * NUM_POINTS * NUM_STEPS
REPS = 5


def require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_decomposition needs an NVIDIA GPU: the ladder's rungs are "
                           "CUDA kernels")
    return torch.device("cuda")


def ladder_params(device):
    return params_from_numpy(PARAMS, device=device, dtype=torch.float32)


def run(rung: str, params, generation: int = 0):
    """One launch of ``rung`` at the script's shapes."""
    return heston_ladder_paths(rung, params, TIMELINE, NUM_PATHS, NUM_STEPS, seed=SEED,
                               phase=PHASE, generation=generation)


def launches_ms(rung: str, params, k: int) -> float:
    """Warm median of ``REPS`` CUDA-event times around ``k`` back-to-back
    launches of ``rung``, generations 0 .. k-1."""
    def launches():
        for generation in range(k):
            run(rung, params, generation)

    launches()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launches()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def decompose(device, issue: IssueSlots | None = None):
    """One row per rung: its times, instructions and the bound (see the
    module docstring); the instruction columns are None without ``issue``
    or without cuobjdump."""
    params = ladder_params(device)
    built = None if issue is None else cuda_build.load_library("heston_ladder")
    bytes_bound_ms = NUM_POINTS * NUM_PATHS * 8 / HBM_BYTES_PER_S * 1e3
    rows = []
    for index, rung in enumerate(RUNGS):
        t1 = launches_ms(rung, params, 1)
        marginal = (launches_ms(rung, params, 5) - t1) / 4
        instructions = None if issue is None else issue.per_substep(
            built, f"heston_ladder_kernelILi{index}E", 4 if rung in BATCHED else 1)
        row = {"rung": rung, "single_ms": t1, "marginal_ms": marginal,
               "path_steps_per_s": PATH_SUBSTEPS / marginal * 1e3 if marginal > 0 else None,
               "instructions": instructions,
               "issue_ms": None if instructions is None else issue.ms(instructions, PATH_SUBSTEPS),
               "bytes_bound_ms": bytes_bound_ms, "added_instructions": None, "added_ms": None}
        if rows:
            before = rows[-1]
            row["added_ms"] = marginal - before["marginal_ms"]
            if instructions is not None and before["instructions"] is not None:
                row["added_instructions"] = instructions - before["instructions"]
        rows.append(row)
    return rows


def print_table(rows) -> None:
    fmt = lambda x, f: "not measured" if x is None else format(x, f)
    print(f"[ladder] {NUM_PATHS} paths x {NUM_POINTS} points x {NUM_STEPS} substeps; ms, "
          "marginal = (t5 - t1) / 4; instructions per path-substep (SASS); + = over the rung "
          "before")
    for r in rows:
        print(f"  {r['rung']:16s} single {r['single_ms']:.4f} | marginal {r['marginal_ms']:.4f} "
              f"({fmt(r['path_steps_per_s'], '.3e')} path-steps/s) | instructions "
              f"{fmt(r['instructions'], 'g')}, issue-slot {fmt(r['issue_ms'], '.4f')} | byte bound "
              f"{r['bytes_bound_ms']:.4f} | + {fmt(r['added_instructions'], 'g')} instructions, "
              f"+ {fmt(r['added_ms'], '.4f')} ms")


def main() -> None:
    device = require_card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    rows = decompose(device, IssueSlots.from_card())
    print_table(rows)
    print(json.dumps({"card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
