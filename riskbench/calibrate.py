"""Read a cell's compared numbers over many seeds, for the program and its
low-precision control, at the cell's own size.

    python3 riskbench/calibrate.py --workload <name> --seeds 1,2,... --control-seeds 3,4,5

The program runs as the benchmark runs it (float64 valuation); the control
is the same program with the port's float32 valuation switched on
(``set_real_dtype(torch.float32)``), the nearest precision below the one
the configurations state.  Each run is compared with the plain reference
as the benchmark compares it.  One process reads both, so set-up is paid
once per side.  The benchmark's own runs never run this.  The last line of
standard output is a JSON object of the readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from riskbench import book, spec  # noqa: E402


def readings(cell, mt, seeds, device):
    """{seed: {number: reading}} of one controller run per seed."""
    import torch
    c = book.build_controller(mt, cell.config, cell.traffic, seeds[0], device)
    out = {}
    for s in seeds:
        c.root_seed = s
        t0 = time.perf_counter()
        run = book.read_results(c.run_simulation(), s, bool(cell.traffic["differentiate"]))
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        out[s] = {k: float(v) for k, v in
                  cell.reference.check(cell.config, cell.traffic, [run], device).items()}
        print(f"seed {s}: run {wall:.3f} s, reference {time.perf_counter() - t1:.3f} s, "
              f"{out[s]}", file=sys.stderr, flush=True)
    del c
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    import torch
    import montecarlo_risk_engine_tpu_torch as mt
    if not torch.cuda.is_available():
        print("riskbench: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control_seeds = [int(s) for s in a.control_seeds.split(",") if s]
    result = {"workload": a.workload, "program": {}, "control": {}}
    if seeds:
        result["program"] = readings(cell, mt, seeds, "cuda")
    if control_seeds:
        mt.set_real_dtype(torch.float32)
        try:
            result["control"] = readings(cell, mt, control_seeds, "cuda")
        finally:
            mt.set_real_dtype(None)
    for side in ("program", "control"):
        for name in sorted({k for r in result[side].values() for k in r}):
            vals = [r[name] for r in result[side].values()]
            print(f"[{side}] {name}: max {max(vals)!r} min {min(vals)!r} over {len(vals)} seeds",
                  file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
