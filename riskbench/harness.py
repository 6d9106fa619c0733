"""One run of one cell: set-up, the measured window, the metrics, the check.

The window is a closed loop of one caller: a risk run of the book through
``SimulationController.run_simulation`` to its results on the host, then
the next, until ``--seconds`` have passed; the run that is going on then
finishes.  Run ``i`` of the window takes root seed ``seed + 1 + i`` (the
warm-up takes ``seed``), so every run draws its own paths and does the
same work.  With ``--trace 1`` the profiler records the card alone over
the window (at most the traffic's ``trace_runs`` runs), then the host's
torch operations as well over a tenth as many more runs (at least one),
which name the card's idle gaps and are not timed (trace.py).  After the window the
program's state is freed and the plain reference recomputes a sample of
the runs, drawn from the seed, the last run always among them.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import random
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from riskbench import book, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "montecarlo_risk_engine_tpu")
SEED_MASK = 0xFFFFFFFF  # the port keys its Philox stream by the seed's low 32 bits
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


class Record(NamedTuple):
    """What a metric reader reads: the window's host clocks and peak, the
    traced window's summary (``--trace 1``) and the path launches one run
    makes."""

    cell: spec.Cell
    setup_s: float
    walls: List[float]
    window_s: float
    peak_bytes: int
    trace: Optional[trace.TraceSummary]
    launches: list


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of the JAX side's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_seed(seed: int, i: int) -> int:
    """Root seed of window run ``i`` (-1: the warm-up)."""
    return (seed + 1 + i) & SEED_MASK


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def sample_runs(n_runs: int, k: int, seed: int) -> List[int]:
    """``k`` run indices drawn from the seed, the last run always among them."""
    rest = random.Random(seed).sample(range(n_runs - 1), min(k - 1, n_runs - 1)) if n_runs > 1 else []
    return sorted(set(rest) | {n_runs - 1})


def finite(out: book.RunOutput) -> bool:
    arrays = [out.values, out.errors] + ([out.jac] if out.jac is not None else [])
    return all(bool(np.all(np.isfinite(a))) for a in arrays)


def preload_path_kernel(c) -> None:
    """Build or load the path kernel's library that the controller's route
    launches (from the program's build directory inside the checkout)."""
    if not getattr(c, "_kernel_active", False):
        return
    from montecarlo_risk_engine_tpu_torch.ops import cuda_build, hybrid_paths
    model = c.model
    if hasattr(model, "kernel_blocks"):
        blocks = model.kernel_blocks()
    elif hasattr(model, "kernel_block"):
        blocks = [model.kernel_block(c.simulation_scheme)]
    else:
        return
    if blocks and all(b is not None for b in blocks):
        cuda_build.load_library("hybrid_paths", hybrid_paths.role_flags(blocks))


def run(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: Optional[str] = None, traffic_overrides: Optional[Dict[str, Any]] = None) -> int:
    """Run one cell once; prints the result line and returns the exit code.

    ``device`` None means the card, and the run refuses to go on without
    one.  ``device`` and ``traffic_overrides`` exist for the tests."""
    cell = spec.load_cell(workload)
    if traffic_overrides:
        cell = cell._replace(traffic={**cell.traffic, **traffic_overrides})
    checkout = spec.ROOT
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(checkout / ".riskbench_cache" / sub)
    phases: Dict[str, float] = {}
    mark = [t_start]

    def phase(name: str) -> None:
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"riskbench: {workload} needs {cell.chips} CUDA device(s), found {found}; "
                "no result")
            return 2
        device = "cuda"
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    import montecarlo_risk_engine_tpu_torch as mt
    phase("imports")
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)
        sync()
    phase("cuda_init")
    c = book.build_controller(mt, cell.config, cell.traffic, run_seed(seed, -1), device)
    phase("book")
    if on_card:
        preload_path_kernel(c)
    phase("path_kernel_load")
    c.run_simulation()
    sync()
    phase("warmup")
    setup_s = time.perf_counter() - t_start
    log("[setup] " + ", ".join(f"{k} {v:.4f} s" for k, v in phases.items())
        + f"; setup_s {setup_s:.4f} s")

    def window(first_index: int, max_runs: int, ranges: bool):
        """Runs back to back from run ``first_index`` on, until ``seconds``
        have passed or ``max_runs`` are done: (walls, (seed, result) pairs,
        failures, the host clock from the first run's start to the last's
        end)."""
        walls, outputs, failed, first, i = [], [], 0, None, first_index
        while True:
            c.root_seed = run_seed(seed, i)
            scope = torch.profiler.record_function(trace.RUN_RANGE) if ranges \
                else contextlib.nullcontext()
            t0 = time.perf_counter()
            first = t0 if first is None else first
            result = None
            with scope:
                try:
                    result = c.run_simulation()
                    sync()
                except Exception:  # a failed run is counted, and the window goes on
                    failed += 1
                    log(f"riskbench: run {i} (seed {c.root_seed}) raised:\n"
                        f"{traceback.format_exc()}")
            end = time.perf_counter()
            walls.append(end - t0)
            outputs.append((c.root_seed, result))
            i += 1
            if end - first >= seconds or len(walls) >= max_runs:
                return walls, outputs, failed, end - first

    summary = None
    trace_runs = int(cell.traffic.get("trace_runs", 1 << 30))
    if traced:
        # The card alone over the window, then a few runs with the host too.
        from torch.profiler import ProfilerActivity, profile
        device_prof = profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])
        device_prof.__enter__()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    walls, outputs, failed, window_s = window(0, trace_runs if traced else 1 << 62, False)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"[window] {len(walls)} runs in {window_s:.4f} s; walls min {min(walls):.6f} median "
        f"{sorted(walls)[len(walls) // 2]:.6f} max {max(walls):.6f} s")
    if traced:
        device_prof.__exit__(None, None, None)
        device_events = trace.from_profiler(device_prof)[0]
        del device_prof
        host_prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if on_card else []))
        host_prof.__enter__()
        more = window(len(walls), max(1, min(trace_runs, len(walls)) // 10), True)
        host_prof.__exit__(None, None, None)
        with_host = trace.summarize(*trace.from_profiler(host_prof))
        del host_prof
        outputs += more[1]
        failed += more[2]
        summary = trace.device_summary(device_events, window_s, len(walls), with_host.idle_gaps)
        log(f"[trace] card alone: {len(walls)} runs, busy {summary.busy_s:.6f} s of "
            f"{window_s:.6f} s (device events span {trace.span(device_events):.6f} s); "
            f"with the host: {with_host.runs} runs, walls {', '.join(f'{w:.6f}' for w in more[0])} s")

    found = forbidden_modules()
    if found:
        log(f"riskbench: modules of the JAX side are loaded: {', '.join(found)}; no result")
        return 3

    differentiated = bool(cell.traffic["differentiate"])
    runs: List[Optional[book.RunOutput]] = []
    for s, result in outputs:
        out = None if result is None else book.read_results(result, s, differentiated)
        if out is not None and not finite(out):
            failed += 1
            log(f"riskbench: run with seed {s} returned a non-finite value")
            out = None
        runs.append(out)
    launches = cell.reference.path_launches(cell.config, cell.traffic)
    record = Record(cell, setup_s, walls, window_s, peak, summary, launches)
    section = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in section:
        value = spec.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    # The program's state goes before the reference runs.
    del c, outputs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    picks = sample_runs(len(runs), int(cell.traffic.get("check_runs", 1)), seed)
    sampled = [runs[k] for k in picks]
    checks: Dict[str, Dict[str, float]] = {}
    correct = failed == 0 and all(r is not None for r in sampled)
    if all(r is not None for r in sampled):
        readings = cell.reference.check(cell.config, cell.traffic, sampled, device)
        for name, value in readings.items():
            limit = float(cell.traffic["limits"][name])
            value = float(value)
            checks[name] = {"value": value, "limit": limit}
            correct = correct and math.isfinite(value) and value <= limit
    if on_card:
        sync()
    limit_line = power_limit() if on_card else None

    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    if limit_line:
        dev["name_and_power_limit"] = limit_line
    line: Dict[str, Any] = {"correct": bool(correct), "attempted": len(runs), "failed": failed,
                            "metrics": metrics, "device": dev,
                            "setup_phases_s": phases, "checked_seeds": [r.seed for r in sampled
                                                                         if r is not None]}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": [[n, s] for n, s in summary.device_ops],
                             "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
        log("[trace] device ops: " + "; ".join(f"{n} {s:.6f} s" for n, s in summary.device_ops[:5]))
        log("[trace] idle gaps: " + "; ".join(f"{n} {s:.6f} s" for n, s in summary.idle_gaps[:5]))
    line["checks"] = checks
    for name, ch in checks.items():
        log(f"[check] {name} {ch['value']!r} limit {ch['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0
