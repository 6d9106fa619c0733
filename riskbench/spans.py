"""The span pass of a traced run: the card's idle time put down to the
port's phases.

The port records spans of its phases when a caller turns tracing on
(``montecarlo_risk_engine_tpu_torch/tracing.py``), stamped with
``time.time_ns()``, the unix clock on which ``torch.profiler`` stamps the
card's records too.  After the traced window and its host-op runs, the span
pass reruns the window's controller with tracing on and the profiler
recording the card alone, as many runs as the host-op runs (at least one),
on the seeds that follow theirs.  No host op is recorded, so the host runs
near its untraced pace.

The profiler's card records can sit off the host's clock, by 10-120 us
in most sessions on an H100 and up to 0.76 ms in others, and the offset
drifts within a session (-0.73 ms before four runs, -0.02 ms after them,
in one): the pass therefore brackets its runs with stamps, one kernel the
port never launches (Bessel's J0) launched and awaited between two
``time.time_ns()`` reads, 2 ms apart so that each stamp's kernel is the one
nearest it, and moves the card's records by the stamps' offset,
interpolated in time between the stamps before the runs and those after
them (:func:`calibrated`).  A group of stamps whose offsets disagree by
more than ``STAMP_AGREE_NS`` (records lost or late) is not used.

Each idle interval of the card inside a ``run`` span is cut at the span
boundaries in it, and each piece goes to the innermost span open there
(:func:`trace.innermost_ops`); the layers below sum the pieces by span
name.  Idle outside every ``run`` span is the harness's own loop and goes
to no layer.  A port without the tracing module, or a reader called outside
``harness.run``, gives no pass: the metrics of this module read nothing.

A metric reader sees only the ``Record``; the pass takes the controller
from the frame of the ``harness.run`` that calls the readers, runs once per
record, and is shared by the readers.  A run of the pass that raises, or
returns a value that is not finite, raises here: the traced run fails.
"""

from __future__ import annotations

import bisect
import contextlib
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from riskbench import book, harness, trace

RUN = "run"
STAMP_KERNEL = "bessel_j0"  # in the name of the one kernel a stamp launches
STAMPS = 8  # before the runs and again after them
STAMP_GAP_S = 0.002  # apart, beyond any offset seen
STAMP_REACH_NS = 1_000_000  # the farthest a stamp's kernel is looked for
STAMP_AGREE_NS = 300_000  # the most a group's offsets may spread (1.6 ms seen when mispaired)
LAYERS = {
    "controller": ("run", "plan", "jacobian", "sweep", "hessian_row", "results"),
    "paths": ("paths", "kernel_noise", "stream"),
    "valuation": ("resolve", "evaluate", "fit", "value", "netting", "fold", "assemble"),
    "device_wait": ("to_host",),
}


class SpanSummary(NamedTuple):
    runs: int
    window_s: float  # the pass's host clock over its runs, back to back
    spans_per_run: float
    idle_s: Dict[str, float]  # card idle inside runs, by innermost span name
    self_s: Dict[str, float]  # host time by span name, children's time taken out
    harness_idle_s: float  # card idle in the pass's window outside every run span
    total_idle_s: float  # card idle in the pass's window
    valuation_host_s: float  # host time inside the union of the valuation spans
    to_host_s: float  # host time inside to_host spans
    first_kernel_slack_s: Optional[float]  # least (first kernel's start - run start)
    last_event_slack_s: Optional[float]  # most (last device end - last to_host end)


def layer_idle_s(s: SpanSummary, layer: str) -> float:
    return sum(s.idle_s.get(name, 0.0) for name in LAYERS[layer])


def device_intervals_ns(prof) -> List[Tuple[int, int, str]]:
    """The card's kernels, copies and sets of a finished ``torch.profiler``
    run as (start, end, name) in the profiler's absolute nanoseconds (the
    unix clock of ``time.time_ns()``), ranges' shadows left out."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if not str(ev.device_type()).endswith("CUDA"):
            continue
        if ev.name() == trace.RUN_RANGE or (
                hasattr(ev, "is_user_annotation") and ev.is_user_annotation()):
            continue
        start = trace._ns(ev, "start")
        out.append((start, start + trace._ns(ev, "duration"), ev.name()))
    return out


def stamps(torch, x, n: int = STAMPS) -> List[Tuple[int, int]]:
    """``n`` (before, after) ``time.time_ns()`` pairs, each around one
    stamp kernel on the card tensor ``x``, launched and awaited."""
    out = []
    for _ in range(n):
        time.sleep(STAMP_GAP_S)
        torch.cuda.synchronize()
        t0 = time.time_ns()
        torch.special.bessel_j0(x, out=x)
        torch.cuda.synchronize()
        out.append((t0, time.time_ns()))
    return out


def stamp_offsets_ns(kernels: Sequence[Tuple[int, int]],
                     pairs: Sequence[Tuple[int, int]]) -> List[int]:
    """Per stamp whose kernel is in the trace (the stamp kernel nearest it,
    within ``STAMP_REACH_NS``), the card's clock in the trace minus
    ``time.time_ns()``: the shift that centres the kernel between the
    stamp's two reads."""
    out = []
    for t0, t1 in pairs:
        near = [ks + ke for ks, ke in kernels if abs(ks + ke - t0 - t1) <= 2 * STAMP_REACH_NS]
        if near:
            out.append(min(near, key=lambda k: abs(k - t0 - t1)) // 2 - (t0 + t1) // 2)
    return out


def calibrated(device_ns: Sequence[Tuple[int, int, str]], before: Sequence[Tuple[int, int]],
               after: Sequence[Tuple[int, int]]) -> List[Tuple[int, int, str]]:
    """The card's records moved onto the host's clock (logged): by the
    median offset of the stamps before the runs up to the last of them, by
    that of the stamps after the runs from the first of them, and in
    between by the line through the two; the stamps' own records left
    out."""
    kernels = [(s, e) for s, e, name in device_ns if STAMP_KERNEL in name]
    ends = []  # (time, offset) at the inner edge of each group of stamps used
    for group, edge in ((before, lambda g: g[-1][1]), (after, lambda g: g[0][0])):
        found = stamp_offsets_ns(kernels, group)
        used = bool(found) and max(found) - min(found) <= STAMP_AGREE_NS
        if used:
            ends.append((edge(group), statistics.median(found)))
        harness.log(f"[spans] clock: {len(found)} of {len(group)} stamps in the trace"
                    + (f", offsets {min(found) / 1e3:.1f} to {max(found) / 1e3:.1f} us"
                       if found else "") + ("" if used else ", not used"))

    def offset(t: float) -> float:
        if len(ends) < 2:
            return ends[0][1] if ends else 0.0
        (ta, oa), (tb, ob) = ends
        return oa + (ob - oa) * min(1.0, max(0.0, (t - ta) / (tb - ta)))

    return [(s - offset(s), e - offset(s), name) for s, e, name in device_ns
            if STAMP_KERNEL not in name]


def summarize(spans: Sequence, device_ns: Sequence[Tuple[int, int, str]], lo_ns: int,
              hi_ns: int) -> SpanSummary:
    """Attribute the card's idle time in the pass's window [lo_ns, hi_ns]
    to the spans (``tracing.Span`` records of whole runs, roots ``run``);
    ``device_ns`` holds the card's (start, end, name) in the same clock."""
    sec = lambda ns: (ns - lo_ns) * 1e-9  # noqa: E731
    device = sorted((sec(s), sec(e), name) for s, e, name in device_ns)
    busy_all = trace.merge(trace.clip([(s, e) for s, e, _ in device], 0.0, sec(hi_ns)))
    total_idle = sum(e - s for s, e in trace.gaps(busy_all, 0.0, sec(hi_ns)))
    by_run: Dict[int, list] = defaultdict(list)
    for sp in spans:
        by_run[sp.run].append(sp)
    idle: Dict[str, float] = defaultdict(float)
    self_s: Dict[str, float] = defaultdict(float)
    valuation_host = to_host = 0.0
    first_slack: Optional[float] = None
    last_slack: Optional[float] = None
    runs = sorted((sp for sp in spans if sp.parent == -1 and sp.name == RUN),
                  key=lambda r: r.start_ns)
    # run k owns the card's work that starts between the middles of the gaps
    # before and after it: the card is idle between runs, so work that a
    # clock puts outside its run still goes to the run that is nearest
    middles = [(sec(a.end_ns) + sec(b.start_ns)) / 2 for a, b in zip(runs, runs[1:])]
    owner_lo, owner_hi = [float("-inf")] + middles, middles + [float("inf")]
    for sp in spans:
        d = (sp.end_ns - sp.start_ns) * 1e-9
        self_s[sp.name] += d
        if sp.parent >= 0:
            self_s[spans[sp.parent].name] -= d
    for k, root in enumerate(runs):
        members = by_run[root.run]
        lo, hi = sec(root.start_ns), sec(root.end_ns)
        events = [trace.Event(sp.name, sec(sp.start_ns), sec(sp.end_ns)) for sp in members]
        cuts = sorted({t for ev in events for t in (ev.start, ev.end) if lo < t < hi})
        pieces = []
        for s, e in trace.gaps(trace.clip(busy_all, lo, hi), lo, hi):
            edges = [s] + cuts[bisect.bisect_right(cuts, s):bisect.bisect_left(cuts, e)] + [e]
            pieces += [(a, b) for a, b in zip(edges, edges[1:]) if b > a]
        for (a, b), name in zip(pieces, trace.innermost_ops(events, [(a + b) / 2
                                                                     for a, b in pieces])):
            idle[name or RUN] += b - a
        valuation_host += sum(e - s for s, e in trace.merge(
            (ev.start, ev.end) for ev in events if ev.name in LAYERS["valuation"]))
        waits = [ev for ev in events if ev.name == "to_host"]
        to_host += sum(ev.end - ev.start for ev in waits)
        mine = [d for d in device if owner_lo[k] <= d[0] < owner_hi[k]]
        kernels = [d for d in mine if trace.is_kernel(d[2])]
        if kernels:
            gap = kernels[0][0] - lo
            first_slack = gap if first_slack is None else min(first_slack, gap)
        if mine and waits:
            over = max(e for _, e, _ in mine) - max(ev.end for ev in waits)
            last_slack = over if last_slack is None else max(last_slack, over)
    n = len(runs)
    in_runs = sum(idle.values())
    return SpanSummary(n, sec(hi_ns), len(spans) / n if n else 0.0, dict(idle), dict(self_s),
                       total_idle - in_runs, total_idle, valuation_host, to_host,
                       first_slack, last_slack)


def _harness_controller():
    """The controller of the ``harness.run`` that reads the metrics, or None.
    Reading a frame's locals in Python 3.12 leaves a snapshot of them on the
    frame, which would keep the controller alive past the harness's ``del``:
    it is emptied at once."""
    frame = sys._getframe(1)
    try:
        while frame is not None and frame.f_code is not harness.run.__code__:
            frame = frame.f_back
        if frame is None:
            return None
        local = frame.f_locals
        try:
            return local.get("c")
        finally:
            if isinstance(local, dict):
                local.clear()
    finally:
        del frame


def log_summary(s: SpanSummary, window_run_s: float) -> None:
    per = 1e3 / s.runs
    ranked = lambda d: "; ".join(f"{k} {v * per:.3f}" for k, v in  # noqa: E731
                                 sorted(d.items(), key=lambda kv: -kv[1]))
    layers = ", ".join(f"{layer} {layer_idle_s(s, layer) * per:.3f}" for layer in LAYERS)
    slack = lambda v: "none" if v is None else f"{v * 1e6:.1f} us"  # noqa: E731
    harness.log(f"[spans] pass: {s.runs} runs, run_s {s.window_s / s.runs:.6f} s (window "
                f"{window_run_s:.6f} s), {s.spans_per_run:.1f} spans a run; card idle "
                f"{s.total_idle_s * per:.3f} ms a run: {layers}, harness "
                f"{s.harness_idle_s * per:.3f}")
    harness.log(f"[spans] idle ms/run by span: {ranked(s.idle_s)}")
    harness.log(f"[spans] host ms/run by span: {ranked(s.self_s)}")
    harness.log(f"[spans] clock: first kernel after its run's start by at least "
                f"{slack(s.first_kernel_slack_s)}; last device event after its last to_host's "
                f"end by at most {slack(s.last_event_slack_s)}")


def run_pass(record) -> Optional[SpanSummary]:
    """The span pass over the controller of the calling ``harness.run``."""
    try:
        from montecarlo_risk_engine_tpu_torch import tracing
    except ImportError:  # a port without spans
        return None
    c = _harness_controller()
    if c is None or record.trace is None or not record.walls:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = c.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        x = torch.rand(1024, device=c.device)
        stamps(torch, x, 1)  # the first launch loads the stamp kernel
    traffic = record.cell.traffic
    n = max(1, min(int(traffic.get("trace_runs", 1 << 30)), len(record.walls)) // 10)
    differentiated = bool(traffic["differentiate"])
    profiled = profile(activities=[ProfilerActivity.CUDA]) if on_card else contextlib.nullcontext()
    tracing.take()
    tracing.enable()
    try:
        with profiled as prof:
            before = stamps(torch, x) if on_card else []
            lo = time.time_ns()
            for _ in range(n):
                c.root_seed = (c.root_seed + 1) & harness.SEED_MASK
                result = c.run_simulation()
                sync()
                if not harness.finite(book.read_results(result, c.root_seed, differentiated)):
                    raise RuntimeError(f"riskbench: span pass run with seed {c.root_seed} "
                                       "returned a non-finite value")
            hi = time.time_ns()
            after = stamps(torch, x) if on_card else []
        spans = tracing.take()
    finally:
        tracing.disable()
    del c, profiled
    device = device_intervals_ns(prof) if prof is not None else []
    del prof
    if on_card:
        device = calibrated(device, before, after)
    summary = summarize(spans, device, lo, hi)
    if summary.runs == 0:
        harness.log("[spans] the span pass recorded no run span")
        return None
    log_summary(summary, record.window_s / len(record.walls))
    return summary


_last: list = [None, None]  # [record, summary] of the last pass


def of(record) -> Optional[SpanSummary]:
    """The span pass of ``record``, run at the first reader's call."""
    if _last[0] is not record:
        _last[0], _last[1] = record, None
        _last[1] = run_pass(record)
    return _last[1]


def per_run_ms(seconds: float, s: SpanSummary) -> float:
    return 1e3 * seconds / s.runs
