"""Reduce profiler traces of a traced run to what the per-layer metrics read.

A traced run profiles twice.  Over the measured window the profiler records
the card's activity alone (kernels, copies, sets), so the host runs at the
pace it runs untraced; the card is idle before the window's first run and
after its last (each run ends in a sync), so every device interval of that
trace lies in the window, whose length is the host clock's.  Device busy
time is the length of the union of those intervals, so overlapping kernels
on two streams count once and copies count; the rest of the window is
idle.  Then a few more runs are profiled with the host's torch operations
as well, each run inside a ``riskbench.run`` range: there each idle gap of
the card is named by the innermost host operation open at its middle.
Recording host operations slows the host, so those runs name the gaps and
are not timed.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

RUN_RANGE = "riskbench.run"
NO_HOST_OP = "host: no torch op (Python)"
NAME_CHARS = 160


class Event(NamedTuple):
    name: str
    start: float  # seconds
    end: float
    thread: int = 0


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    runs: int
    device_events: List[Event]  # inside the window
    device_ops: List[Tuple[str, float]]  # seconds by name, largest first
    idle_gaps: List[Tuple[str, float]]  # idle seconds by host op, largest first


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Sequence[Tuple[float, float]], lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no busy interval covers."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost_ops(host: Sequence[Event], points: Sequence[float]) -> List[Optional[str]]:
    """For each time point, the innermost host operation open there (the
    latest-started among the threads' innermost), or None.  Host ops of
    one thread nest, so a sweep with one stack per thread finds them."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    events = sorted(host, key=lambda e: (e.start, -e.end))
    stacks: Dict[int, List[Event]] = defaultdict(list)
    out: List[Optional[str]] = [None] * len(points)
    j = 0
    for i in order:
        t = points[i]
        while j < len(events) and events[j].start <= t:
            ev = events[j]
            st = stacks[ev.thread]
            while st and st[-1].end < ev.start:
                st.pop()
            st.append(ev)
            j += 1
        best = None
        for st in stacks.values():
            while st and st[-1].end < t:
                st.pop()
            if st and (best is None or st[-1].start > best.start):
                best = st[-1]
        out[i] = None if best is None else best.name
    return out


def ranked(seconds: Dict[str, float], top: int) -> List[Tuple[str, float]]:
    return sorted(seconds.items(), key=lambda kv: -kv[1])[:top]


def device_summary(device: Sequence[Event], window_s: float, runs: int,
                   idle_gaps: Sequence[Tuple[str, float]] = (), top: int = 10) -> TraceSummary:
    """The measured window's busy time and the device ops that took most of
    it, from a trace of the card alone over ``runs`` runs that took
    ``window_s`` seconds on the host clock; ``idle_gaps`` come from
    :func:`summarize` of the runs traced with the host."""
    busy_s = sum(e - s for s, e in merge((e.start, e.end) for e in device))
    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name[:NAME_CHARS]] += e.end - e.start
    return TraceSummary(window_s, busy_s, runs, list(device), ranked(by_name, top),
                        list(idle_gaps)[:top])


def span(events: Sequence[Event]) -> float:
    """From the first event's start to the last one's end (0 for none)."""
    return max(e.end for e in events) - min(e.start for e in events) if events else 0.0


def summarize(device: Sequence[Event], host: Sequence[Event], top: int = 10) -> TraceSummary:
    """The busy and idle time of the runs traced with the host, from the
    start of the first ``riskbench.run`` range to the end of the last, the
    device ops that took most time and the idle gaps by what the host was
    doing."""
    runs = [e for e in host if e.name == RUN_RANGE]
    if not runs:
        raise ValueError("the trace holds no riskbench.run range")
    lo, hi = min(e.start for e in runs), max(e.end for e in runs)
    inside = [e for e in device if e.end > lo and e.start < hi]
    busy = merge(clip([(e.start, e.end) for e in inside], lo, hi))
    busy_s = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for e in inside:
        by_name[e.name[:NAME_CHARS]] += min(e.end, hi) - max(e.start, lo)
    host_ops = [e for e in host if e.name != RUN_RANGE]
    idle = gaps(busy, lo, hi)
    names = innermost_ops(host_ops, [(s + e) / 2 for s, e in idle])
    by_host: Dict[str, float] = defaultdict(float)
    for (s, e), name in zip(idle, names):
        by_host[(name or NO_HOST_OP)[:NAME_CHARS]] += e - s
    return TraceSummary(hi - lo, busy_s, len(runs), inside, ranked(by_name, top),
                        ranked(by_host, top))


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")()) * 1000


def from_profiler(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host events) of a finished ``torch.profiler`` run,
    in seconds of the profiler's clock from its first event (whole
    nanoseconds are rebased before they become floats)."""
    events = list(prof.profiler.kineto_results.events())
    base = min((_ns(ev, "start") for ev in events), default=0)
    device, host = [], []
    for ev in events:
        start = (_ns(ev, "start") - base) * 1e-9
        dur = _ns(ev, "duration") * 1e-9
        dev_type = str(ev.device_type())
        rec = Event(ev.name(), start, start + dur,
                    int(ev.start_thread_id()) if hasattr(ev, "start_thread_id") else 0)
        annotation = rec.name == RUN_RANGE or (
            hasattr(ev, "is_user_annotation") and ev.is_user_annotation())
        if dev_type.endswith("CUDA"):
            if not annotation:  # a range's shadow on the device timeline is no work
                device.append(rec)
        elif dev_type.endswith("CPU"):
            host.append(rec)
    return device, host


def is_kernel(name: str) -> bool:
    """A kernel, not a copy or a set."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def kernel_seconds(events: Sequence[Event], needles: Sequence[str]) -> List[float]:
    """Durations of the device events whose name contains one of ``needles``,
    in trace order."""
    return [e.end - e.start for e in sorted(events, key=lambda e: e.start)
            if any(n in e.name for n in needles)]


def count(events: Sequence[Event], pred) -> int:
    return sum(1 for e in events if pred(e.name))
