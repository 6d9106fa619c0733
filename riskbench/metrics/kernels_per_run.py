"""kernels_per_run: kernels launched on the card per risk run in the
traced window (copies and sets left out)."""

from riskbench import trace


def read(record):
    t = record.trace
    if t is None or t.runs == 0 or not t.device_events:
        return None
    return trace.count(t.device_events, trace.is_kernel) / t.runs
