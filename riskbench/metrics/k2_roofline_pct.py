"""k2_roofline_pct: the share of its roofline that K2's paths kernel
reaches over the traced window: the least time of every launch (the larger
of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s, counted
from the launch's shapes and blocks by riskbench/counting.py) summed, over
the measured time of those launches summed.  Nothing when the launches in
the trace are not the launches the runs make."""

from riskbench import counting, trace


def read(record):
    t = record.trace
    if t is None or t.runs == 0 or not record.launches:
        return None
    measured = trace.kernel_seconds(t.device_events, ("hybrid_kernel",))
    if len(measured) != t.runs * len(record.launches) or sum(measured) <= 0:
        return None
    least = t.runs * sum(counting.least_seconds(launch)[0] for launch in record.launches)
    return 100.0 * least / sum(measured)
