"""k1_roofline_pct: the share of its roofline that the Heston QE path
kernel K1 reaches over the traced window: the least time of every launch
the runs make (the larger of its bytes over 3.35 TB/s and its operations
over 67 TFLOP/s, counted from the launch's shapes by
riskbench/counting_k1.py) summed, over the measured time of those launches
summed.  Nothing when the launches in the trace are not the launches the
runs make."""

from riskbench import counting_k1, trace


def read(record):
    t = record.trace
    if t is None or t.runs == 0:
        return None
    launches = counting_k1.launches(record.cell.config, record.cell.traffic)
    measured = trace.kernel_seconds(t.device_events, ("heston_qe_kernel",))
    if not launches or len(measured) != t.runs * len(launches) or sum(measured) <= 0:
        return None
    least = t.runs * sum(counting_k1.least_seconds(launch)[0] for launch in launches)
    return 100.0 * least / sum(measured)
