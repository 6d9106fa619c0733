"""k1_ms: milliseconds per risk run that the card spent in the Heston QE
path kernel K1 (forward or noise-emitting) in the traced window."""

from riskbench import trace

K1_KERNELS = ("heston_qe_kernel",)


def read(record):
    t = record.trace
    if t is None or t.runs == 0:
        return None
    secs = trace.kernel_seconds(t.device_events, K1_KERNELS)
    return 1e3 * sum(secs) / t.runs if secs else None
