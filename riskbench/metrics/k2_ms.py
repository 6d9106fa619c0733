"""k2_ms: milliseconds per risk run that the card spent in the path kernel
K2 (its paths kernel and its table prologue) in the traced window."""

from riskbench import trace

K2_KERNELS = ("hybrid_kernel", "table_kernel")


def read(record):
    t = record.trace
    if t is None or t.runs == 0:
        return None
    secs = trace.kernel_seconds(t.device_events, K2_KERNELS)
    return 1e3 * sum(secs) / t.runs if secs else None
