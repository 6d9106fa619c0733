"""host_wait_ms: host milliseconds per risk run inside the port's
``to_host`` spans, the copies of the results to the host: how long the
host waits for the card, from the span pass of a traced run
(riskbench/spans.py)."""

from riskbench import spans


def read(record):
    s = spans.of(record)
    return None if s is None else spans.per_run_ms(s.to_host_s, s)
