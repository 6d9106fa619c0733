"""valuation_host_ms: host milliseconds per risk run inside the union of
the valuation spans (``resolve``, ``evaluate``, ``fit``, ``value``,
``netting``, ``fold``, ``assemble``), from the span pass of a traced run
(riskbench/spans.py)."""

from riskbench import spans


def read(record):
    s = spans.of(record)
    return None if s is None else spans.per_run_ms(s.valuation_host_s, s)
