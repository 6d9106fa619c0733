"""valuation_idle_ms: milliseconds per risk run that the card sat idle
while the innermost open span was valuation (``resolve``, ``evaluate``,
``fit``, ``value``, ``netting``, ``fold``, ``assemble``: requests,
batching, products, metrics, regression), from the span pass of a traced
run (riskbench/spans.py)."""

from riskbench import spans


def read(record):
    s = spans.of(record)
    return None if s is None else spans.per_run_ms(spans.layer_idle_s(s, "valuation"), s)
