"""controller_idle_ms: milliseconds per risk run that the card sat idle
while the innermost open span of the port was one of the controller's
(``run`` itself, ``plan``, ``jacobian``, ``sweep``, ``hessian_row``,
``results``), from the span pass of a traced run (riskbench/spans.py)."""

from riskbench import spans


def read(record):
    s = spans.of(record)
    return None if s is None else spans.per_run_ms(spans.layer_idle_s(s, "controller"), s)
