"""exercise_idle_ms: milliseconds per risk run that the card sat idle while
the innermost open span was ``exercise`` (one loop of an exercise scan:
the LSM fit or the valuation of Americans, FlexiCalls and storage deals),
from the span pass of a traced run (riskbench/spans.py).  Nothing where no
run opens an ``exercise`` span."""

from riskbench import spans


def read(record):
    s = spans.of(record)
    if s is None or "exercise" not in s.self_s:
        return None
    return spans.per_run_ms(s.idle_s.get("exercise", 0.0), s)
