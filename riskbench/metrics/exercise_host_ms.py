"""exercise_host_ms: host milliseconds per risk run inside ``exercise``
spans (the exercise scans' loops over their dates), from the span pass of
a traced run (riskbench/spans.py).  Nothing where no run opens an
``exercise`` span."""

from riskbench import spans


def read(record):
    s = spans.of(record)
    if s is None or "exercise" not in s.self_s:
        return None
    return spans.per_run_ms(s.self_s["exercise"], s)
