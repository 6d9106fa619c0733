"""paths_idle_ms: milliseconds per risk run that the card sat idle while
the innermost open span was path generation (``paths``, ``kernel_noise``,
``stream`` itself: the engine, the path kernel's route, the noise
recovery), from the span pass of a traced run (riskbench/spans.py)."""

from riskbench import spans


def read(record):
    s = spans.of(record)
    return None if s is None else spans.per_run_ms(spans.layer_idle_s(s, "paths"), s)
