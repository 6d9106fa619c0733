"""run_p95_s: the 95th percentile of the window's per-run walls (host
clock), Python's exclusive quantile method; nothing with fewer than 20
runs."""

import statistics


def read(record):
    if len(record.walls) < 20:
        return None
    return statistics.quantiles(record.walls, n=20)[18]
