"""run_s: the window's wall time over its risk runs (host clock), from the
start of the first run to the end of the last, each run ending in a sync."""


def read(record):
    return record.window_s / len(record.walls) if record.walls else None
