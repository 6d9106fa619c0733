"""device_idle_pct: 100 x (1 - the union of the card's kernel, copy and
set intervals over the traced window / the window)."""


def read(record):
    t = record.trace
    if t is None or t.window_s <= 0 or not t.device_events:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
