"""device_idle_share: 1 - (union of the device operations' intervals) / (the
stretch's length on the host clock), in %, over a stretch of back-to-back
calls in the window's loop, traced with device activity alone (no Python
tracer to slow the host)."""


def read(r):
    t = r.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
