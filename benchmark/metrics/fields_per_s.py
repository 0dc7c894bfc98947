"""fields_per_s: the fields that all completed calls of the window
processed, over the window's seconds (host clock)."""


def read(r):
    if not r.window.calls or r.window.seconds <= 0:
        return None
    return sum(c[0] for c in r.window.calls) / r.window.seconds
