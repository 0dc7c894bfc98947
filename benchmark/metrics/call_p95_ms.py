"""call_p95_ms: the 95th percentile (nearest rank) over all calls of the
window of each call's time on the host clock, from its start to the end of
the synchronize after it."""

from harness.stats import percentile


def read(r):
    if not r.window.calls:
        return None
    return percentile([c[2] for c in r.window.calls], 95) * 1e3
