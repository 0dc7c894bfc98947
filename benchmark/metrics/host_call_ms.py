"""host_call_ms: the benchmark's own span of each call, host time from the
call's entry to its return, before the synchronize, as a mean over the
calls of the traced run's window (not the profiled stretch, whose Python
tracer inflates host time)."""


def read(r):
    if not r.window.calls:
        return None
    return sum(c[1] for c in r.window.calls) / len(r.window.calls) * 1e3
