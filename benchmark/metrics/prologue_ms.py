"""prologue_ms: device ms per call of the operations attributed to the
prologue layer (detrend.py, ops/window.py)."""


def read(r):
    if r.trace is None:
        return None
    ms = r.trace.layer_ms_per_call("prologue")
    return ms if ms > 0 else None
