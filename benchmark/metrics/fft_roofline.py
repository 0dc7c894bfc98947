"""fft_roofline: the transform's least time (its input read once and its
output written once, or its 2.5 N log2 N operations of a real transform,
whichever is longer) over the device time per call of the operations
attributed to ops/fft_core.py, in %."""


def read(r):
    least = r.least_seconds("fft")
    if r.trace is None or least is None:
        return None
    ms = r.trace.layer_ms_per_call("fft")
    return 100.0 * least * 1e3 / ms if ms > 0 else None
