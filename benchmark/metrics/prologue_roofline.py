"""prologue_roofline: the input read once in its dtype plus the detrended,
windowed field written once in the dtype the FFT takes, at HBM bandwidth,
over the prologue's device time per call, in %."""


def read(r):
    least = r.least_seconds("prologue")
    if r.trace is None or least is None:
        return None
    ms = r.trace.layer_ms_per_call("prologue")
    return 100.0 * least * 1e3 / ms if ms > 0 else None
