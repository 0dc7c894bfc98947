"""call_roofline: the call's least time (its input read once and output
written once at HBM bandwidth, or its FFT operations at the dtype's peak,
whichever is longer) over its mean wall time in the timing stretch (traced
with device activity alone), in %."""


def read(r):
    t = r.trace
    least = r.least_seconds("call")
    if t is None or least is None or t.busy_s <= 0:
        return None
    return 100.0 * least / t.call_wall_s
