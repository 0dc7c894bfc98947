"""k1_roofline: the one-sided spectrum read once plus the two-sided spectrum
written once, at HBM bandwidth, over the device time per call of K1, the
fused epilogue (ops/mirror.py, csrc/mirror.cu), in %.  K1 is launched
through ctypes; where its launch carries no Python stack, its kernel name
places it."""

KERNEL_LAYERS = {"mirror_pairs_kernel": "epilogue"}


def read(r):
    least = r.least_seconds("epilogue")
    if r.trace is None or least is None:
        return None
    ms = r.trace.layer_ms_per_call("epilogue")
    return 100.0 * least * 1e3 / ms if ms > 0 else None
