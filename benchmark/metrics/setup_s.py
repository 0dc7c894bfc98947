"""setup_s: from the harness's first line to the first measured call: the
imports, the CUDA context, loading (or building) the kernels the cell's
path uses, making the data and the warm-up calls."""


def read(r):
    return r.setup_s
