"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, reset at
its start, in GiB: the cell's resident inputs and what the calls hold."""


def read(r):
    if r.peak_window_bytes is None:
        return None
    return r.peak_window_bytes / 2 ** 30
