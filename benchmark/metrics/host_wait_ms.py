"""host_wait_ms: the host's ms a call inside the program's blocking copies
onto the card (``xrft_tpu_torch.telemetry``'s ``host_wait_ns``, timed
around each ``to_device``), waiting for the card to run what was queued
before; read as ``host_syncs`` is (``harness/spans.run_counters``)."""

from harness.spans import run_counters


def read(r):
    c = run_counters(r)
    if c is None or not c["calls"]:
        return None
    return c["host_wait_ns"] / c["calls"] / 1e6
