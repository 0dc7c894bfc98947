"""host_syncs: the program's blocking copies onto the card a call, its own
counter (``xrft_tpu_torch.telemetry``: each copy of a host array through
``to_device``, after which PyTorch synchronizes the stream and the card
idles until the host launches again) over its count of outermost calls,
read at the end of the run where that count equals the calls the harness
made (``harness/spans.run_counters``)."""

from harness.spans import run_counters


def read(r):
    c = run_counters(r)
    if c is None or not c["calls"]:
        return None
    return c["host_syncs"] / c["calls"]
