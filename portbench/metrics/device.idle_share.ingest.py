"""Share of a capture in the ingest window in which no operation ran on
the card, %: 1 − the union of the device intervals of the manager's
profile ÷ the capture's length."""

from portbench import harness


def read(ctx):
    if ctx.trace_doc is None:
        return None
    lo, hi = ctx.trace_span
    busy = harness.busy_us(harness.trace_device_events(ctx.trace_doc),
                           lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
