"""``device_idle_pct``: the share of the profiled span (the traced
calls, first start to last end, host clock of the trace) in which no
operation ran on the card, from the union of the device intervals
(``stackbench/trace.py``)."""


def read(ctx):
    if ctx.window_us <= 0 or not ctx.events:
        return None
    return 100.0 * (1.0 - ctx.busy_us / ctx.window_us)
