"""Shared arithmetic of the refit kernels' roofline readers: a kernel's
least time over the profiled calls (``stackbench/roofline/ransac_refit.py``,
from each call's burst depth) over its device time by name in the trace,
in %; None where the trace holds no such kernel."""


def share(ctx, kernel, bound_s):
    dev_s = sum(d for name, _, d in ctx.events if kernel in name) / 1e6
    if dev_s <= 0 or ctx.profiled_calls <= 0:
        return None
    frames = [c["frames"] for c in ctx.calls]
    per_call = sum(bound_s(n) for n in frames) / len(frames)
    return 100.0 * per_call * ctx.profiled_calls / dev_s
