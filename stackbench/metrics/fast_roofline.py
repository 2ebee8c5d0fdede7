"""``fast_roofline``: B8's share of its roofline, in %: the least time
over every pyramid level of the profiled calls' frames
(``stackbench/roofline/fast.py``) over its device time by name in the
trace.  Detection runs on the full frame unless the traffic scales it."""

from stackbench.roofline import fast
from stackbench.reference import _plain


def read(ctx):
    dev_s = sum(d for name, _, d in ctx.events if fast.KERNEL in name) / 1e6
    if dev_s <= 0 or ctx.profiled_calls <= 0:
        return None
    h, w = ctx.hw
    sdw = ctx.traffic.get("scale_down_width")
    if sdw:
        h, w = _plain.scaled_size(h, w, sdw)
    frames = [c["frames"] for c in ctx.calls]
    per_call = sum(fast.bound_s(n, h, w)[0] for n in frames) / len(frames)
    return 100.0 * per_call * ctx.profiled_calls / dev_s
