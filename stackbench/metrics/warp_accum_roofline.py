"""``warp_accum_roofline``: B2's share of its roofline, in %: the least
time of its launches (``stackbench/roofline/warp_accum.py``, from each
profiled call's burst shape) over their device time by name in the
trace."""

from stackbench.roofline import warp_accum


def read(ctx):
    dev_s = sum(d for name, _, d in ctx.events
                if warp_accum.KERNEL in name) / 1e6
    if dev_s <= 0 or ctx.profiled_calls <= 0:
        return None
    h, w = ctx.hw
    stacked = [c["stacked"] for c in ctx.calls]
    per_call = sum(warp_accum.bound_s(n, h, w)[0] for n in stacked) / len(stacked)
    return 100.0 * per_call * ctx.profiled_calls / dev_s
