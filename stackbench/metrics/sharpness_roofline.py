"""``sharpness_roofline``: the one-pass sharpness kernel's share of its
roofline, in %: the least time of one ``sharpness_all`` on each profiled
call's burst (``stackbench/roofline/sharpness.py``) over the device time
of its two kernels by name in the trace; None where the trace holds
neither (a port without the kernel)."""

from stackbench.roofline import sharpness


def read(ctx):
    dev_s = sum(d for name, _, d in ctx.events
                if any(k in name for k in sharpness.KERNELS)) / 1e6
    if dev_s <= 0 or ctx.profiled_calls <= 0:
        return None
    h, w = ctx.hw
    frames = [c["frames"] for c in ctx.calls]
    per_call = sum(sharpness.bound_s(n, h, w)[0] for n in frames) / len(frames)
    return 100.0 * per_call * ctx.profiled_calls / dev_s
