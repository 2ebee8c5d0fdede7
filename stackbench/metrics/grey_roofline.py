"""``grey_roofline``: the ECC path's grey kernel's share of its roofline,
in %: the least time of the float32 grey of a call's stacked frames
(``stackbench/roofline/grey.py``) over the device time of one
``grey_f32_kernel`` launch by name in the trace (one a call; the ranked
loop's own uint8 greys are not counted).  The launches are counted in
the trace, not taken from the profiled calls: the tracer can lose the
first operation of its window, and in the mean cell that is this
kernel.  None where the trace holds none (a port without the kernel)."""

from stackbench.roofline import grey


def read(ctx):
    times = [d for name, _, d in ctx.events if grey.KERNEL in name]
    dev_s = sum(times) / 1e6
    if dev_s <= 0 or not ctx.calls:
        return None
    h, w = ctx.hw
    frames = [c["stacked"] for c in ctx.calls]
    per_call = sum(grey.bound_s(n, h, w)[0] for n in frames) / len(frames)
    return 100.0 * per_call * len(times) / dev_s
