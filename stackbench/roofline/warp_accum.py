"""Kernel B2 (``csrc/warp_accum.cu`` ``warp_accum_kernel``): the fused
warp and sum of a burst's frames 1..N-1 onto frame 0's grid, one launch
a burst.  Frozen from ``chip_smoke.py:316-317`` (operations a
pixel-frame, counted off the kernel: coordinates ~15, the 1/32
quantisation ~12, 8 for the taps' addresses and weights, bilinear taps
~10 a channel, the u8 widening 4 and the sum 2 a channel) and
``:954-955`` (bytes: each u8 RGB input byte read once, the float32 RGB
sum written once, 40 bytes of map and flag a frame)."""

from stackbench.roofline import peaks

KERNEL = "warp_accum_kernel"
OPS_PIXEL_FRAME = 15 + 12 + 8 + 3 * 10 + 3 * 4 + 3 * 2


def bound_s(frames: int, h: int, w: int):
    """The least seconds of one launch over ``frames`` frames of
    ``h`` x ``w`` (frame 0 included, which the launch does not warp)."""
    hw = h * w
    nbytes = (frames - 1) * hw * 3.0 + hw * 3 * 4.0 + frames * 40.0
    ops = float(frames - 1) * hw * OPS_PIXEL_FRAME
    return peaks.bound_s(nbytes, ops)
