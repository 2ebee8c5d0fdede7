"""The burst grey kernel on the ECC path (``csrc/grey.cu``:
``grey_f32_kernel``, one launch a burst): uint8 RGB in, the fixed-point
Rec.601 grey out as float32.

Counted off the kernel source.  Bytes: each RGB pixel read once (3 B)
and its grey written once (4 B).  Operations a pixel: three multiplies,
three adds and a shift (7), counted at the float32 rate; the bytes bound
it by far."""

from stackbench.roofline import peaks

KERNEL = "grey_f32_kernel"
IN_BYTES, OUT_BYTES, OPS_PIXEL = 3, 4, 7


def bound_s(frames: int, h: int, w: int):
    """``(seconds, 'bytes' | 'operations')``: the least time of one
    float32 grey of ``frames`` uint8 RGB frames of ``h`` x ``w``."""
    px = float(frames * h * w)
    return peaks.bound_s(px * (IN_BYTES + OUT_BYTES), px * OPS_PIXEL)
