"""The one-pass sharpness kernel (``csrc/sharpness.cu``:
``sharpness_kernel``, then ``sharpness_finalize``, one launch each a
``sharpness_all``) on a burst's u8 grey, TENG at ksize 3.

Counted off the kernel source.  Bytes: each pixel read once (1 B), and
the ``[N, slots, 6]`` float64 partials written once and read once, with
``slots`` the kernel's launch geometry (``geometry``: strips of 768
columns by row segments of the interior, then the rim's blocks of 192
pixels).  Operations a pixel, the interior's: the W passes (hm 3, hs 2
sharing hm's doubled tap, the first difference 1), the H passes (LAPM's
two 3, the Sobel pair 3 and 1), LAPM's abs sum, scale and sum (3),
LAPV's sum, its square and sum (4 with the -lap add), TENG's two squares,
their add and sum (4), GLVN's sum, square and sum (3): 30.  The index
arithmetic, the conversions and the float64 widening of the row
partials are not counted, and the float64 adds go at the float32 rate:
the share can only be under-stated."""

from stackbench.roofline import peaks

KERNELS = ("sharpness_kernel", "sharpness_finalize")
OPS_PIXEL = 6 + 10 + 3 + 4 + 4 + 3
STRIP, THREADS, MIN_ROWS, TARGET_BLOCKS = 768, 192, 32, 2048


def slots(frames: int, h: int, w: int, r: int = 1) -> int:
    """The kernel's blocks a frame: interior strip segments, then the
    rim's (``csrc/sharpness.cu`` ``geometry``)."""
    hi, wi = h - 2 * r, w - 2 * r
    strips = -(-w // STRIP)
    if hi <= 0 or wi <= 0:
        return -(-(h * w) // THREADS)
    segs = -(-TARGET_BLOCKS // (frames * strips))
    segs = max(1, min(segs, max(1, hi // MIN_ROWS)))
    rows = -(-hi // segs)
    interior = strips * -(-hi // rows)
    return interior + -(-(h * w - hi * wi) // THREADS)


def bound_s(frames: int, h: int, w: int):
    """``(seconds, 'bytes' | 'operations')``: the least time of one
    ``sharpness_all`` on ``frames`` u8 frames of ``h`` x ``w``."""
    nbytes = frames * h * w + frames * slots(frames, h, w) * 6 * 8 * 2
    return peaks.bound_s(float(nbytes), float(frames * h * w * OPS_PIXEL))
