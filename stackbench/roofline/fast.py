"""Kernel B8 (``csrc/fast.cu`` ``fast_kernel``): FAST-9 scores with the
3x3 maximum test on every pixel of every pyramid level of every frame.
Frozen from ``chip_smoke.py:319-320`` and ``:1108`` (bytes: the u8
level read once and the float32 score written once, 5 a pixel;
operations: 16 differences, the 4-point compass test and the NMS max
and compare, 33 a pixel).  The candidates' arc trees (``B8_OPS_CANDIDATE``
per pixel that passes the compass test) depend on the content and are
not counted: the bound is the bytes' by a wide margin at these sizes
(``PERF.md``), and leaving them out can only lower the share."""

from stackbench.roofline import peaks

KERNEL = "fast_kernel"
OPS_PIXEL = 16 + 8 + 9


def level_sizes(h: int, w: int, nlevels: int = 8, scale_factor: float = 1.2):
    """OpenCV ORB's pyramid: level l is ``round(h / 1.2^l)`` x
    ``round(w / 1.2^l)``."""
    out = []
    for lvl in range(nlevels):
        s = scale_factor ** lvl
        out.append((int(round(h / s)), int(round(w / s))))
    return out


def bound_s(frames: int, h: int, w: int, nlevels: int = 8,
            scale_factor: float = 1.2):
    """The least seconds of B8 over every level of ``frames`` frames."""
    px = sum(lh * lw for lh, lw in level_sizes(h, w, nlevels, scale_factor))
    return peaks.bound_s(frames * px * 5.0, frames * px * float(OPS_PIXEL))
