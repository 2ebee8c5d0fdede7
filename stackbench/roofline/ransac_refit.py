"""RANSAC's refit kernels (``csrc/ransac_refit.cu``): the DLT
(``ransac_dlt_kernel``, one launch a call) and the Gauss-Newton polish
(``ransac_refine_kernel``, one launch of ``STEPS`` steps a call), a
block a frame over ``SLOTS`` correspondence slots, in float64.

Counted off the kernel source, per slot: the DLT's two weighted rows (14
multiplies) and the 45 Gram entries (2 multiplies and 2 adds each), 194;
a polish step's projection and its reciprocal (15), Jacobian rows (22),
residuals (4), the 36 J^T J and 8 J^T r entries (4 each) and both
weighted errors (21 each), 259.
The Jacobi sweeps and the 8x8 solves are one thread's serial work a
frame and depend on the data: not counted, which can only lower the
share.  Bytes: each slot's two float32 points and weight (20) read once,
each frame's matrices (36 out, 36 more in for the polish).  Rates: the
H100 SXM's HBM bandwidth and its float64 rate outside the tensor cores,
34 TFLOP/s (NVIDIA's H100 data sheet, 700 W)."""

from stackbench.roofline import peaks

DLT_KERNEL = "ransac_dlt_kernel"
REFINE_KERNEL = "ransac_refine_kernel"
# ORB's 500 features over its 8 levels: frame 0's keypoint slots, which
# every frame's correspondences are padded to
SLOTS = 500
STEPS = 10
PEAK_F64_S = 34e12
OPS_SLOT_DLT = 14 + 45 * 4
OPS_SLOT_STEP = 15 + 22 + 4 + (36 + 8) * 4 + 2 * 21
BYTES_SLOT = 2 * 8 + 4


def _bound(nbytes: float, ops: float) -> float:
    return max(nbytes / peaks.PEAK_BYTES_S, ops / PEAK_F64_S)


def dlt_bound_s(frames: int, slots: int = SLOTS) -> float:
    """The least seconds of the DLT launch of a ``frames``-frame burst
    (frames 1..N-1 are its blocks)."""
    lanes = frames - 1
    return _bound(lanes * (slots * BYTES_SLOT + 36.0),
                  lanes * slots * float(OPS_SLOT_DLT))


def refine_bound_s(frames: int, slots: int = SLOTS,
                   steps: int = STEPS) -> float:
    """The least seconds of the polish launch of a ``frames``-frame
    burst."""
    lanes = frames - 1
    return _bound(lanes * (slots * BYTES_SLOT + 72.0),
                  lanes * slots * steps * float(OPS_SLOT_STEP))
