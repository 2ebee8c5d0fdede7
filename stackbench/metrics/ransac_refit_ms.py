"""``ransac_refit_ms``: device ms a call of the ``ransac.refit`` span
(RANSAC's inliers, the least-squares DLT, the Gauss-Newton polish and
the final mask, under ``match+ransac``), averaged over the traced
window's calls; None off CUDA."""

from stackbench.metrics import _kp_spans as K


def read(ctx):
    return K.summed(ctx, "ransac.refit", K.DEVICE)
