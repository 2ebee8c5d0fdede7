"""``ransac_check_ms``: host ms a call blocked in the ``ransac.check``
spans (the host's read, once after each slab, of whether RANSAC's
lanes are still active, which waits for the work enqueued before it),
summed over the call's reads and averaged over the traced window's
calls."""

from stackbench.metrics import _kp_spans as K


def read(ctx):
    return K.summed(ctx, "ransac.check", K.HOST)
