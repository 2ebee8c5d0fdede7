"""``ransac_dlt_roofline``: the DLT kernel's share of its roofline, in %
(``stackbench/roofline/ransac_refit.py``): one launch a call, a block a
frame; latency-bound, so the share is small."""

from stackbench.metrics import _refit_roofline
from stackbench.roofline import ransac_refit as R


def read(ctx):
    return _refit_roofline.share(ctx, R.DLT_KERNEL, R.dlt_bound_s)
