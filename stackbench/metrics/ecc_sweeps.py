"""``ecc_sweeps``: the mean over the traced window's calls of the
``ecc.sweep`` spans under ``ecc full-res solve``: the Gauss-Newton
sweeps (one B1 launch and its eager update over every lane) a burst's
solve ran, a count."""

from stackbench.metrics import _ecc_spans as E


def read(ctx):
    return E.mean_over_calls(
        ctx, lambda kids, st: len(E.named(kids, "ecc.sweep")) or None)
