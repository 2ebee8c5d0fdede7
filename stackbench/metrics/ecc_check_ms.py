"""``ecc_check_ms``: host ms a call blocked in the ``ecc.check`` spans
under ``ecc full-res solve`` (the host's read of whether any lane is
still active, which waits for the sweeps enqueued before it), summed
over a call's checks and averaged over the traced window's calls."""

from stackbench.metrics import _ecc_spans as E


def _checks(kids, st):
    checks = E.named(kids, "ecc.check")
    return sum(s[2] for s in checks) if checks else None


def read(ctx):
    return E.mean_over_calls(ctx, _checks)
