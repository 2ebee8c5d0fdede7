"""``ecc_sweep_host_ms``: host ms to enqueue one ``ecc.sweep`` under
``ecc full-res solve`` (its span's ``time.perf_counter`` duration; a
sweep never synchronises), the mean over every sweep of the traced
window's calls."""

from stackbench.metrics import _ecc_spans as E


def read(ctx):
    return E.pooled_mean(ctx, "ecc.sweep", 2)
