"""``ecc_sweep_ms``: device ms of one ``ecc.sweep`` span under ``ecc
full-res solve`` (the stream time between its two CUDA events), the
mean over every sweep of the traced window's calls; None off CUDA."""

from stackbench.metrics import _ecc_spans as E


def read(ctx):
    return E.pooled_mean(ctx, "ecc.sweep", 3)
