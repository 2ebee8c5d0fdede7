"""``ecc_prep_ms``: device ms a call of the ``ecc.prep`` span under
``ecc full-res solve`` (the input fields, the template blur, the texel
pack and the carry: the stream time between its two CUDA events),
averaged over the traced window's calls; None off CUDA."""

from stackbench.metrics import _ecc_spans as E


def _prep(kids, st):
    devs = [s[3] for s in E.named(kids, "ecc.prep") if s[3] is not None]
    return sum(devs) if devs else None


def read(ctx):
    return E.mean_over_calls(ctx, _prep)
