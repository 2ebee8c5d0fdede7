"""``ecc_lane_util_pct``: the share of the full-resolution solve's
lane-sweeps that did work, in %: 100 x the lanes' iterations
(``PipelineStats.ecc_iterations``, summed) over ``ecc.sweep`` spans x
lanes, a call's, averaged over the traced window's calls."""

from stackbench.metrics import _ecc_spans as E


def _util(kids, st):
    sweeps = len(E.named(kids, "ecc.sweep"))
    iters = st.ecc_iterations
    if not sweeps or not iters:
        return None
    return 100.0 * sum(iters) / (sweeps * len(iters))


def read(ctx):
    return E.mean_over_calls(ctx, _util)
