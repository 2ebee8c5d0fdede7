"""Shared arithmetic of the ECC solve's span readers: each call's spans
whose parent is the ``ecc full-res solve`` phase
(``PipelineStats.spans``, ``(name, parent, host_ms, device_ms)``), and
the mean over the traced window's calls of a number read from them, or
over all their spans of one name.
A program that records no spans (``PipelineStats`` without ``spans``)
gives None: nothing to read."""

SOLVE = "ecc full-res solve"


def solve_spans(stats):
    """The call's spans under the full-resolution solve, or None."""
    spans = getattr(stats, "spans", None) if stats is not None else None
    if not spans:
        return None
    kids = [s for s in spans if s[1] == SOLVE]
    return kids or None


def mean_over_calls(ctx, per_call):
    """The mean of ``per_call(spans, stats)`` over the calls that have
    solve spans and for which it is not None, or None."""
    vals = []
    for c in ctx.calls:
        kids = solve_spans(c["stats"])
        if kids is None:
            continue
        v = per_call(kids, c["stats"])
        if v is not None:
            vals.append(v)
    return mean(vals)


def pooled_mean(ctx, name, field):
    """The mean of ``field`` (2: host ms, 3: device ms) over every span
    ``name`` under the solve in the traced window's calls (spans whose
    field is None left out), or None.  Pooled over spans rather than
    averaged per call, so that ``ecc_sweeps`` x ``ecc_sweep_ms`` is the
    mean device time of a call's sweeps even where calls ran different
    numbers of them."""
    vals = []
    for c in ctx.calls:
        kids = solve_spans(c["stats"]) or []
        vals += [s[field] for s in named(kids, name) if s[field] is not None]
    return mean(vals)


def named(kids, name):
    return [s for s in kids if s[0] == name]


def mean(vals):
    return sum(vals) / len(vals) if vals else None
