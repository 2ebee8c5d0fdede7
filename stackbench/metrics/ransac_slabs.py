"""``ransac_slabs``: the mean over the traced window's calls of
``PipelineStats.ransac_slabs``, the slabs of 128 hypotheses a call's
RANSAC loop ran (a count); None where the program does not count
them."""


def read(ctx):
    vals = [getattr(c["stats"], "ransac_slabs", None) for c in ctx.calls
            if c["stats"] is not None]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
