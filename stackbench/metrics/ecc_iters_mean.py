"""``ecc_iters_mean``: the mean over the traced window's calls of each
call's mean ECC iterations per frame (``PipelineStats.ecc_iterations``,
a count)."""


def read(ctx):
    vals = [sum(c["stats"].ecc_iterations) / len(c["stats"].ecc_iterations)
            for c in ctx.calls
            if c["stats"] is not None and c["stats"].ecc_iterations]
    return sum(vals) / len(vals) if vals else None
