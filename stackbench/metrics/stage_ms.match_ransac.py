"""``stage_ms.match_ransac``: mean ms per burst of the entry point's ``match+ransac``
stage (``PipelineStats.phase_ms``, host clock, the stage ending in a
synchronise) over the traced run's window."""

from stackbench.metrics import _stages


def read(ctx):
    return _stages.mean_ms(ctx, ["match+ransac"])
