"""``stage_ms.ecc_align``: mean ms per burst of ECC's start and solve
(``PipelineStats.phase_ms`` stages ``phase init``, ``ecc octave build``,
``ecc octave solve`` and ``ecc full-res solve``, summed) over the
traced run's window."""

from stackbench.metrics import _stages


def read(ctx):
    return _stages.mean_ms(ctx, ["phase init", "ecc octave build",
                                 "ecc octave solve", "ecc full-res solve"])
