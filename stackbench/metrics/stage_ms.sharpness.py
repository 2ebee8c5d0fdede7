"""``stage_ms.sharpness``: mean ms per burst of the benchmark's own span
around the port's grey and ``sharpness_all``, which ends in ``.cpu()``
(host clock), over the traced run's window."""


def read(ctx):
    vals = ctx.spans.get("sharpness")
    return sum(vals) / len(vals) if vals else None
