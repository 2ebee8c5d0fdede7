"""Shared arithmetic of the keypoint path's span readers: per call, the
sum of one field of the spans of one name (``PipelineStats.spans``,
``(name, parent, host_ms, device_ms)``), averaged over the traced
window's calls.  A program that records no such span (``PipelineStats``
without ``spans``, or spans without that name) gives None: nothing to
read."""

HOST, DEVICE = 2, 3


def summed(ctx, name, field):
    """The mean over the traced calls of the sum of ``field`` over each
    call's spans ``name``, over the calls that have them with ``field``
    set, or None."""
    vals = []
    for c in ctx.calls:
        st = c["stats"]
        spans = getattr(st, "spans", None) if st is not None else None
        got = [s[field] for s in spans or () if s[0] == name]
        if got and all(v is not None for v in got):
            vals.append(sum(got))
    return sum(vals) / len(vals) if vals else None
