"""Shared arithmetic of the stage readers: the mean, over the traced
window's calls, of the summed ``PipelineStats.phase_ms`` of some
stages, or None where no call recorded any of them."""


def mean_ms(ctx, names):
    vals = []
    for c in ctx.calls:
        st = c["stats"]
        if st is None or not st.phase_ms:
            continue
        got = [st.phase_ms[n] for n in names if n in st.phase_ms]
        if got:
            vals.append(sum(got))
    return sum(vals) / len(vals) if vals else None
