"""``ransac_loop_ms``: device ms a call of the ``ransac.loop`` spans (a
chunk of RANSAC's hypothesis slabs each, under ``match+ransac``), summed
over the call's chunks and averaged over the traced window's calls;
None off CUDA."""

from stackbench.metrics import _kp_spans as K


def read(ctx):
    return K.summed(ctx, "ransac.loop", K.DEVICE)
