"""``orb_topk_ms``: device ms a call of the ``orb.topk`` spans (the
candidates' exact top-k, ``ops/fast.top_k_keypoints``, one inside each
``orb.level`` of ``detect``), summed over the pyramid's levels and
averaged over the traced window's calls; None off CUDA."""

from stackbench.metrics import _kp_spans as K


def read(ctx):
    return K.summed(ctx, "orb.topk", K.DEVICE)
