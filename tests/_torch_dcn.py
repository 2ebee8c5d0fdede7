"""The port's side of the multi-process scenarios of
``tests/_dcn_scenarios.py``: the same bursts (its ``make_burst``, plain
numpy) through ``libstacker_tpu_torch.parallel``'s sharded steps.
Imported by ``tests/test_torch_distributed.py`` and by the worker
processes it starts; it imports torch and the port only (not a pytest
file)."""

import numpy as np
import torch

from libstacker_tpu_torch.models import keypoint as kp_models
from libstacker_tpu_torch.ops import color, orb
from libstacker_tpu_torch.params import MotionType
from libstacker_tpu_torch.parallel import mesh as pmesh


def run_step(scenario: str, frames, base, mesh):
    """The scenario's sharded step -> (stacked [H,W,3] numpy, ok [N]).
    ``frames``: the burst (numpy) or this process's ``ShardedFrames``;
    ``base``: the reference frame (numpy)."""
    base_t = torch.from_numpy(np.ascontiguousarray(base))
    if scenario == "keypoint_drop":
        feats0 = orb.orb_detect_and_compute(kp_models._grey(base_t[None]))
        stacked, ok = pmesh.keypoint_stack_step(frames, feats0, mesh, seed=1)
    else:
        grey = color.rgb_to_gray_u8(base_t).to(torch.float32)
        kw = dict(motion_type=MotionType.Translation, num_iters=3, eps=1e-3)
        if scenario == "homography_sigma":
            kw = dict(motion_type=MotionType.Homography, num_iters=3,
                      eps=1e-3, stacking="sigma_clip", sigma_kappa=1.5,
                      sigma_iters=1)
        stacked, ok = pmesh.ecc_stack_step(frames, grey, mesh, **kw)
    return stacked.cpu().numpy(), ok
