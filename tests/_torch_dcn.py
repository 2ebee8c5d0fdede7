"""The port's side of the multi-process scenarios of
``tests/_dcn_scenarios.py``: the same bursts (its ``make_burst``, plain
numpy) through ``libstacker_tpu_torch.parallel``'s sharded steps.
Imported by ``tests/test_torch_distributed.py`` and by the worker
processes it starts; it imports torch and the port only (not a pytest
file)."""

import numpy as np
import torch

from libstacker_tpu_torch.ops import color, orb
from libstacker_tpu_torch.params import MotionType
from libstacker_tpu_torch.parallel import mesh as pmesh


def run_step(scenario: str, frames, base, mesh):
    """The scenario's sharded step -> (stacked [H,W,3] numpy, ok [N]).
    ``frames``: the burst (numpy) or this process's ``ShardedFrames``;
    ``base``: the reference frame (numpy)."""
    base_t = torch.from_numpy(np.ascontiguousarray(base))
    if scenario == "keypoint_drop":
        feats0 = orb.orb_detect_and_compute(color.burst_grey_u8(base_t[None]))
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


# the row-band functions on a mesh whose rows span processes
# (tests/test_torch_spatial_dcn.py): warp halo, ECC halo
SPATIAL_WARP_HALO = 8
SPATIAL_ECC_HALO = 16


def run_spatial(inputs, mesh) -> dict:
    """``warp_rows_sharded``, ``sharpness_teng_spatial`` and
    ``ecc_stack_step_spatial`` of ``parallel/mesh.py`` on ``inputs``
    (numpy: ``frame`` [H,W,3] f32 and its map ``m3``, ``greys`` [N,H,W]
    f32, ``burst`` [1+N,H,W,3] u8 solved at ``scale_hw`` and at
    ``scale_hw_cut``) -> numpy results: ``warp``, ``teng``, ``ecc`` and
    ``ecc_cut`` (the stacked sums), ``ok`` and ``ok_cut``; and
    ``ecc_stack_step`` on the same mesh (``step``, ``ok_step``)."""
    warped = pmesh.warp_rows_sharded(inputs["frame"], inputs["m3"], mesh,
                                     halo=SPATIAL_WARP_HALO)
    out = dict(warp=warped.cpu().numpy(),
               teng=pmesh.sharpness_teng_spatial(inputs["greys"], mesh))
    burst = inputs["burst"]
    for key in ("", "_cut"):
        total, ok = pmesh.ecc_stack_step_spatial(
            burst[1:], burst[0], mesh,
            tuple(int(v) for v in inputs["scale_hw" + key]),
            motion_type=MotionType.Translation, num_iters=50, eps=1e-5,
            halo=SPATIAL_ECC_HALO)
        out["ecc" + key], out["ok" + key] = total.cpu().numpy(), ok
    # the 'data' axis on the same mesh: each rank of a row steps its
    # row's frames, the sums reduce over its band column
    grey = color.rgb_to_gray_u8(torch.from_numpy(burst[0])).to(torch.float32)
    step, ok = pmesh.ecc_stack_step(burst[1:], grey, mesh,
                                    motion_type=MotionType.Translation,
                                    num_iters=3, eps=1e-3)
    out["step"], out["ok_step"] = step.cpu().numpy(), ok
    return out
