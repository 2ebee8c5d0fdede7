"""Plain reference of ``keypoint_orb_4k``: the upstream's
``keypoint_match`` (src/lib.rs:146-343) on u8 RGB bursts.

The answer the keypoint path estimates is each frame's homography onto
frame 0 (frame-i pixel coordinates to frame 0's).  The reference finds
that same homography directly, with no keypoints: grey of every frame,
then ``grey_i(x) ~ grey_0(H_i x)`` by OpenCV's ECC at full resolution,
solved to convergence from a phase-correlation start of its own.  Stack:
frame 0 plus every kept frame warped forward by ``H_i`` (INTER_LINEAR,
BORDER_CONSTANT 0), over [0, 1], divided by the kept count.
"""

from __future__ import annotations

import torch

from stackbench.reference import _plain

def align(frames_u8: torch.Tensor, traffic: dict, dtype=torch.float32):
    """``(homographies [N-1,3,3] float64, ok [N-1])``."""
    gf = _plain.grey(frames_u8).to(torch.float32)
    init = _plain.phase_start(gf[1:], gf[0])
    hs, ok, _ = _plain.ecc_homography(gf[1:], gf[0], init, dtype=dtype)
    return hs, ok


def stack(frames_u8: torch.Tensor, hs: torch.Tensor, ok: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
    eye = torch.eye(3, dtype=torch.float64, device=hs.device)[None]
    all_h = torch.cat([eye, hs.to(torch.float64)])
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=ok.device), ok])
    total = _plain.warp_sum(frames_u8, all_h, keep, dtype)
    return total / (1 + int(ok.sum()))
