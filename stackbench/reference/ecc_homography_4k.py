"""Plain reference of ``ecc_homography_4k``: the upstream's
``ecc_match`` (src/lib.rs:752-843) on u8 RGB bursts.

Alignment: grey of every frame (INTER_AREA-scaled to the traffic's
``scale_down_width`` and rounded back to u8 where it has one), then for
each frame i >= 1 the homography ``W_i`` with ``grey_i(x) ~ grey_0(W_i
x)`` by OpenCV's ECC with a 5x5 Gaussian prefilter, solved to
convergence from a phase-correlation start of its own, and rescaled to
full resolution the upstream's way.  Stack: frame 0 plus every frame
warped forward by its ``W_i`` (INTER_LINEAR, BORDER_CONSTANT 0), over
[0, 1], divided by the frame count.
"""

from __future__ import annotations

import torch

from stackbench.reference import _plain

def align(frames_u8: torch.Tensor, traffic: dict, dtype=torch.float32):
    """``(warps [N-1,3,3] float64 at full resolution, ok [N-1])``."""
    n, h, w, _ = frames_u8.shape
    g = _plain.grey(frames_u8)
    sdw = traffic.get("scale_down_width")
    small = None
    if sdw:
        small = _plain.scaled_size(h, w, sdw)
        g = _plain.area_resize_u8(g, small)
    gf = g.to(torch.float32)
    del g
    init = _plain.phase_start(gf[1:], gf[0])
    warps, ok, _ = _plain.ecc_homography(gf[1:], gf[0], init, dtype=dtype)
    if small is not None:
        warps = _plain.rescale_warps(warps, small, (h, w))
    return warps, ok


def stack(frames_u8: torch.Tensor, warps: torch.Tensor, ok: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
    """The mean stack from frame 0 and the frames ``ok`` keeps, warped
    by ``warps`` ([N-1,3,3])."""
    n = frames_u8.shape[0]
    eye = torch.eye(3, dtype=torch.float64, device=warps.device)[None]
    all_w = torch.cat([eye, warps.to(torch.float64)])
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=ok.device), ok])
    total = _plain.warp_sum(frames_u8, all_w, keep, dtype)
    return total / n
