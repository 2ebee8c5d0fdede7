"""Synthetic bursts with known warps, made from a seed, without OpenCV.

:func:`make_burst` is the ``bench.py:make_burst`` recipe (the ECC
bench): a smoothed random base (``scipy.ndimage.gaussian_filter``, sigma
6, stretched to 0..255).  :func:`make_textured_burst` is
``benchmarks/bench_keypoint.py:make_textured_burst`` (the keypoint
bench): random 8x8-pixel blocks, upsampled by nearest, blurred with a
3x3 Gaussian of sigma 0.8, so the content has real corners.  Each frame
is then rotated by up to ``max_angle`` degrees and shifted by up to
``max_shift`` px with an inverse-map bilinear warp
(``ops/warp.warp_affine``) on ``device``, and cropped from a 32-px
margin.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import filters, warp

_PAD = 32


def make_burst(
    n: int, h: int, w: int, seed: int = 0, device="cpu",
    max_shift: float = 6.0, max_angle: float = 0.6,
):
    """Return ``(frames, truth)``: ``frames`` [n,h,w,3] uint8 RGB tensor
    on ``device`` (grey content in all three channels) and ``truth``
    [n,3,3] float64 numpy, the ECC warp of each frame against frame 0
    (``template(x) = frame0(W x)``; frame 0's is the identity)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    hp, wp = h + 2 * _PAD, w + 2 * _PAD
    base = rng.integers(0, 256, size=(hp, wp)).astype(np.float32)
    base = gaussian_filter(base, 6.0)
    base = (base - base.min()) * (255.0 / (base.max() - base.min()))
    base_t = torch.from_numpy(np.round(base).astype(np.float32)).to(device)
    shift = np.array([[1, 0, _PAD], [0, 1, _PAD], [0, 0, 1]], np.float64)
    frames = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    truth = np.tile(np.eye(3), (n, 1, 1))
    for i in range(n):
        if i == 0:
            m = np.eye(3)
        else:
            dx, dy = rng.uniform(-max_shift, max_shift, 2)
            ang = math.radians(rng.uniform(-max_angle, max_angle))
            a, b = math.cos(ang), math.sin(ang)
            cx, cy = w / 2.0, h / 2.0
            m = np.array([
                [a, b, (1 - a) * cx - b * cy + dx],
                [-b, a, b * cx + (1 - a) * cy + dy],
                [0.0, 0.0, 1.0],
            ])
        cur = warp.warp_affine(
            base_t, torch.as_tensor(m[:2], dtype=torch.float32, device=device),
            (hp, wp), inverse_map=True,
        )
        crop = cur[_PAD : _PAD + h, _PAD : _PAD + w]
        frames[i] = torch.clamp(torch.round(crop), 0, 255).to(torch.uint8)[
            ..., None
        ]
        truth[i] = np.linalg.inv(shift) @ m @ shift
    return frames, truth


def make_textured_burst(
    n: int, h: int, w: int, seed: int = 0, device="cpu",
    max_shift: float = 6.0, max_angle: float = 0.6,
):
    """Return ``(frames, truth)``: ``frames`` [n,h,w,3] uint8 RGB tensor
    on ``device`` (grey block texture in all three channels) and
    ``truth`` [n,3,3] float64 numpy, the homography mapping frame-i
    pixel coordinates to frame 0's (frame 0's is the identity).

    The recipe of ``benchmarks/bench_keypoint.py:19-45``: frame i is
    ``base(M_i x)`` with ``M_i`` cv2's ``getRotationMatrix2D((w/2, h/2),
    angle, 1)`` plus the shift, applied to the padded base."""
    rng = np.random.default_rng(seed)
    hp, wp = h + 2 * _PAD, w + 2 * _PAD
    small = rng.integers(0, 256, size=(hp // 8, wp // 8)).astype(np.float32)
    yi = np.minimum(np.arange(hp) * (hp // 8) // hp, hp // 8 - 1)
    xi = np.minimum(np.arange(wp) * (wp // 8) // wp, wp // 8 - 1)
    base = torch.from_numpy(small[yi][:, xi]).to(device)
    base = filters.gaussian_blur(base, 3, 0.8)
    base = torch.clamp(torch.round(base), 0, 255)
    shift = np.array([[1, 0, _PAD], [0, 1, _PAD], [0, 0, 1]], np.float64)
    frames = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    truth = np.tile(np.eye(3), (n, 1, 1))
    for i in range(n):
        if i == 0:
            m = np.eye(3)
        else:
            ang = math.radians(rng.uniform(-max_angle, max_angle))
            dx, dy = rng.uniform(-max_shift, max_shift, 2)
            a, b = math.cos(ang), math.sin(ang)
            cx, cy = w / 2.0, h / 2.0
            m = np.array([
                [a, b, (1 - a) * cx - b * cy + dx],
                [-b, a, b * cx + (1 - a) * cy + dy],
                [0.0, 0.0, 1.0],
            ])
        cur = warp.warp_affine(
            base, torch.as_tensor(m[:2], dtype=torch.float32, device=device),
            (hp, wp), inverse_map=True,
        )
        crop = cur[_PAD : _PAD + h, _PAD : _PAD + w]
        frames[i] = torch.clamp(torch.round(crop), 0, 255).to(torch.uint8)[
            ..., None
        ]
        truth[i] = np.linalg.inv(shift) @ m @ shift
    return frames, truth
