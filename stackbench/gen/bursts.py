"""Frozen copies of the port's burst recipes, in plain torch.

A copy of ``libstacker_tpu_torch/utils/synth.py`` (``make_burst`` :24-69,
``make_textured_burst`` :72-116) with the port's two helpers it calls
written out here: the inverse-map bilinear ``warp_affine`` of
``ops/warp.py`` (``_dst_coords`` :46-64, ``_sample_bilinear`` :127-162,
the fixed-point 1/1024 coordinates of warpAffine) and the 3x3
``gaussian_blur`` of ``ops/filters.py`` (:34-132).  Scipy's
``gaussian_filter`` (sigma 6, reflect, truncate 4) runs on the device
in float64, one axis at a time, each pass rounded to float32 as scipy's
is.  ``stackbench/tests/test_stackbench_gen.py`` holds both recipes
bitwise to ``utils/synth.py`` at a small size.

The yardstick keeps these copies so that a later change to the port
cannot change the traffic it is measured on.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_PAD = 32


def burst_seed(seed: int, index: int) -> int:
    """The seed of burst ``index`` of a pool drawn from ``seed`` (any
    non-negative whole number)."""
    return int(np.random.SeedSequence([int(seed), int(index)])
               .generate_state(1, np.uint32)[0])


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """scipy's ``mode='reflect'`` (``dcba|abcd|dcba``) indices for a pad
    of ``r`` on an axis of ``n``."""
    i = torch.arange(-r, n + r, device=device)
    period = 2 * n
    m = torch.remainder(i, period)
    return torch.where(m >= n, period - 1 - m, m)


def _gauss_scipy(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter(img, sigma)`` of a float32 [H,W]
    image: axis 0 then axis 1, float64 sums, float32 between passes."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    k = k / k.sum()
    out = img
    for axis in (0, 1):
        n = out.shape[axis]
        idx = _reflect_index(n, radius, out.device)
        p = out.double().index_select(axis, idx)
        acc = torch.zeros_like(out, dtype=torch.float64)
        for j, c in enumerate(k.tolist()):
            acc += p.narrow(axis, j, n) * c
        out = acc.to(torch.float32)
    return out


def _sep3(img: torch.Tensor, taps) -> torch.Tensor:
    """OpenCV ``GaussianBlur`` with a 3-tap kernel, reflect-101 border,
    columns then rows, float32 products summed in tap order."""
    p = torch.nn.functional.pad(img[None], (1, 1, 1, 1), mode="reflect")[0]
    h, w = img.shape
    out = p[:, 0:w] * taps[0]
    out += p[:, 1 : 1 + w] * taps[1]
    out += p[:, 2 : 2 + w] * taps[2]
    res = out[0:h] * taps[0]
    res += out[1 : 1 + h] * taps[1]
    res += out[2 : 2 + h] * taps[2]
    return res


def _blur_taps(ksize: int, sigma: float):
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k /= k.sum()
    return [float(np.float32(c)) for c in k]


def _warp_affine_inverse(img: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """OpenCV ``warpAffine(img, m, img.shape, WARP_INVERSE_MAP)``,
    INTER_LINEAR, BORDER_CONSTANT 0, float32: the port's expressions
    term for term (1/1024 fixed-point coordinates, 1/32 weights)."""
    h, w = img.shape
    dev = img.device
    m3 = torch.as_tensor(m, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    sx = m3[0, 0] * xs + m3[0, 1] * ys + m3[0, 2]
    sy = m3[1, 0] * xs + m3[1, 1] * ys + m3[1, 2]
    xq = torch.floor((torch.round(sx * 1024.0) + 16.0) / 32.0)
    yq = torch.floor((torch.round(sy * 1024.0) + 16.0) / 32.0)
    x0f = torch.floor(xq * (1.0 / 32.0))
    y0f = torch.floor(yq * (1.0 / 32.0))
    fx = (xq - x0f * 32.0) * (1.0 / 32.0)
    fy = (yq - y0f * 32.0) * (1.0 / 32.0)
    x0 = torch.clamp(x0f, -2.0, w + 1.0).to(torch.int64)
    y0 = torch.clamp(y0f, -2.0, h + 1.0).to(torch.int64)
    zero = torch.zeros((), dtype=img.dtype, device=dev)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inside, v, zero)

    t00, t01, t10, t11 = (tap(y0 + dy, x0 + dx) for dy in (0, 1)
                          for dx in (0, 1))
    top = t00 * (1.0 - fx) + t01 * fx
    bot = t10 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def _rigid(rng, w: int, h: int, max_shift, max_angle, angle_first: bool):
    if angle_first:
        ang = math.radians(rng.uniform(-max_angle, max_angle))
        dx, dy = rng.uniform(-max_shift, max_shift, 2)
    else:
        dx, dy = rng.uniform(-max_shift, max_shift, 2)
        ang = math.radians(rng.uniform(-max_angle, max_angle))
    a, b = math.cos(ang), math.sin(ang)
    cx, cy = w / 2.0, h / 2.0
    return np.array([
        [a, b, (1 - a) * cx - b * cy + dx],
        [-b, a, b * cx + (1 - a) * cy + dy],
        [0.0, 0.0, 1.0],
    ])


def _frames(base, rng, n, h, w, max_shift, max_angle, angle_first):
    shift = np.array([[1, 0, _PAD], [0, 1, _PAD], [0, 0, 1]], np.float64)
    frames = torch.empty((n, h, w, 3), dtype=torch.uint8, device=base.device)
    truth = np.tile(np.eye(3), (n, 1, 1))
    for i in range(n):
        m = np.eye(3) if i == 0 else _rigid(rng, w, h, max_shift, max_angle,
                                            angle_first)
        cur = _warp_affine_inverse(base, m[:2])
        crop = cur[_PAD : _PAD + h, _PAD : _PAD + w]
        frames[i] = torch.clamp(torch.round(crop), 0, 255).to(torch.uint8)[
            ..., None]
        truth[i] = np.linalg.inv(shift) @ m @ shift
    return frames, truth


def make_burst(n: int, h: int, w: int, seed: int = 0, device="cpu",
               max_shift: float = 6.0, max_angle: float = 0.6):
    """``(frames [n,h,w,3] uint8 on device, truth [n,3,3] float64)``:
    smooth grey content (``utils/synth.make_burst``); ``truth[i]`` is
    frame i's ECC warp against frame 0."""
    rng = np.random.default_rng(seed)
    hp, wp = h + 2 * _PAD, w + 2 * _PAD
    noise = rng.integers(0, 256, size=(hp, wp)).astype(np.float32)
    base = _gauss_scipy(torch.from_numpy(noise).to(device), 6.0)
    lo, hi = base.min(), base.max()
    # a true float32 quotient (``255.0 / t`` would multiply by 1/t)
    scale = torch.div(torch.tensor(255.0, device=base.device), hi - lo)
    base = (base - lo) * scale
    base = torch.round(base)
    return _frames(base, rng, n, h, w, max_shift, max_angle, False)


def make_textured_burst(n: int, h: int, w: int, seed: int = 0, device="cpu",
                        max_shift: float = 6.0, max_angle: float = 0.6):
    """``(frames, truth)`` of grey 8x8-block texture
    (``utils/synth.make_textured_burst``); ``truth[i]`` maps frame-i
    pixel coordinates to frame 0's."""
    rng = np.random.default_rng(seed)
    hp, wp = h + 2 * _PAD, w + 2 * _PAD
    small = rng.integers(0, 256, size=(hp // 8, wp // 8)).astype(np.float32)
    yi = np.minimum(np.arange(hp) * (hp // 8) // hp, hp // 8 - 1)
    xi = np.minimum(np.arange(wp) * (wp // 8) // wp, wp // 8 - 1)
    base = torch.from_numpy(small[yi][:, xi]).to(device)
    base = _sep3(base, _blur_taps(3, 0.8))
    base = torch.clamp(torch.round(base), 0, 255)
    return _frames(base, rng, n, h, w, max_shift, max_angle, True)


RECIPES = {"smooth": make_burst, "textured": make_textured_burst}
