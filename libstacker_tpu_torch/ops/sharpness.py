"""Focus / sharpness metrics over ``[..., H, W]`` grey frames.

Counterpart of ``libstacker_tpu/ops/sharpness.py`` (:38-97), the
reference's four metrics (SURVEY.md R10-R13):

- LAPM  ``sharpness_modified_laplacian``  (ref src/lib.rs:1032-1070)
- LAPV  ``sharpness_variance_of_laplacian`` (ref src/lib.rs:1074-1090)
- TENG  ``sharpness_tenengrad``            (ref src/lib.rs:1101-1147)
- GLVN  ``sharpness_normalized_gray_level_variance`` (src/lib.rs:1151-1166)

Each filter is the port's shifted-slice ``ops/filters.sep_filter2d``, so
the filtered planes equal the JAX package's tap for tap; only the
float32 means sum in another order.  A numpy input is copied to
``device`` ("cuda" by default; asking for CUDA without a card raises);
a tensor stays on its own device.  Every metric returns a float32
tensor of the leading shape ``[...]``.  :func:`sharpness_all` scores
``_SCORE_CHUNK`` frames at a time: each metric keeps a few float32
planes per frame alive, which for 100 4K frames would be ~3.3 GB each.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidParamsError
from ..utils.device import resolve_device
from . import filters

_EPS_F64 = 2.220446049250313e-16  # f64::EPSILON used at ref src/lib.rs:1163
# frames scored per pass of sharpness_all
_SCORE_CHUNK = 16


def _to_float(img, device) -> torch.Tensor:
    """numpy -> float32 tensor on ``device``; a tensor stays where it is."""
    if isinstance(img, torch.Tensor):
        resolve_device(img.device)
        return img.to(torch.float32)
    dev = resolve_device(device)
    return torch.from_numpy(np.ascontiguousarray(img)).to(dev).to(torch.float32)


def _mean_hw(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(-2, -1))


def sharpness_modified_laplacian(img, device="cuda") -> torch.Tensor:
    """LAPM (Nayar89): mean(|Lx| + |Ly|) with Lx = sep_filter(kx=[-1,2,-1],
    ky=gauss3) and Ly the transpose pair (ref src/lib.rs:1032-1070)."""
    x = _to_float(img, device)
    m = (-1.0, 2.0, -1.0)
    g = filters.gaussian_kernel(3, -1.0)
    a = filters.sep_filter2d(x, m, g, border="reflect101").abs_()
    a += filters.sep_filter2d(x, g, m, border="reflect101").abs_()
    return _mean_hw(a)


def sharpness_variance_of_laplacian(img, device="cuda") -> torch.Tensor:
    """LAPV (Pech2000): population variance of the ksize=3 Laplacian
    with BORDER_REPLICATE (ref src/lib.rs:1074-1090)."""
    lap = filters.laplacian(_to_float(img, device), ksize=3,
                            border="replicate")
    lap -= torch.mean(lap, dim=(-2, -1), keepdim=True)
    return _mean_hw(lap * lap)


def sharpness_tenengrad(img, k_size: int = 3, device="cuda") -> torch.Tensor:
    """TENG (Krotkov86): mean(gx^2 + gy^2) of Sobel gradients
    (ref src/lib.rs:1101-1147; k_size validated to {1,3,5,7} at
    src/lib.rs:1103-1107)."""
    if k_size not in (1, 3, 5, 7):
        raise InvalidParamsError("Kernel size must be 1, 3, 5, or 7")
    x = _to_float(img, device)
    gx = filters.sobel(x, 1, 0, ksize=k_size, border="reflect101")
    gy = filters.sobel(x, 0, 1, ksize=k_size, border="reflect101")
    return _mean_hw(gx * gx + gy * gy)


def sharpness_normalized_gray_level_variance(img, device="cuda") -> torch.Tensor:
    """GLVN (Santos97): population variance / mean (mean clamped to eps,
    ref src/lib.rs:1151-1166)."""
    x = _to_float(img, device)
    mu = torch.mean(x, dim=(-2, -1), keepdim=True)
    d = x - mu
    var = _mean_hw(d * d)
    return var / torch.clamp(mu[..., 0, 0], min=_EPS_F64)


def sharpness_all(img, teng_k_size: int = 3, device="cuda") -> dict:
    """All four metrics of a batch -> dict with keys lapm/lapv/teng/glvn,
    each a ``[...]`` float32 tensor (ref examples/main.rs:37-49 scores
    the frames one by one).  Scores ``_SCORE_CHUNK`` frames at a time."""
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.ascontiguousarray(img)).to(
            resolve_device(device))
    lead = img.shape[:-2]
    flat = img.reshape((-1,) + tuple(img.shape[-2:]))
    parts = {"lapm": [], "lapv": [], "teng": [], "glvn": []}
    for s in range(0, max(flat.shape[0], 1), _SCORE_CHUNK):
        x = _to_float(flat[s : s + _SCORE_CHUNK], device)
        parts["lapm"].append(sharpness_modified_laplacian(x))
        parts["lapv"].append(sharpness_variance_of_laplacian(x))
        parts["teng"].append(sharpness_tenengrad(x, teng_k_size))
        parts["glvn"].append(sharpness_normalized_gray_level_variance(x))
    return {k: torch.cat(v).reshape(lead) for k, v in parts.items()}
