"""Separable correlation filters with OpenCV border semantics.

Counterpart of ``libstacker_tpu/ops/filters.py`` (``pad2d`` :34,
``sep_filter2d`` :71, ``gaussian_kernel`` :89, ``gaussian_blur`` :112,
``deriv_kernel`` :121, ``sobel`` :136, ``laplacian`` :151): small kernels
applied as shifted-slice float32 multiply-adds over a border-padded
image, in the reference's term order (no convolution library, so no
TF32 question).  Operates on the trailing two axes of ``[..., H, W]``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .warp import _map_border_index

_PAD_MODE = {
    "constant": "constant",
    "replicate": "replicate",
    "reflect101": "reflect",  # OpenCV BORDER_REFLECT_101  gfedcb|abcdefgh|gfedcba
    # gathered through OpenCV's borderInterpolate (ops/warp.py)
    "reflect": None,  # OpenCV BORDER_REFLECT      fedcba|abcdefgh|hgfedcb
    "wrap": None,  # OpenCV BORDER_WRAP         cdefgh|abcdefgh|abcdefg
}


def pad2d(
    img: torch.Tensor,
    pad_y: int,
    pad_x: int,
    border: str = "reflect101",
    value: float = 0.0,
) -> torch.Tensor:
    """Pad the trailing two axes with an OpenCV border mode
    (``reflect101``, ``replicate``, ``reflect``, ``wrap`` or
    ``constant``)."""
    if pad_y == 0 and pad_x == 0:
        return img
    if border not in _PAD_MODE:
        raise ValueError(f"unsupported border mode: {border!r}")
    mode = _PAD_MODE[border]
    pads = (pad_x, pad_x, pad_y, pad_y)
    if mode == "constant":
        return F.pad(img, pads, mode="constant", value=value)
    if mode is None:
        h, w = img.shape[-2:]
        dev = img.device
        iy = _map_border_index(torch.arange(-pad_y, h + pad_y, device=dev),
                               h, border)
        ix = _map_border_index(torch.arange(-pad_x, w + pad_x, device=dev),
                               w, border)
        return img[..., iy[:, None], ix[None, :]]
    # reflect/replicate take [C,H,W] or [N,C,H,W]: fold leading axes
    lead = img.shape[:-2]
    x = img.reshape((-1,) + tuple(img.shape[-2:]))
    out = F.pad(x, pads, mode=mode)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def _correlate_axis(
    img: torch.Tensor, kernel: Sequence[float], axis: int
) -> torch.Tensor:
    """Correlate a pre-padded image along ``axis`` (-1 or -2) with a 1D
    kernel, producing the valid region."""
    k = len(kernel)
    size = img.shape[axis] - (k - 1)
    out = None
    for i, c in enumerate(kernel):
        if c == 0.0:
            continue
        # float32 coefficient, as JAX's weakly typed scalar becomes
        term = img.narrow(axis, i, size) * float(np.float32(c))
        if out is None:
            out = term
        else:
            out += term  # in place: same sum as out + term, one buffer
    if out is None:
        out = torch.zeros_like(img.narrow(axis, 0, size))
    return out


def sep_filter2d(
    img: torch.Tensor,
    kx: Sequence[float],
    ky: Sequence[float],
    border: str = "reflect101",
    value: float = 0.0,
) -> torch.Tensor:
    """OpenCV sepFilter2D (correlation, centred anchor): ``kx`` runs
    along W, ``ky`` along H, on ``[..., H, W]``."""
    ry, rx = len(ky) // 2, len(kx) // 2
    p = pad2d(img, ry, rx, border, value)
    out = _correlate_axis(p, list(kx), axis=-1)
    del p
    return _correlate_axis(out, list(ky), axis=-2)


@functools.lru_cache(maxsize=64)
def gaussian_kernel(ksize: int, sigma: float = 0.0) -> Tuple[float, ...]:
    """OpenCV getGaussianKernel: fixed small tables for ksize<=9 when
    sigma<=0, else sampled exponential with OpenCV's derived sigma."""
    small_tab = {
        1: (1.0,),
        3: (0.25, 0.5, 0.25),
        5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
        7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
        9: (
            0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375,
            0.19921875, 0.1171875, 0.05078125, 0.015625,
        ),
    }
    if sigma <= 0 and ksize in small_tab:
        return small_tab[ksize]
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * s * s))
    k /= k.sum()
    return tuple(k.tolist())


def gaussian_blur(
    img: torch.Tensor, ksize: int, sigma: float = 0.0,
    border: str = "reflect101",
) -> torch.Tensor:
    """OpenCV GaussianBlur(ksize, sigmaX=sigma, sigmaY=sigma)."""
    k = gaussian_kernel(ksize, sigma)
    return sep_filter2d(img, k, k, border)


@functools.lru_cache(maxsize=64)
def deriv_kernel(order: int, ksize: int) -> Tuple[float, ...]:
    """OpenCV getDerivKernels 1D factor: binomial smoothing of order
    (ksize-1-order) composed with ``order`` discrete derivatives.
    ksize==1 with order>0 uses a 3-tap kernel (no smoothing)."""
    if ksize == 1 and order > 0:
        ksize = 3
    k = np.array([1.0])
    for _ in range(ksize - 1 - order):
        k = np.convolve(k, [1.0, 1.0])
    for _ in range(order):
        k = np.convolve(k, [-1.0, 1.0])
    return tuple(k.tolist())


def sobel(
    img: torch.Tensor, dx: int, dy: int, ksize: int = 3, scale: float = 1.0,
    border: str = "reflect101",
) -> torch.Tensor:
    """OpenCV Sobel on ``[..., H, W]`` (ref src/lib.rs:1111-1132)."""
    out = sep_filter2d(img, deriv_kernel(dx, ksize), deriv_kernel(dy, ksize),
                       border)
    if scale != 1.0:
        out = out * float(np.float32(scale))
    return out


def laplacian(img: torch.Tensor, ksize: int = 3,
              border: str = "replicate") -> torch.Tensor:
    """OpenCV Laplacian: ksize=1 uses the 4-neighbour stencil; ksize>=3
    sums the two smoothed second derivatives (ref src/lib.rs:1076-1084
    calls it with ksize=3, BORDER_REPLICATE)."""
    if ksize == 1:
        d2, sm = (1.0, -2.0, 1.0), (1.0,)
    else:
        d2, sm = deriv_kernel(2, ksize), deriv_kernel(0, ksize)
    return sep_filter2d(img, d2, sm, border) + sep_filter2d(img, sm, d2, border)
