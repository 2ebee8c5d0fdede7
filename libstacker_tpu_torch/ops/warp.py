"""Affine / perspective warps (inverse-map resampling).

Counterpart of ``libstacker_tpu/ops/warp.py`` (``affine_to_3x3`` :33,
``invert_3x3`` :39, ``_map_border_index`` :43, ``_sample_bilinear``
:67, ``_dst_coords`` :152, ``warp_perspective`` :181, ``warp_affine``
:209, ``_sample_nearest`` :236, ``warp_valid_mask`` :258): every output
pixel is inverse-mapped through the matrix and sampled.  Bilinear
sampling uses OpenCV's 1/32-px coordinate quantisation —
``round(s*32)`` for perspective, warpAffine's AB_BITS fixed point
``floor((round(s*1024)+16)/32)`` for affine; INTER_NEAREST rounds the
unquantised coordinate (half to even).  Border modes: CONSTANT (per
channel value), TRANSPARENT (out-of-source taps read a destination base,
zeros by default), and the index-mapping modes REPLICATE, REFLECT,
REFLECT_101 and WRAP (OpenCV's borderInterpolate on each tap index).

This module is the exact path the CUDA kernels are held to: their plain
versions (``ecc_cuda``, ``warp_accum_cuda``, ``warp_cuda``) are built
from it, and the kernels evaluate the same float32 expressions in the
same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import constants

_INTER_TAB_SIZE = 32.0


def affine_to_3x3(m: torch.Tensor) -> torch.Tensor:
    """Promote ``[..., 2, 3]`` affine matrices to ``[..., 3, 3]``."""
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=m.dtype, device=m.device)
    bottom = bottom.expand(*m.shape[:-2], 1, 3)
    return torch.cat([m, bottom], dim=-2)


def invert_3x3(m: torch.Tensor) -> torch.Tensor:
    """float32 inverse of ``[..., 3, 3]`` matrices (``inv_ex``: bitwise
    ``linalg.inv``, without the check of ``info`` that makes the host
    wait for the card; a singular matrix gives non-finite entries)."""
    return torch.linalg.inv_ex(m.to(torch.float32))[0]


def rescale_maps(maps: torch.Tensor, small_hw, full_hw) -> torch.Tensor:
    """Forward maps (``[..., 2, 3]`` or ``[..., 3, 3]``) solved on the
    ``small_hw`` grid -> ``full_hw``: the translation column scales by
    full/small, a homography's perspective row divides, by float32
    factors (ref src/lib.rs:941-958, src/utils.rs:218-248)."""
    sx = float(np.float32(full_hw[1] / small_hw[1]))
    sy = float(np.float32(full_hw[0] / small_hw[0]))
    m = maps.clone()
    m[..., 0, 2] *= sx
    m[..., 1, 2] *= sy
    if m.shape[-2] == 3:
        m[..., 2, 0] /= sx
        m[..., 2, 1] /= sy
    return m


def _dst_coords(
    m3: torch.Tensor, dsize: Tuple[int, int], perspective: bool,
    oy0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map every dst pixel (x, y) through ``m3`` to source coords
    ``[dh, dw]`` (float32; ``a*x + b*y + c`` evaluated left to right);
    dst row y is row ``y + oy0`` of a larger grid."""
    dh, dw = dsize
    dev = m3.device
    ys = torch.arange(oy0, oy0 + dh, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(dw, dtype=torch.float32, device=dev)[None, :]
    sx = m3[0, 0] * xs + m3[0, 1] * ys + m3[0, 2]
    sy = m3[1, 0] * xs + m3[1, 1] * ys + m3[1, 2]
    if perspective:
        sw = m3[2, 0] * xs + m3[2, 1] * ys + m3[2, 2]
        inv = torch.where(sw != 0.0, 1.0 / sw, torch.zeros_like(sw))
        sx = sx * inv
        sy = sy * inv
    return sx, sy


# index-mapping modes (OpenCV borderInterpolate) and the two that fill
_INDEX_MODES = ("replicate", "reflect", "reflect101", "wrap")
_FILL_MODES = ("constant", "transparent")
# far tap origins are clamped before the integer cast: to the 1-px ring
# around the image for the filling modes (no in-range tap moves), and to
# +-2^30 for the index-mapping modes (every float32 coordinate below it
# maps as in the JAX package)
_INDEX_LIMIT = float(1 << 30)


def _map_border_index(idx: torch.Tensor, size: int, border: str) -> torch.Tensor:
    """OpenCV borderInterpolate for one axis (index-mapping modes)."""
    if border == "replicate":
        return torch.clamp(idx, 0, size - 1)
    if border == "wrap":
        return torch.remainder(idx, size)
    if border == "reflect101":
        if size == 1:
            return torch.zeros_like(idx)
        period = 2 * (size - 1)
        m = torch.remainder(idx, period)
        return torch.minimum(m, period - m)
    if border == "reflect":
        period = 2 * size
        m = torch.remainder(idx, period)
        return torch.where(m >= size, period - 1 - m, m)
    raise ValueError(f"unsupported border mode: {border}")


def _to_index(f: torch.Tensor, size: int, border: str) -> torch.Tensor:
    """Integer tap index from a float one (see ``_INDEX_LIMIT``)."""
    if border in _FILL_MODES:
        return torch.clamp(f, -2.0, size + 1.0).to(torch.int64)
    return torch.clamp(f, -_INDEX_LIMIT, _INDEX_LIMIT).to(torch.int64)


def _fill(img, sx, border, border_value, dst_base):
    """The value an out-of-source tap reads under a filling mode:
    ``border_value`` (CONSTANT) or the destination base (TRANSPARENT,
    zeros by default), shaped to broadcast against the taps."""
    if border == "transparent":
        if dst_base is None:
            return torch.zeros((), dtype=img.dtype, device=img.device)
        shape = tuple(sx.shape) + tuple(img.shape[2:])
        return torch.as_tensor(dst_base, dtype=img.dtype,
                               device=img.device).expand(shape)
    return torch.as_tensor(border_value, dtype=img.dtype, device=img.device)


def _tap(img, yi, xi, border, fill):
    """``img[yi, xi]`` with the border mode applied to the indices."""
    h, w = img.shape[0], img.shape[1]
    if border in _FILL_MODES:
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if img.ndim == 3:
            inside = inside[..., None]
        return torch.where(inside, v, fill)
    return img[_map_border_index(yi, h, border), _map_border_index(xi, w, border)]


def _sample_bilinear(
    img: torch.Tensor,
    sx: torch.Tensor,
    sy: torch.Tensor,
    border_value,
    fixed_point_1024: bool = False,
    border: str = "constant",
    dst_base=None,
    sy0: int = 0,
) -> torch.Tensor:
    """Bilinear sample ``img`` ([H,W] or [H,W,C] float32) at (sx, sy)
    with the 1/32 quantisation and the border mode's taps; ``img`` holds
    the rows from ``sy0`` of a larger frame."""
    h, w = img.shape[0], img.shape[1]
    if fixed_point_1024:
        xq = torch.floor((torch.round(sx * 1024.0) + 16.0) / 32.0)
        yq = torch.floor((torch.round(sy * 1024.0) + 16.0) / 32.0)
    else:
        xq = torch.round(sx * _INTER_TAB_SIZE)
        yq = torch.round(sy * _INTER_TAB_SIZE)
    x0f = torch.floor(xq * (1.0 / _INTER_TAB_SIZE))
    y0f = torch.floor(yq * (1.0 / _INTER_TAB_SIZE))
    fx = (xq - x0f * _INTER_TAB_SIZE) * (1.0 / _INTER_TAB_SIZE)
    fy = (yq - y0f * _INTER_TAB_SIZE) * (1.0 / _INTER_TAB_SIZE)
    x0 = _to_index(x0f, w, border)
    y0 = _to_index(y0f - float(sy0), h, border)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    fill = _fill(img, sx, border, border_value, dst_base)
    t00, t01, t10, t11 = (
        _tap(img, y0 + dy, x0 + dx, border, fill)
        for dy in (0, 1) for dx in (0, 1)
    )
    top = t00 * (1.0 - fx) + t01 * fx
    bot = t10 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def _sample_nearest(img, sx, sy, border, border_value, dst_base=None):
    """INTER_NEAREST: the tap at the unquantised coordinate rounded half
    to even, with the border mode's taps; keeps ``img``'s dtype."""
    h, w = img.shape[0], img.shape[1]
    xi = _to_index(torch.round(sx), w, border)
    yi = _to_index(torch.round(sy), h, border)
    return _tap(img, yi, xi, border,
                _fill(img, sx, border, border_value, dst_base))


def _resolve_border(border_mode) -> str:
    """An OpenCV border-mode integer or a mode name -> the mode name."""
    if isinstance(border_mode, str):
        border = border_mode
    else:
        border = constants.border_mode_name(int(border_mode))
    if border not in _FILL_MODES + _INDEX_MODES:
        raise ValueError(f"unsupported border mode: {border}")
    return border


def _warp(img, m3, dsize, border_mode, border_value, inverse_map,
          interpolation, dst, fixed_point_1024, rows=(0, 0)):
    if interpolation not in (constants.INTER_LINEAR, constants.INTER_NEAREST):
        raise ValueError(
            f"interpolation {interpolation} is not supported (INTER_LINEAR "
            "or INTER_NEAREST)"
        )
    border = _resolve_border(border_mode)
    if border_value is None:
        border_value = 0.0
    if dsize is None:
        dsize = (img.shape[0], img.shape[1])
    if not inverse_map:
        m3 = invert_3x3(m3)
    sx, sy = _dst_coords(m3, dsize, perspective=not fixed_point_1024,
                         oy0=rows[0])
    if interpolation == constants.INTER_NEAREST:
        if rows != (0, 0):
            raise ValueError("row origins take INTER_LINEAR only")
        return _sample_nearest(img, sx, sy, border, border_value, dst)
    return _sample_bilinear(img, sx, sy, border_value, fixed_point_1024,
                            border, dst, sy0=rows[1])


def warp_perspective(
    img: torch.Tensor,
    m: torch.Tensor,
    dsize: Optional[Tuple[int, int]] = None,
    border_mode=constants.BORDER_CONSTANT,
    border_value=0.0,
    inverse_map: bool = False,
    interpolation: int = constants.INTER_LINEAR,
    dst: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """OpenCV warpPerspective: dst(x,y) = src(M^-1 (x,y,1)).  ``dsize``
    is (h, w); ``inverse_map=True`` takes ``m`` as the dst->src map
    (WARP_INVERSE_MAP); ``dst`` is the BORDER_TRANSPARENT base (zeros by
    default)."""
    m3 = m.to(torch.float32)
    m3 = m3 if m3.shape[-2] == 3 else affine_to_3x3(m3)
    return _warp(img, m3, dsize, border_mode, border_value, inverse_map,
                 interpolation, dst, fixed_point_1024=False)


def warp_affine(
    img: torch.Tensor,
    m: torch.Tensor,
    dsize: Optional[Tuple[int, int]] = None,
    border_mode=constants.BORDER_CONSTANT,
    border_value=0.0,
    inverse_map: bool = False,
    interpolation: int = constants.INTER_LINEAR,
    dst: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """OpenCV warpAffine with a 2x3 matrix (AB_BITS fixed-point
    coordinates for INTER_LINEAR); ``dst`` as in
    :func:`warp_perspective`."""
    m = m.to(torch.float32)
    m3 = affine_to_3x3(m) if m.shape[-2] == 2 else m
    return _warp(img, m3, dsize, border_mode, border_value, inverse_map,
                 interpolation, dst, fixed_point_1024=True)


def warp_inverse(
    img: torch.Tensor,
    minv: torch.Tensor,
    dsize: Tuple[int, int],
    quant_affine: bool = False,
    rows: Tuple[int, int] = (0, 0),
    border_mode=constants.BORDER_CONSTANT,
    border_value=0.0,
    interpolation: int = constants.INTER_LINEAR,
) -> torch.Tensor:
    """Warp by an inverse map ``minv`` [3,3] — how the kernels' plain
    versions warp one frame: OpenCV's warpAffine on its top two rows
    (the 1/1024 fixed-point coordinates) when ``quant_affine``, else
    warpPerspective.  ``rows = (oy0, sy0)``: output row y is row ``y +
    oy0`` of a larger frame and ``img`` holds that frame's rows from
    ``sy0`` (a row band; ``csrc/warp.cu``'s row origins)."""
    m3 = minv.to(torch.float32)
    m3 = m3 if m3.shape[-2] == 3 else affine_to_3x3(m3)
    return _warp(img, m3, dsize, border_mode, border_value, True,
                 interpolation, None, quant_affine,
                 (int(rows[0]), int(rows[1])))


def warp_valid_mask(
    m3: torch.Tensor, src_hw: Tuple[int, int], dst_hw: Tuple[int, int],
    inverse_map: bool = True,
) -> torch.Tensor:
    """Float mask of dst pixels whose INTER_NEAREST source tap (the
    UNquantised coordinate, rounded half to even) lands inside the
    source — OpenCV ECC's warp of an all-ones mask."""
    m3 = m3.to(torch.float32)
    m3 = m3 if m3.shape[-2] == 3 else affine_to_3x3(m3)
    if not inverse_map:
        m3 = invert_3x3(m3)
    sx, sy = _dst_coords(m3, dst_hw, perspective=True)
    h, w = src_hw
    xi = torch.round(sx)
    yi = torch.round(sy)
    inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
    return inside.to(torch.float32)
