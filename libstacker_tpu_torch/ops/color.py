"""Color conversion and dtype normalisation.

Counterpart of ``libstacker_tpu/ops/color.py`` (``rgb_to_gray_u8`` :26,
``rgb_to_gray_f32`` :40, ``u8_to_f32`` :50, ``depth_reduce_u8`` :56,
``to_unit_f32`` :70).  The
grey is OpenCV's shift-15 fixed-point Rec.601 luma, bit-exact
(:func:`burst_grey_u8` is every pipeline's first stage); the unit
scale multiplies by the float32 constant 1/255 (or 1/65535), which the
warp-accumulate kernel repeats per tap so that its u8-source path equals
feeding :func:`to_unit_f32` bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resize

_R2Y = 9798
_G2Y = 19235
_B2Y = 3735  # = 2^15 - R2Y - G2Y
_SHIFT = 15

#: float32 scale constants (exact float32 values, as Python floats: a
#: float32 x float32 product is the same whether PyTorch evaluates it in
#: float32 or in double and rounds)
U8_SCALE = float(np.float32(1.0 / 255.0))
U16_SCALE = float(np.float32(1.0 / 65535.0))

# frames per chunk of the burst grey (bounds its int32 transients)
_GREY_CHUNK = 16


def depth_reduce_u8(img: torch.Tensor) -> torch.Tensor:
    """uint16 -> high-byte uint8; uint8 passes through."""
    if img.dtype == torch.uint16:
        return (img.to(torch.int32) >> 8).to(torch.uint8)
    return img


def rgb_to_gray_u8(rgb: torch.Tensor) -> torch.Tensor:
    """``[..., H, W, 3]`` uint8 (or uint16) RGB -> ``[..., H, W]`` uint8
    grey, ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``."""
    rgb = depth_reduce_u8(rgb)
    acc = rgb[..., 0].to(torch.int32) * _R2Y
    acc += rgb[..., 1].to(torch.int32) * _G2Y
    acc += rgb[..., 2].to(torch.int32) * _B2Y
    acc += 1 << (_SHIFT - 1)
    return (acc >> _SHIFT).to(torch.uint8)


def burst_grey_u8(frames: torch.Tensor, scale_hw=None) -> torch.Tensor:
    """``[N,H,W,3]`` uint8 (or uint16, greyed on its high byte) burst ->
    ``[N,H,W]`` uint8 grey, INTER_AREA-scaled to ``scale_hw`` when given
    (rounded back to u8, as the reference scales the grey Mat), in
    chunks of ``_GREY_CHUNK`` frames."""
    out = []
    for s in range(0, frames.shape[0], _GREY_CHUNK):
        grey = rgb_to_gray_u8(frames[s : s + _GREY_CHUNK])
        if scale_hw is not None:
            grey = resize.resize(grey, scale_hw)
        out.append(grey)
    return torch.cat(out)


def rgb_to_gray_f32(rgb: torch.Tensor) -> torch.Tensor:
    """Float Rec.601 luma for float inputs (no fixed-point rounding):
    each channel times its float32 weight, summed R, G, B in order."""
    scale = 1.0 / (1 << _SHIFT)
    x = rgb.to(torch.float32)
    out = x[..., 0] * float(np.float32(_R2Y * scale))
    out += x[..., 1] * float(np.float32(_G2Y * scale))
    out += x[..., 2] * float(np.float32(_B2Y * scale))
    return out


def u8_to_f32(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1] (``x * float32(1/255)``)."""
    return img.to(torch.float32) * U8_SCALE


def to_unit_f32(img: torch.Tensor) -> torch.Tensor:
    """Frames -> float32 in [0, 1] at native depth: uint8 * 1/255,
    uint16 * 1/65535; float passes through as float32."""
    if img.dtype == torch.uint16:
        return img.to(torch.float32) * U16_SCALE
    if img.dtype.is_floating_point:
        return img.to(torch.float32)
    return u8_to_f32(img)
