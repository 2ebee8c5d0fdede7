"""The burst grey in one pass: ``csrc/grey.cu`` and its plain version.

:func:`grey` takes ``[..., H, W, 3]`` contiguous uint8 or uint16 RGB
(uint16 greyed on its high byte) and returns ``[..., H, W]`` OpenCV's
shift-15 fixed-point Rec.601 luma, ``(9798 R + 19235 G + 3735 B + 2^14)
>> 15``, as uint8 or as the same values in float32 (the ECC path's input).
CUDA tensors launch the kernel (one launch a call, none for an empty
burst) or raise; CPU tensors take the plain version
:func:`grey_reference`: the int32 chain, ``ops/color._GREY_CHUNK`` frames
a pass.  The two are bitwise equal.

Replaces no TPU kernel: the JAX package's grey is XLA-level jnp
(``libstacker_tpu/ops/color.py`` :26).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

#: launches of csrc/grey.cu since the last reset: one a call
launch_count = 0

#: the fixed-point Rec.601 weights, summing to 2^SHIFT
R2Y = 9798
G2Y = 19235
B2Y = 3735  # = 2^15 - R2Y - G2Y
SHIFT = 15

#: the dtypes read and written, and their codes in csrc/grey.cu
IN_DTYPES = {torch.uint8: 0, torch.uint16: 1}
OUT_DTYPES = {torch.uint8: 0, torch.float32: 1}


def _check(rgb: torch.Tensor, out_dtype: torch.dtype) -> None:
    """Raise where the kernel or the plain version refuses ``rgb``."""
    if rgb.ndim < 3 or rgb.shape[-1] != 3 or rgb.dtype not in IN_DTYPES:
        raise ValueError(f"rgb must be [..., H, W, 3] uint8 or uint16, got "
                         f"{rgb.dtype} {tuple(rgb.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be uint8 or float32, got "
                         f"{out_dtype}")
    if not rgb.is_contiguous():
        raise ValueError("rgb must be contiguous")


def grey(rgb: torch.Tensor, out_dtype: torch.dtype = torch.uint8
         ) -> torch.Tensor:
    """``[..., H, W]`` grey of ``[..., H, W, 3]`` contiguous RGB, as
    ``out_dtype`` (uint8 or float32).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/grey.cu`` or raise."""
    _check(rgb, out_dtype)
    if rgb.device.type == "cpu":
        return grey_reference(rgb, out_dtype)
    if rgb.device.type != "cuda":
        raise ValueError(f"unsupported device {rgb.device}")
    out = torch.empty(rgb.shape[:-1], dtype=out_dtype, device=rgb.device)
    if out.numel() == 0:
        return out
    cuda_build.launch(_lib(), "grey", rgb.device, rgb.data_ptr(),
                      out.data_ptr(), out.numel(), IN_DTYPES[rgb.dtype],
                      OUT_DTYPES[out_dtype], _sms(rgb.device))
    cuda_build.count(globals(), "launch_count")
    return out


def grey_reference(rgb: torch.Tensor, out_dtype: torch.dtype = torch.uint8
                   ) -> torch.Tensor:
    """The plain version: the int32 chain on ``ops/color._GREY_CHUNK``
    frames at a time (along the leading axis; one frame at once),
    narrowed to uint8, then widened to float32 for a float32 output."""
    from . import color  # its depth_reduce_u8 and _GREY_CHUNK

    _check(rgb, out_dtype)
    burst = rgb if rgb.ndim > 3 else rgb[None]
    out = torch.empty(burst.shape[:-1], dtype=out_dtype, device=rgb.device)
    chunk = color._GREY_CHUNK
    for s in range(0, burst.shape[0], chunk):
        out[s : s + chunk] = _luma_u8(color.depth_reduce_u8(
            burst[s : s + chunk]))
    return out if rgb.ndim > 3 else out[0]


def _luma_u8(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., 3]`` -> the uint8 grey, through int32."""
    acc = rgb[..., 0].to(torch.int32) * R2Y
    acc += rgb[..., 1].to(torch.int32) * G2Y
    acc += rgb[..., 2].to(torch.int32) * B2Y
    acc += 1 << (SHIFT - 1)
    return (acc >> SHIFT).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("grey")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.grey.argtypes = [vp, vp, ctypes.c_longlong, ci, ci, ci, vp]
    lib.grey.restype = ci
    return lib
