"""Fused RGB warp + stack sums: the CUDA kernels B2 and B4 and their
plain versions.

Counterpart of ``libstacker_tpu/ops/warp_accum_pallas.py``
(``_warp_accum_kernel`` :47; ``warp_accum_rgb_pallas`` :267 with
``moments=False``, ``warp_moments_rgb_pallas`` :291 with
``moments=True``):

- B2, :func:`warp_accum_rgb`:
  ``out[y, x, :] = sum_n valid[n] * warp(frames[n], minv[n])[y, x, :]``
  with BORDER_CONSTANT (per-channel value);
- B4, :func:`warp_moments_rgb`: the per-pixel moments S0, S1, S2 of the
  covered samples, optionally only those within ``tol`` of ``mu``
  (the passes of sigma-clip stacking, ``ops/stack.py``).

Both use OpenCV's 1/32-px quantisation.  CUDA tensors run
``csrc/warp_accum.cu`` or raise; CPU tensors take
:func:`warp_accum_rgb_reference` / :func:`warp_moments_rgb_reference`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..utils import cuda_build
from . import color, warp

#: launches of B2 (``warp_accum_rgb``) since the last reset
launch_count = 0
#: launches of B4 (``warp_moments_rgb``) since the last reset
moments_launch_count = 0

_DTYPE_CODE = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_SCALE = {torch.uint8: color.U8_SCALE, torch.uint16: color.U16_SCALE,
          torch.float32: 1.0}


def _border3(border_value, device) -> torch.Tensor:
    return torch.as_tensor(
        border_value, dtype=torch.float32, device=device
    ).reshape(-1).expand(3).contiguous()


def warp_accum_rgb_reference(
    frames: torch.Tensor,
    minv: torch.Tensor,
    valid: torch.Tensor,
    border_value=0.0,
    quant_affine: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version: warp each frame with ``ops/warp.py`` and
    add ``warped * valid[n]`` to the running sum, frame by frame."""
    n, h, w, _ = frames.shape
    bv = _border3(border_value, frames.device)
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=frames.device)
    vf = valid.to(device=frames.device, dtype=torch.float32)
    for i in range(n):
        wp = warp.warp_inverse(color.to_unit_f32(frames[i]), minv[i], (h, w),
                               quant_affine, border_value=bv)
        acc = acc + wp * vf[i]
    return acc


def _check_burst(frames, minv, valid) -> None:
    """Shapes and types both kernels take (on any device)."""
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be [N,H,W,3], got {tuple(frames.shape)}")
    if frames.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported frame dtype {frames.dtype}")
    n = frames.shape[0]
    if tuple(minv.shape) != (n, 3, 3) or tuple(valid.shape) != (n,):
        raise ValueError(
            f"minv must be [{n},3,3] and valid [{n}], got "
            f"{tuple(minv.shape)} and {tuple(valid.shape)}"
        )
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {frames.device}")
    if frames.device.type == "cuda":
        if not frames.is_contiguous():
            raise ValueError("frames must be contiguous")
        if minv.dtype != torch.float32 or minv.device != frames.device:
            raise ValueError(f"minv must be float32 on {frames.device}")


def warp_accum_rgb(
    frames: torch.Tensor,
    minv: torch.Tensor,
    valid: torch.Tensor,
    border_value=0.0,
    quant_affine: bool = False,
) -> torch.Tensor:
    """``sum_n valid[n] * warp(frames[n], minv[n])`` -> ``[H,W,3]`` f32.

    ``frames`` [N,H,W,3] uint8/uint16/float32, ``minv`` [N,3,3] inverse
    maps, ``valid`` [N] (bool or float), ``border_value`` scalar or
    [3].  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/warp_accum.cu`` or raise."""
    _check_burst(frames, minv, valid)
    n, h, w, _ = frames.shape
    if frames.device.type == "cpu":
        return warp_accum_rgb_reference(
            frames, minv, valid, border_value, quant_affine
        )
    dev = frames.device
    minv = minv.contiguous()
    vf = valid.to(device=dev, dtype=torch.float32).contiguous()
    # on the host: the kernel takes the border value by value
    bv = _border3(border_value, "cpu").tolist()
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    lib = _lib()
    cuda_build.launch(
        lib, "warp_accum_rgb", dev,
        frames.data_ptr(), minv.data_ptr(), vf.data_ptr(), out.data_ptr(),
        n, h, w, _DTYPE_CODE[frames.dtype], int(not quant_affine),
        _SCALE[frames.dtype], *bv,
    )
    cuda_build.count(globals(), "launch_count")
    return out


def coverage(minv: torch.Tensor, hw: Tuple[int, int],
             perspective: bool) -> torch.Tensor:
    """[H,W] bool: output pixels whose UNquantised source coordinate
    under the inverse map ``minv`` [3,3] lies inside the frame (every
    nonzero-weight tap is interior), and, for a homography, in front of
    the camera (``den > 1e-6``): ``libstacker_tpu/ops/stack.py
    _coverage`` :112-136 in B4's order of operations."""
    h, w = hw
    sx, sy = warp._dst_coords(minv.to(torch.float32), hw, perspective)
    ok = (sx >= 0.0) & (sx <= w - 1.0) & (sy >= 0.0) & (sy <= h - 1.0)
    if perspective:
        m = minv.to(torch.float32)
        ys = torch.arange(h, dtype=torch.float32, device=m.device)[:, None]
        xs = torch.arange(w, dtype=torch.float32, device=m.device)[None, :]
        ok &= m[2, 0] * xs + m[2, 1] * ys + m[2, 2] > 1e-6
    return ok


def warp_moments_rgb_reference(
    frames: torch.Tensor,
    minv: torch.Tensor,
    valid: torch.Tensor,
    mu: Optional[torch.Tensor] = None,
    tol: Optional[torch.Tensor] = None,
    quant_affine: bool = False,
):
    """Plain PyTorch version of :func:`warp_moments_rgb`: warp each frame
    with ``ops/warp.py`` (BORDER_CONSTANT 0), mask it by coverage,
    validity and the clip test, and add to the sums frame by frame."""
    n, h, w, _ = frames.shape
    dev = frames.device
    s0, s1, s2 = (torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
                  for _ in range(3))
    vf = valid.to(device=dev, dtype=torch.float32)
    for i in range(n):
        v = warp.warp_inverse(color.to_unit_f32(frames[i]), minv[i], (h, w),
                              quant_affine)
        m = coverage(minv[i], (h, w), not quant_affine).to(torch.float32)
        m = (m * vf[i])[..., None].expand(h, w, 3)
        if mu is not None:
            m = m * (torch.abs(v - mu) <= tol).to(torch.float32)
        c1 = m * v
        s0 = s0 + m
        s1 = s1 + c1
        s2 = s2 + c1 * v
    return s0, s1, s2


def warp_moments_rgb(
    frames: torch.Tensor,
    minv: torch.Tensor,
    valid: torch.Tensor,
    mu: Optional[torch.Tensor] = None,
    tol: Optional[torch.Tensor] = None,
    quant_affine: bool = False,
):
    """Per-pixel moments of the warped burst -> ``(S0, S1, S2)``, each
    ``[H,W,3]`` float32:

        S0 = sum_n m_n,  S1 = sum_n m_n v_n,  S2 = sum_n (m_n v_n) v_n

    ``v_n`` is frame n warped by ``minv[n]``; ``m_n`` is its coverage
    (:func:`coverage`) times ``valid[n]`` and, when ``mu`` / ``tol``
    ([H,W,3] float32) are given, the per-channel clip test
    ``|v_n - mu| <= tol``.  ``frames`` [N,H,W,3] uint8 / uint16 /
    float32.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/warp_accum.cu`` or raise."""
    if (mu is None) != (tol is None):
        raise ValueError("mu and tol must be given together")
    _check_burst(frames, minv, valid)
    n, h, w, _ = frames.shape
    for name, x in (("mu", mu), ("tol", tol)):
        if x is not None and tuple(x.shape) != (h, w, 3):
            raise ValueError(f"{name} must be [{h},{w},3], got {tuple(x.shape)}")
    if frames.device.type == "cpu":
        return warp_moments_rgb_reference(frames, minv, valid, mu, tol,
                                          quant_affine)
    dev = frames.device
    for name, x in (("mu", mu), ("tol", tol)):
        if x is not None and (x.dtype != torch.float32 or x.device != dev):
            raise ValueError(f"{name} must be float32 on {dev}")
    minv = minv.contiguous()
    mu, tol = (None if x is None else x.contiguous() for x in (mu, tol))
    vf = valid.to(device=dev, dtype=torch.float32).contiguous()
    s0, s1, s2 = (torch.empty((h, w, 3), dtype=torch.float32, device=dev)
                  for _ in range(3))
    lib = _lib()
    cuda_build.launch(
        lib, "warp_moments_rgb", dev,
        frames.data_ptr(), minv.data_ptr(), vf.data_ptr(),
        None if mu is None else mu.data_ptr(),
        None if tol is None else tol.data_ptr(),
        s0.data_ptr(), s1.data_ptr(), s2.data_ptr(), n, h, w,
        _DTYPE_CODE[frames.dtype], int(not quant_affine),
        _SCALE[frames.dtype],
    )
    cuda_build.count(globals(), "moments_launch_count")
    return s0, s1, s2


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("warp_accum")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.warp_accum_rgb.argtypes = (
        [vp] * 4 + [ci] * 5 + [ctypes.c_float] * 4 + [vp]
    )
    lib.warp_accum_rgb.restype = ci
    lib.warp_moments_rgb.argtypes = (
        [vp] * 8 + [ci] * 5 + [ctypes.c_float, vp]
    )
    lib.warp_moments_rgb.restype = ci
    return lib
