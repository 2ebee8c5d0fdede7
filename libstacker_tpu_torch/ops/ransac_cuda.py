"""RANSAC's refit on the card: ``csrc/ransac_refit.cu``'s two kernels.

:func:`dlt` is ``ops/ransac._dlt_least_squares`` (the weighted DLT's
smallest eigenvector of the 9x9 Gram, scaled to h22 = 1) and
:func:`refine` is ``ops/ransac._gauss_newton_refine`` (the whole masked
Gauss-Newton polish), each one launch for every frame of a burst, in
float64.  Their plain versions are ``ops/ransac._dlt_plain`` and
``_refine_plain``, which those two functions run for CPU tensors.  The
kernels equal the plain versions run in float64 within 1e-3 px at a 4K
frame's corners, not bitwise.  The float32 plain versions, the path's
arithmetic before the kernels, stop short of the float64 optimum: the
kernels' answers lay within 0.0089 px of theirs on 455 of the cell's 456
frames read on the card and 0.0136 px on one, where the float32 polish
stopped 0.0137 px from the optimum
(``tests/test_torch_ransac_refit.py``).

Replaces no TPU kernel: the JAX package solves both with jnp.  On the
card the plain versions' ``torch.linalg.eigh`` made the host wait for
the card, and their ten polish steps took ~1000 launches a burst.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

#: launches of each kernel since the last reset (one per call)
dlt_launch_count = 0
refine_launch_count = 0


def _check(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor):
    """``(B, M)`` of ``[B,M,2]`` float32 CUDA points and ``[B,M]``
    float32 weights, or raise."""
    if src.ndim != 3 or src.shape[-1] != 2 or dst.shape != src.shape:
        raise ValueError(f"src and dst must be one [B,M,2] shape, got "
                         f"{tuple(src.shape)} and {tuple(dst.shape)}")
    if tuple(weights.shape) != tuple(src.shape[:2]):
        raise ValueError(f"weights must be {tuple(src.shape[:2])}, got "
                         f"{tuple(weights.shape)}")
    for x in (src, dst, weights):
        if x.dtype != torch.float32 or x.device != src.device:
            raise ValueError("points and weights must be float32 on one "
                             "device")
    if src.device.type != "cuda":
        raise ValueError(f"the refit kernels take CUDA tensors, got "
                         f"{src.device}")
    return src.shape[0], src.shape[1]


def dlt(src: torch.Tensor, dst: torch.Tensor,
        weights: torch.Tensor) -> torch.Tensor:
    """``[B,3,3]`` float32: per frame the eigenvector of the least
    eigenvalue of ``A^T A`` (A the weighted DLT rows of ``[B,M,2]``
    ``src`` -> ``dst``), divided by its h22 (1e-12 where that is below
    1e-12 in magnitude)."""
    bsz, m = _check(src, dst, weights)
    out = torch.empty((bsz, 3, 3), dtype=torch.float32, device=src.device)
    if bsz == 0:
        return out
    src, dst, weights = (x.contiguous() for x in (src, dst, weights))
    cuda_build.launch(_lib(), "ransac_dlt", src.device, src.data_ptr(),
                      dst.data_ptr(), weights.data_ptr(), out.data_ptr(),
                      bsz, m)
    cuda_build.count(globals(), "dlt_launch_count")
    return out


def refine(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """``[B,3,3]`` float32 ``h`` polished by ``iters`` masked
    Gauss-Newton steps on the weighted reprojection error of ``src`` ->
    ``dst``, over the 8 entries other than h22; a step is kept only where
    it lowers the weighted sum of squared errors."""
    bsz, m = _check(src, dst, weights)
    if (tuple(h.shape) != (bsz, 3, 3) or h.dtype != torch.float32
            or h.device != src.device):
        raise ValueError(f"h must be [{bsz},3,3] float32 on {src.device}, "
                         f"got {tuple(h.shape)} {h.dtype} on {h.device}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    out = torch.empty_like(h, memory_format=torch.contiguous_format)
    if bsz == 0:
        return out
    h, src, dst, weights = (x.contiguous() for x in (h, src, dst, weights))
    cuda_build.launch(_lib(), "ransac_refine", src.device, h.data_ptr(),
                      src.data_ptr(), dst.data_ptr(), weights.data_ptr(),
                      out.data_ptr(), bsz, m, int(iters))
    cuda_build.count(globals(), "refine_launch_count")
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("ransac_refit")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ransac_dlt.argtypes = [vp] * 4 + [ci] * 2 + [vp]
    lib.ransac_dlt.restype = ci
    lib.ransac_refine.argtypes = [vp] * 5 + [ci] * 3 + [vp]
    lib.ransac_refine.restype = ci
    return lib
