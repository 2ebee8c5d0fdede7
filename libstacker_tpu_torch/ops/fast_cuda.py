"""FAST-9/16 + NMS + edge band in one pass: the CUDA kernel B8 and its
plain version.

Counterpart of ``libstacker_tpu/ops/fast_pallas.py`` (``_fast_kernel``
:52, ``fast_scores_batched`` :186): ``[N,H,W]`` uint8 (or float32)
images, threshold ``t`` and border ``b`` -> ``[N,H,W]`` float32 NMS'd
FAST score maps (score > 0 <=> kept corner), zero outside
``[b, H-b) x [b, W-b)``.  :func:`fast_scores` runs ``csrc/fast.cu`` for
CUDA tensors and :func:`fast_scores_reference` for CPU tensors.

On the TPU this kernel was opt-in (vector lane permutes made it slower
than XLA's form); a shared-memory tile has no such cost, so it is the
detection route of the port on the card (``ops/orb.py``).  Scores are
integers for uint8 sources, and the kernel equals its plain version
bitwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from . import fast

#: launches of the CUDA kernel since the last reset (one per call)
launch_count = 0

_DTYPE_CODE = {torch.uint8: 0, torch.float32: 2}


def fast_scores_reference(
    imgs: torch.Tensor, threshold: int = 20, border: int = 0
) -> torch.Tensor:
    """Plain PyTorch version: ``fast.fast_detect`` and the edge band
    (``libstacker_tpu/ops/orb.py:245-254``)."""
    det, score = fast.fast_detect(imgs, threshold)
    h, w = imgs.shape[-2], imgs.shape[-1]
    keep = det & fast._interior(h, w, border, imgs.device)
    return torch.where(keep, score, torch.zeros_like(score))


def fast_scores(
    imgs: torch.Tensor, threshold: int = 20, border: int = 0
) -> torch.Tensor:
    """``[N,H,W]`` uint8/float32 -> ``[N,H,W]`` float32 NMS'd FAST
    scores with the edge band ``border``.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/fast.cu`` or raise."""
    if imgs.ndim != 3:
        raise ValueError(f"imgs must be [N,H,W], got {tuple(imgs.shape)}")
    if imgs.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported image dtype {imgs.dtype}")
    threshold, border = int(threshold), int(border)
    if imgs.device.type == "cpu":
        return fast_scores_reference(imgs, threshold, border)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous")
    n, h, w = imgs.shape
    out = torch.empty((n, h, w), dtype=torch.float32, device=imgs.device)
    if n == 0:
        return out
    lib = _lib()
    cuda_build.launch(
        lib, "fast_scores", imgs.device,
        imgs.data_ptr(), out.data_ptr(), n, h, w, _DTYPE_CODE[imgs.dtype],
        float(threshold), border,
    )
    cuda_build.count(globals(), "launch_count")
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fast")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fast_scores.argtypes = [vp, vp, ci, ci, ci, ci, ctypes.c_float, ci, vp]
    lib.fast_scores.restype = ci
    return lib
