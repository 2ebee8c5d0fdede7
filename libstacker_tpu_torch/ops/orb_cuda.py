"""Per-keypoint patch extraction: the CUDA kernel B3 and its plain
version.

Counterpart of ``libstacker_tpu/ops/orb_pallas.py`` (``PATCH_RADIUS``
:39, ``BLUR_RADIUS`` :42, ``_extract_kernel`` :54,
``extract_patches_batched`` :85, the gather branch of
``extract_patches`` :216-223): ``[N,H,W]`` level images and ``[N,K]``
int32 keypoint rows / columns -> ``[N,K,side,side]`` float32 patches,
``side = 2 * radius + 1``, with the patch origin clamped to
``[0, H-side] x [0, W-side]``.  :func:`extract_patches` runs
``csrc/orb_extract.cu`` for CUDA tensors and
:func:`extract_patches_reference` (one advanced-indexing gather) for
CPU tensors.  The kernel reads uint8 levels and widens them itself; its
output equals the plain version's bitwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build

PATCH_RADIUS = 18
PATCH_SIDE = 2 * PATCH_RADIUS + 1  # 37
# radius carrying the rBRIEF taps PLUS the Gaussian(7) blur support
BLUR_RADIUS = PATCH_RADIUS + 3
BLUR_SIDE = 2 * BLUR_RADIUS + 1  # 43

#: launches of the CUDA kernel since the last reset (one per call)
launch_count = 0

_DTYPE_CODE = {torch.uint8: 0, torch.float32: 2}


def _check(imgs, ys, xs, radius):
    if imgs.ndim != 3:
        raise ValueError(f"imgs must be [N,H,W], got {tuple(imgs.shape)}")
    if imgs.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported image dtype {imgs.dtype}")
    n, h, w = imgs.shape
    if ys.shape != xs.shape or ys.ndim != 2 or ys.shape[0] != n:
        raise ValueError(
            f"ys and xs must be [{n},K], got {tuple(ys.shape)} and "
            f"{tuple(xs.shape)}"
        )
    side = 2 * radius + 1
    if h < side or w < side:
        raise ValueError(f"image {h}x{w} is smaller than a {side}px patch")


def extract_patches_reference(
    imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
    radius: int = PATCH_RADIUS,
) -> torch.Tensor:
    """Plain PyTorch version: one advanced-indexing gather of the
    clamped windows, cast to float32."""
    _check(imgs, ys, xs, radius)
    n, h, w = imgs.shape
    side = 2 * radius + 1
    y0 = torch.clamp(ys.long() - radius, 0, h - side)
    x0 = torch.clamp(xs.long() - radius, 0, w - side)
    offs = torch.arange(side, device=imgs.device)
    py = y0[..., None, None] + offs[:, None]
    px = x0[..., None, None] + offs[None, :]
    b = torch.arange(n, device=imgs.device)[:, None, None, None]
    return imgs[b, py, px].to(torch.float32)


def extract_patches(
    imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
    radius: int = PATCH_RADIUS,
) -> torch.Tensor:
    """``[N,H,W]`` uint8/float32 images, ``[N,K]`` keypoints ->
    ``[N,K,side,side]`` float32 patches.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/orb_extract.cu`` or raise."""
    global launch_count
    _check(imgs, ys, xs, radius)
    if imgs.device.type == "cpu":
        return extract_patches_reference(imgs, ys, xs, radius)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous")
    n, h, w = imgs.shape
    k = ys.shape[1]
    side = 2 * radius + 1
    out = torch.empty((n, k, side, side), dtype=torch.float32,
                      device=imgs.device)
    if n == 0 or k == 0:
        return out
    ys32 = ys.to(device=imgs.device, dtype=torch.int32).contiguous()
    xs32 = xs.to(device=imgs.device, dtype=torch.int32).contiguous()
    lib = _lib()
    err = lib.extract_patches(
        imgs.data_ptr(), ys32.data_ptr(), xs32.data_ptr(), out.data_ptr(),
        n, k, h, w, radius, _DTYPE_CODE[imgs.dtype],
        torch.cuda.current_stream(imgs.device).cuda_stream,
    )
    cuda_build.check(lib, err, "extract_patches")
    launch_count += 1
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("orb_extract")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.extract_patches.argtypes = [vp] * 4 + [ci] * 6 + [vp]
    lib.extract_patches.restype = ci
    return lib
