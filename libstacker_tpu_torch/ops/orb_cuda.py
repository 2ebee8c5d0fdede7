"""Per-keypoint ORB kernels and their plain versions: B3 (patch
extraction), B3h (Harris at the candidates) and B3d (angle and rBRIEF at
the kept keypoints).

Counterpart of ``libstacker_tpu/ops/orb_pallas.py`` (``PATCH_RADIUS``
:39, ``BLUR_RADIUS`` :42, ``_extract_kernel`` :54,
``extract_patches_batched`` :85, the gather branch of
``extract_patches`` :216-223) and of the chain that read its patches in
``libstacker_tpu/ops/orb.py`` (``_ic_angle_weights`` :73,
``_ic_angles_from_patches`` :99, ``_blur_patches_valid`` :116,
``_rbrief_from_patches`` :137).  Windows are clamped to
``[0, H-side] x [0, W-side]``, ``side = 2 * radius + 1``.

- :func:`extract_patches` (B3, ``csrc/orb_extract.cu``): ``[N,H,W]``
  levels and ``[N,K]`` int32 rows / columns -> ``[N,K,side,side]``
  float32 patches.  It equals :func:`extract_patches_reference` (one
  advanced-indexing gather) bitwise.  The ORB path no longer calls it.
- :func:`candidate_harris` (B3h, ``csrc/orb_describe.cu``): the Harris
  response of each candidate's 9x9 window centre, -inf where invalid.
- :func:`describe` (B3d, same source): the intensity-centroid angle and
  the 32-byte steered rBRIEF descriptor of each kept keypoint.

B3h and B3d keep every 43x43 window in shared memory, so no patch
tensor exists on the CUDA path.  Their plain versions are the chain they
replace, on :func:`extract_patches_reference` windows, with Harris's
block sums exact (``fast.harris_from_patches``), and the kernels equal
them bitwise.  CUDA tensors launch the kernels or raise; CPU tensors
take the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..utils import cuda_build
from . import fast, filters
from ._orb_pattern import ORB_PATTERN

PATCH_RADIUS = 18
PATCH_SIDE = 2 * PATCH_RADIUS + 1  # 37
# radius carrying the rBRIEF taps PLUS the Gaussian(7) blur support
BLUR_RADIUS = PATCH_RADIUS + 3
BLUR_SIDE = 2 * BLUR_RADIUS + 1  # 43

#: launches of B3 (``extract_patches``) since the last reset
launch_count = 0
#: launches of B3h (``candidate_harris``) since the last reset
harris_launch_count = 0
#: launches of B3d (``describe``) since the last reset
describe_launch_count = 0
# Harris on the 9x9 centre of a BLUR_RADIUS window: its block origin
HARRIS_ORIGIN = BLUR_RADIUS - 4
HARRIS_K = 0.04
IC_HALF = 15

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
    cuda_build.launch(
        lib, "extract_patches", imgs.device,
        imgs.data_ptr(), ys32.data_ptr(), xs32.data_ptr(), out.data_ptr(),
        n, k, h, w, radius, _DTYPE_CODE[imgs.dtype],
    )
    cuda_build.count(globals(), "launch_count")
    return out


@functools.lru_cache(maxsize=1)
def _ic_umax(half_patch: int = IC_HALF):
    """OpenCV's umax: the half-width of the circular patch in each row
    0..half_patch (the symmetric quarter-circle construction)."""
    umax = [0] * (half_patch + 2)
    vmax = int(math.floor(half_patch * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(half_patch * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(half_patch * half_patch - v * v)))
    v0 = 0
    for v in range(half_patch, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return tuple(umax[: half_patch + 1])


@functools.lru_cache(maxsize=1)
def _ic_angle_weights(half_patch: int = IC_HALF):
    """Circular-patch masks for the intensity-centroid angle, built with
    OpenCV's umax construction (symmetric quarter-circle table)."""
    umax = _ic_umax(half_patch)
    side = 2 * half_patch + 1
    us = np.arange(-half_patch, half_patch + 1)[None, :]
    vs = np.arange(-half_patch, half_patch + 1)[:, None]
    inside = np.abs(us) <= np.array(
        [umax[abs(int(v))] for v in vs.ravel()]
    ).reshape(side, 1)
    wu = (us * inside).astype(np.float32)
    wv = (vs * inside).astype(np.float32)
    return wu, wv


@functools.lru_cache(maxsize=None)
def _constants_on(device: torch.device):
    """``(wu, wv, pattern)``: the IC-angle weights and the rBRIEF pattern
    as float32 tensors on ``device``, copied once (a copy from pageable
    host memory synchronises the device's stream)."""
    arrays = (*_ic_angle_weights(), ORB_PATTERN.astype(np.float32))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@functools.lru_cache(maxsize=1)
def _blur_taps():
    """The 7 taps of ``_blur_patches_valid``'s Gaussian as a C float
    array (each the float32 a tensor product rounds it to)."""
    return (ctypes.c_float * 7)(*filters.gaussian_kernel(7, 2.0))


@functools.lru_cache(maxsize=None)
def _describe_constants_on(device: torch.device) -> torch.Tensor:
    """B3d's device buffer, copied once: the 256 rBRIEF pattern rows as
    int8 (x1, y1, x2, y2) words, then the 16 circle row extents."""
    words = ORB_PATTERN.astype(np.int8).reshape(-1).view(np.int32)
    buf = np.concatenate([words, np.asarray(_ic_umax(), np.int32)])
    return torch.from_numpy(buf).to(device)


def _ic_angles_from_patches(
    patches: torch.Tensor, center: int = PATCH_RADIUS
) -> torch.Tensor:
    """Intensity-centroid orientation (degrees in [0,360)) from
    ``[..., side, side]`` keypoint patches (the radius-15 circular
    weights sit in the central 31x31 around ``center``)."""
    wu, wv, _ = _constants_on(patches.device)
    c = center
    sub = patches[..., c - 15 : c + 16, c - 15 : c + 16]
    m10 = torch.sum(sub * wu, dim=(-2, -1))
    m01 = torch.sum(sub * wv, dim=(-2, -1))
    ang = torch.atan2(m01, m10) * (180.0 / math.pi)
    return torch.where(ang < 0, ang + 360.0, ang)


def _blur_patches_valid(patches: torch.Tensor) -> torch.Tensor:
    """GaussianBlur(7x7, sigma 2) of ``[..., 43, 43]`` raw patches, VALID
    mode -> ``[..., 37, 37]``: identical to blurring the whole level image
    and extracting 37x37, because ORB's edge threshold keeps the blur
    support of every tap inside the image."""
    kern = filters.gaussian_kernel(7, 2.0)
    side = PATCH_SIDE
    rows = None
    for i, kw in enumerate(kern):
        term = kw * patches[..., i : i + side, :]
        rows = term if rows is None else rows + term
    out = None
    for i, kw in enumerate(kern):
        term = kw * rows[..., :, i : i + side]
        out = term if out is None else out + term
    return out


def _rbrief_from_patches(
    patches: torch.Tensor, angles_deg: torch.Tensor
) -> torch.Tensor:
    """Steered rBRIEF bits from ``[..., 37, 37]`` blurred-image patches
    -> ``[..., 32]`` uint8 (LSB-first packing); taps are
    ``round(x cos - y sin)``, ``round(x sin + y cos)`` (half to even)."""
    pat = _constants_on(patches.device)[2]
    ang = angles_deg * (math.pi / 180.0)
    a = torch.cos(ang)[..., None]
    b = torch.sin(ang)[..., None]
    px_ = torch.cat([pat[:, 0], pat[:, 2]])  # [512]
    py_ = torch.cat([pat[:, 1], pat[:, 3]])
    c = PATCH_RADIUS
    side = PATCH_SIDE
    rx = torch.round(px_ * a - py_ * b).to(torch.int64) + c
    ry = torch.round(px_ * b + py_ * a).to(torch.int64) + c
    flat = patches.reshape(*patches.shape[:-2], side * side)
    vals = torch.gather(flat, -1, ry * side + rx)  # [..., 512]
    bits = (vals[..., :256] < vals[..., 256:]).to(torch.int32)
    weights = (1 << torch.arange(8, device=patches.device, dtype=torch.int32))
    bytes_ = (bits.reshape(*bits.shape[:-1], 32, 8) * weights).sum(-1)
    return bytes_.to(torch.uint8)


def _check_level(imgs, ys, xs) -> None:
    """What B3h and B3d take on any device: u8 levels of at least one
    43x43 window, ``[N,K]`` keypoints."""
    if imgs.ndim != 3 or imgs.dtype != torch.uint8:
        raise ValueError(f"imgs must be [N,H,W] uint8, got "
                         f"{tuple(imgs.shape)} {imgs.dtype}")
    _check(imgs, ys, xs, BLUR_RADIUS)


def _cuda_args(imgs, *index):
    """Contiguous int32 copies of the keypoint tensors on the level's
    device (the kernels read them raw)."""
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous")
    return [t.to(device=imgs.device, dtype=torch.int32).contiguous()
            for t in index]


def candidate_harris_reference(
    imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`candidate_harris`: the
    ``BLUR_RADIUS`` windows, ``fast.harris_from_patches`` on their 9x9
    centres, -inf where ``valid`` is False."""
    _check_level(imgs, ys, xs)
    o = HARRIS_ORIGIN
    patches = extract_patches_reference(imgs, ys, xs, BLUR_RADIUS)
    harris = fast.harris_from_patches(patches[..., o : o + 9, o : o + 9],
                                      harris_k=HARRIS_K)
    return torch.where(valid.to(harris.device), harris,
                       torch.full_like(harris, -math.inf))


def candidate_harris(
    imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Harris response (ORB's HarrisResponses: block 7, k 0.04) of the
    9x9 centre of each candidate's clamped 43x43 window -> ``[N,K]``
    float32, -inf where ``valid`` [N,K] is False.  ``imgs`` [N,H,W]
    uint8, ``ys`` / ``xs`` [N,K].  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/orb_describe.cu`` or raise."""
    _check_level(imgs, ys, xs)
    if tuple(valid.shape) != tuple(ys.shape):
        raise ValueError(f"valid must be {tuple(ys.shape)}, got "
                         f"{tuple(valid.shape)}")
    if imgs.device.type == "cpu":
        return candidate_harris_reference(imgs, ys, xs, valid)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    n, h, w = imgs.shape
    k = ys.shape[1]
    out = torch.empty((n, k), dtype=torch.float32, device=imgs.device)
    if n == 0 or k == 0:
        return out
    ys32, xs32 = _cuda_args(imgs, ys, xs)
    vb = valid.to(device=imgs.device, dtype=torch.bool).contiguous()
    lib = _lib("orb_describe")
    cuda_build.launch(
        lib, "candidate_harris", imgs.device,
        imgs.data_ptr(), ys32.data_ptr(), xs32.data_ptr(), vb.data_ptr(),
        out.data_ptr(), n, k, h, w, HARRIS_K, fast.harris_scale4(),
    )
    cuda_build.count(globals(), "harris_launch_count")
    return out


def describe_reference(
    imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
):
    """Plain PyTorch version of :func:`describe`: the ``BLUR_RADIUS``
    windows, then the IC angle, the VALID blur and steered rBRIEF."""
    _check_level(imgs, ys, xs)
    patches = extract_patches_reference(imgs, ys, xs, BLUR_RADIUS)
    angles = _ic_angles_from_patches(patches, center=BLUR_RADIUS)
    return angles, _rbrief_from_patches(_blur_patches_valid(patches), angles)


def describe(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Intensity-centroid angle (degrees in [0,360)) and steered rBRIEF
    descriptor of each keypoint -> ``(angle [N,Q] float32, desc
    [N,Q,32] uint8)``, from its clamped 43x43 window.  ``imgs`` [N,H,W]
    uint8, ``ys`` / ``xs`` [N,Q].  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/orb_describe.cu`` or raise."""
    _check_level(imgs, ys, xs)
    if imgs.device.type == "cpu":
        return describe_reference(imgs, ys, xs)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    n, h, w = imgs.shape
    q = ys.shape[1]
    dev = imgs.device
    angle = torch.empty((n, q), dtype=torch.float32, device=dev)
    desc = torch.empty((n, q, 32), dtype=torch.uint8, device=dev)
    if n == 0 or q == 0:
        return angle, desc
    ys32, xs32 = _cuda_args(imgs, ys, xs)
    lib = _lib("orb_describe")
    cuda_build.launch(
        lib, "orb_describe", dev,
        imgs.data_ptr(), ys32.data_ptr(), xs32.data_ptr(),
        _describe_constants_on(dev).data_ptr(), _blur_taps(),
        angle.data_ptr(),
        desc.data_ptr(), n, q, h, w, 180.0 / math.pi, math.pi / 180.0,
    )
    cuda_build.count(globals(), "describe_launch_count")
    return angle, desc


@functools.lru_cache(maxsize=None)
def _lib(name: str = "orb_extract") -> ctypes.CDLL:
    lib = cuda_build.load(name)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "orb_extract":
        lib.extract_patches.argtypes = [vp] * 4 + [ci] * 6 + [vp]
        lib.extract_patches.restype = ci
    else:
        lib.candidate_harris.argtypes = [vp] * 5 + [ci] * 4 + [cf, cf, vp]
        lib.candidate_harris.restype = ci
        lib.orb_describe.argtypes = ([vp] * 4 + [ctypes.POINTER(cf)]
                                     + [vp] * 2 + [ci] * 4 + [cf, cf, vp])
        lib.orb_describe.restype = ci
    return lib
