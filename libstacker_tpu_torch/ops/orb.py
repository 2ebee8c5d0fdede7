"""ORB keypoint detection + rBRIEF description, batched over frames.

Counterpart of ``libstacker_tpu/ops/orb.py`` (``OrbFeatures`` :47,
``_features_per_level`` :57, ``_ic_angle_weights`` :73,
``_ic_angles_from_patches`` :99, ``_blur_patches_valid`` :116,
``_rbrief_from_patches`` :137, ``orb_detect_and_compute`` :177): OpenCV's
all-default ``ORB::create`` ``detectAndCompute`` (nfeatures 500, scale
1.2, 8 levels, edge 31, WTA_K 2, Harris score, patch 31, FAST 20):

- 8-level INTER_LINEAR pyramid, each level resized from the previous
  uint8 level (``ops/resize.py``);
- per level: FAST-9 with NMS and the edge band (kernel B8 on the card,
  ``ops/fast_cuda.py``), the ``2 * quota`` best candidates by FAST
  score, one 43x43 patch per candidate (kernel B3, ``ops/orb_cuda.py``),
  the ``quota`` best by Harris response, the intensity-centroid angle,
  and steered rBRIEF on the Gaussian-blurred patch.

The JAX package vmaps one frame's detector over the burst; here the
frame axis is written out: ``[N,H,W]`` uint8 in, ``[N,K,...]`` features
out, one call per level for the whole burst.  Every level's output has
a fixed ``quota`` of slots with a validity mask.  An optional detection
mask (cv2 ``detectAndCompute``'s) is shared by every frame.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants
from . import fast, fast_cuda, filters, orb_cuda, resize
from ._orb_pattern import ORB_PATTERN


class OrbFeatures(NamedTuple):
    xy: torch.Tensor  # [N,K,2] float32 — (x, y) in ORIGINAL image coords
    response: torch.Tensor  # [N,K] float32 (Harris)
    angle: torch.Tensor  # [N,K] float32 degrees
    octave: torch.Tensor  # [N,K] int32
    size: torch.Tensor  # [N,K] float32
    valid: torch.Tensor  # [N,K] bool
    descriptors: torch.Tensor  # [N,K,32] uint8


def _features_per_level(nfeatures: int, nlevels: int, scale_factor: float):
    """OpenCV's geometric distribution of features over pyramid levels."""
    factor = 1.0 / scale_factor
    ndesired = nfeatures * (1 - factor) / (1 - factor ** nlevels)
    counts = []
    total = 0
    for _ in range(nlevels - 1):
        n = int(round(ndesired))
        counts.append(n)
        total += n
        ndesired *= factor
    counts.append(max(nfeatures - total, 0))
    return counts


@functools.lru_cache(maxsize=1)
def _ic_angle_weights(half_patch: int = 15):
    """Circular-patch masks for the intensity-centroid angle, built with
    OpenCV's umax construction (symmetric quarter-circle table)."""
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


def _ic_angles_from_patches(
    patches: torch.Tensor, center: int = orb_cuda.PATCH_RADIUS
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
    side = orb_cuda.PATCH_SIDE
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
    c = orb_cuda.PATCH_RADIUS
    side = orb_cuda.PATCH_SIDE
    rx = torch.round(px_ * a - py_ * b).to(torch.int64) + c
    ry = torch.round(px_ * b + py_ * a).to(torch.int64) + c
    flat = patches.reshape(*patches.shape[:-2], side * side)
    vals = torch.gather(flat, -1, ry * side + rx)  # [..., 512]
    bits = (vals[..., :256] < vals[..., 256:]).to(torch.int32)
    weights = (1 << torch.arange(8, device=patches.device, dtype=torch.int32))
    bytes_ = (bits.reshape(*bits.shape[:-1], 32, 8) * weights).sum(-1)
    return bytes_.to(torch.uint8)


def _empty_features(n: int, device) -> OrbFeatures:
    """All-invalid fixed-capacity features (every level too small):
    downstream matching sees 0 keypoints and drops the frame."""
    k = 8
    z = functools.partial(torch.zeros, device=device)
    return OrbFeatures(
        xy=z((n, k, 2), dtype=torch.float32),
        response=z((n, k), dtype=torch.float32),
        angle=z((n, k), dtype=torch.float32),
        octave=z((n, k), dtype=torch.int32),
        size=z((n, k), dtype=torch.float32),
        valid=z((n, k), dtype=torch.bool),
        descriptors=z((n, k, 32), dtype=torch.uint8),
    )


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[n, idx[n, j], ...]`` for ``x`` [N,K,...] and ``idx`` [N,Q]."""
    flat = idx.reshape(*idx.shape, *([1] * (x.ndim - 2)))
    return torch.gather(x, 1, flat.expand(*idx.shape, *x.shape[2:]))


def orb_detect_and_compute(
    imgs: torch.Tensor,
    nfeatures: int = 500,
    scale_factor: float = 1.2,
    nlevels: int = 8,
    edge_threshold: int = 31,
    patch_size: int = 31,
    fast_threshold: int = 20,
    mask: Optional[torch.Tensor] = None,
) -> OrbFeatures:
    """Detect and describe on ``[N,H,W]`` uint8 grey frames ->
    :class:`OrbFeatures` of ``[N,K,...]`` (K = nfeatures on full-size
    images).

    ``mask`` ([H,W], nonzero = valid) is cv2's detection mask, applied to
    every frame as the JAX package applies it (``orb.py`` :185-257): its
    float pyramid is resized level to level with INTER_LINEAR like the
    image and re-binarised at each level (``rint(m * 255) >= 255``: only
    pixels whose whole support was valid survive), and it filters the
    candidates after FAST's non-maximum suppression (a masked stronger
    corner still suppresses its valid neighbours)."""
    if imgs.ndim != 3 or imgs.dtype != torch.uint8:
        raise ValueError(
            f"imgs must be [N,H,W] uint8, got {tuple(imgs.shape)} {imgs.dtype}"
        )
    n, h, w = imgs.shape
    level_mask = None
    if mask is not None:
        mask = torch.as_tensor(mask, device=imgs.device)
        if tuple(mask.shape) != (h, w):
            raise ValueError(f"mask must be [{h},{w}], got {tuple(mask.shape)}")
        level_mask = (mask > 0).to(torch.float32)
    quotas = _features_per_level(nfeatures, nlevels, scale_factor)
    # the patch-space rBRIEF blur needs BLUR_RADIUS + 3 px of interior
    # around every keypoint (see _blur_patches_valid), as in the JAX
    # package (libstacker_tpu/ops/orb.py:202-208)
    edge_threshold = max(edge_threshold, orb_cuda.BLUR_RADIUS + 3)
    br = orb_cuda.BLUR_RADIUS

    level_img = imgs.contiguous()
    feats = []
    for level in range(nlevels):
        scale = scale_factor ** level
        if level > 0:
            lh = int(round(h / scale))
            lw = int(round(w / scale))
            level_img = resize.resize(level_img, (lh, lw),
                                      constants.INTER_LINEAR)
            if level_mask is not None:
                level_mask = resize.resize(level_mask, (lh, lw),
                                           constants.INTER_LINEAR)
                level_mask = (torch.round(level_mask * 255.0) >= 255.0).to(
                    torch.float32)
        lh, lw = level_img.shape[-2:]
        quota = quotas[level]
        if quota == 0 or lh <= 2 * edge_threshold or lw <= 2 * edge_threshold:
            continue
        score = fast_cuda.fast_scores(level_img, fast_threshold,
                                      edge_threshold)
        det = score > 0.0
        if level_mask is not None:
            det = det & (level_mask > 0.5)  # after NMS
        cand = fast.top_k_keypoints(det, score, min(2 * quota, lh * lw))
        del score
        cand_patches = orb_cuda.extract_patches(level_img, cand.ys, cand.xs,
                                                radius=br)
        harris = fast.harris_from_patches(
            cand_patches[..., br - 4 : br + 5, br - 4 : br + 5])
        harris = torch.where(cand.valid, harris,
                             torch.full_like(harris, -math.inf))
        hval, hidx = fast.topk_stable(harris, quota)
        kys = torch.gather(cand.ys, 1, hidx)
        kxs = torch.gather(cand.xs, 1, hidx)
        kvalid = torch.isfinite(hval) & torch.gather(cand.valid, 1, hidx)
        kept_patches = _take(cand_patches, hidx)
        del cand_patches
        angles = _ic_angles_from_patches(kept_patches, center=br)
        desc = _rbrief_from_patches(_blur_patches_valid(kept_patches), angles)
        xy = torch.stack([kxs.to(torch.float32) * scale,
                          kys.to(torch.float32) * scale], dim=-1)
        dev = imgs.device
        feats.append(OrbFeatures(
            xy=xy,
            response=hval,
            angle=angles,
            octave=torch.full((n, quota), level, dtype=torch.int32, device=dev),
            size=torch.full((n, quota), patch_size * scale,
                            dtype=torch.float32, device=dev),
            valid=kvalid,
            descriptors=desc,
        ))
    if not feats:
        return _empty_features(n, imgs.device)
    return OrbFeatures(*(torch.cat(parts, dim=1) for parts in zip(*feats)))
