"""ORB keypoint detection + rBRIEF description, batched over frames.

Counterpart of ``libstacker_tpu/ops/orb.py`` (``OrbFeatures`` :47,
``_features_per_level`` :57, ``orb_detect_and_compute`` :177): OpenCV's
all-default ``ORB::create`` ``detectAndCompute`` (nfeatures 500, scale
1.2, 8 levels, edge 31, WTA_K 2, Harris score, patch 31, FAST 20):

- 8-level INTER_LINEAR pyramid, each level resized from the previous
  uint8 level (``ops/resize.py``);
- per level: FAST-9 with NMS and the edge band (kernel B8 on the card,
  ``ops/fast_cuda.py``), the ``2 * quota`` best candidates by FAST
  score, their Harris responses on the 9x9 centre of each clamped 43x43
  window and the ``quota`` best by Harris response (kernel B3h, one
  launch, ``ops/orb_cuda.select_keypoints``), and at those the
  intensity-centroid angle and steered rBRIEF on the Gaussian-blurred
  window (kernel B3d, ``ops/orb_cuda.describe``).  Both kernels keep the
  windows in shared memory; their plain versions, which the CPU runs,
  cut the windows with ``orb_cuda.extract_patches_reference`` (the JAX
  package's ``_extract_kernel`` B3) and run the JAX package's chain on
  them (``fast.harris_from_patches``, ``fast.topk_stable`` and the
  gathers, ``orb_cuda._ic_angles_from_patches``, ``_blur_patches_valid``,
  ``_rbrief_from_patches``), with Harris's block sums exact.

The JAX package vmaps one frame's detector over the burst; here the
frame axis is written out: ``[N,H,W]`` uint8 in, ``[N,K,...]`` features
out, one call per level for the whole burst.  Every level's output has
a fixed ``quota`` of slots with a validity mask.  An optional detection
mask (cv2 ``detectAndCompute``'s) is shared by every frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import constants
from . import fast, fast_cuda, orb_cuda, resize


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
        hval, kys, kxs, kvalid = orb_cuda.select_keypoints(
            level_img, cand.ys, cand.xs, cand.valid, quota)
        angles, desc = orb_cuda.describe(level_img, kys, kxs)
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
