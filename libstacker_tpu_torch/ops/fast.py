"""FAST-9/16 corner detection, exact top-k and Harris responses.

Counterpart of ``libstacker_tpu/ops/fast.py`` (``CIRCLE_OFFSETS`` :26,
``fast_score`` :32, ``fast_detect`` :128, ``top_k_keypoints`` :165,
``harris_from_patches`` :237, ``harris_response_at`` :256), batched over
any leading axes.  This is the plain PyTorch formulation; on the card
the ORB detector runs kernel B8 instead (``ops/fast_cuda.py``), which
computes the same scores in one pass.

Semantics (OpenCV FAST type 9_16 with non-max suppression):

- corner test: some contiguous arc of 9 of the 16 Bresenham-circle
  pixels is entirely brighter than center+t or darker than center-t;
- score: max over arcs of the min absolute arc difference, minus 1
  (cornerScore<16>); arc minima by log-doubling over the circle;
- NMS: strictly greater than all 8 neighbour scores.

uint8 images are computed in int16 (differences in [-255, 255] are
exact), float images in float32.  The JAX package's A/B variants of the
arc tree (``LIBSTACKER_FAST_TREE``) and its pooled top-k
(``LIBSTACKER_TOPK=pooled``) are not ported: both were measured neutral
on the TPU and give the same bits as the default.

:func:`top_k_keypoints` is exact and breaks ties by the lower raster
index, as ``lax.top_k`` (and ``lax.approx_max_k`` on the CPU) do;
``torch.topk`` promises no order among ties, so :func:`topk_stable`
selects on an int64 key that makes every element distinct.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, in circular order (OpenCV pixel order).
CIRCLE_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest float32 entries along
    the last axis, in descending order, ties broken by the lower index.

    The float's bits map to an order-preserving int32 (negative floats
    have their magnitude bits flipped); the key ``bits * 2^32 + (n - 1 -
    index)`` is unique, so ``torch.topk`` on it is exact on any device."""
    n = x.shape[-1]
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    rev = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    _, idx = torch.topk(bits * (1 << 32) + rev, k, dim=-1)
    return torch.gather(x, -1, idx), idx


def _circle_diffs(img: torch.Tensor):
    """The 16 circle differences ``neighbour - centre`` of every pixel
    (edge-padded; border pixels are masked by the callers)."""
    dt = torch.float32 if img.dtype.is_floating_point else torch.int16
    x = img.to(dt)
    h, w = x.shape[-2], x.shape[-1]
    yi = torch.arange(-3, h + 3, device=img.device).clamp(0, h - 1)
    xi = torch.arange(-3, w + 3, device=img.device).clamp(0, w - 1)
    xp = x.index_select(-2, yi).index_select(-1, xi)
    return [xp[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - x
            for (dx, dy) in CIRCLE_OFFSETS]


def _arc9_min(v):
    """min over the 16 circular windows of length 9 (log-doubling)."""
    w2 = [torch.minimum(v[i], v[(i + 1) % 16]) for i in range(16)]
    w4 = [torch.minimum(w2[i], w2[(i + 2) % 16]) for i in range(16)]
    w8 = [torch.minimum(w4[i], w4[(i + 4) % 16]) for i in range(16)]
    return [torch.minimum(w8[i], v[(i + 8) % 16]) for i in range(16)]


def _list_max(v):
    while len(v) > 1:
        v = [torch.maximum(v[i], v[i + len(v) // 2])
             for i in range(len(v) // 2)]
    return v[0]


def _interior(h: int, w: int, border: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)


def fast_score(
    img: torch.Tensor, threshold: int = 20
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FAST-9/16 on ``[..., H, W]`` (uint8 or float).

    Returns (corner_mask bool, score float32) before NMS.  Pixels within
    3 of the border are never corners (OpenCV skips them)."""
    e = _circle_diffs(img)
    tb = _list_max(_arc9_min(e))  # bright-arc strength
    td = _list_max(_arc9_min([-ei for ei in e]))  # dark-arc strength
    del e
    corner = (tb > threshold) | (td > threshold)
    score = torch.maximum(tb, td).to(torch.float32) - 1.0
    h, w = img.shape[-2], img.shape[-1]
    corner = corner & _interior(h, w, 3, img.device)
    return corner, torch.where(corner, score, torch.zeros_like(score))


def fast_detect(
    img: torch.Tensor, threshold: int = 20
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FAST with 3x3 non-max suppression.  Returns (mask, score)."""
    corner, score = fast_score(img, threshold)
    h, w = score.shape[-2], score.shape[-1]
    sp = F.pad(score, (1, 1, 1, 1))  # zero pad: scores are >= 0
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) == (0, 0):
                continue
            nb = sp[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            nmax = nb if nmax is None else torch.maximum(nmax, nb)
    keep = corner & (score > nmax)
    return keep, torch.where(keep, score, torch.zeros_like(score))


class TopKeypoints(NamedTuple):
    ys: torch.Tensor  # [..., K] int32
    xs: torch.Tensor  # [..., K] int32
    score: torch.Tensor  # [..., K] float32
    valid: torch.Tensor  # [..., K] bool


def top_k_keypoints(
    mask: torch.Tensor, score: torch.Tensor, k: int
) -> TopKeypoints:
    """The k highest-score masked pixels of ``[..., H, W]`` maps, ties
    broken by raster order (``lax.top_k``'s order); unmasked pixels
    score -1 and are marked invalid."""
    w = score.shape[-1]
    flat = torch.where(mask, score, torch.full_like(score, -1.0))
    flat = flat.reshape(*score.shape[:-2], -1)
    vals, idx = topk_stable(flat, k)
    return TopKeypoints(
        ys=(idx // w).to(torch.int32), xs=(idx % w).to(torch.int32),
        score=vals, valid=vals > 0.0,
    )


def harris_scale4(block_size: int = 7) -> float:
    """``(1 / (4 * block_size * 255))^4``, the Harris response's scale
    (a Python float; float32 where it multiplies a tensor)."""
    scale = 1.0 / (4.0 * block_size * 255.0)
    return scale * scale * scale * scale


def harris_from_patches(
    patch: torch.Tensor, block_size: int = 7, harris_k: float = 0.04
) -> torch.Tensor:
    """Harris response from ``[..., b+2, b+2]`` pixel patches, matching
    ORB's HarrisResponses (orb.cpp): 3x3 Sobel gradients, 7x7 block
    sums, response = (ab - c^2 - k (a+b)^2) * (1/(4*7*255))^4.

    The block sums are taken in float64 and cast to float32 once: on
    integer pixels they are exact (each at most 49 * 1020^2 < 2^53),
    where a float32 sum (> 2^24) would round in an order of its own;
    kernel B3h (``csrc/orb_describe.cu``) sums the same integers exactly
    in int32."""
    dx = patch[..., :, 2:] - patch[..., :, :-2]  # [..., b+2, b]
    dy = patch[..., 2:, :] - patch[..., :-2, :]  # [..., b, b+2]
    ix = 2.0 * dx[..., 1:-1, :] + dx[..., :-2, :] + dx[..., 2:, :]
    iy = 2.0 * dy[..., :, 1:-1] + dy[..., :, :-2] + dy[..., :, 2:]
    dims = (-2, -1)
    a = torch.sum(ix * ix, dim=dims, dtype=torch.float64).to(torch.float32)
    b = torch.sum(iy * iy, dim=dims, dtype=torch.float64).to(torch.float32)
    c = torch.sum(ix * iy, dim=dims, dtype=torch.float64).to(torch.float32)
    return (a * b - c * c - harris_k * (a + b) ** 2) * harris_scale4(block_size)


def harris_response_at(
    img: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
    block_size: int = 7,
    harris_k: float = 0.04,
) -> torch.Tensor:
    """Harris response of ``[H, W]`` at ``[K]`` pixel locations (gather
    form; the ORB detector computes the same from its extracted patches,
    see :func:`harris_from_patches`)."""
    x = img.to(torch.float32)
    r = block_size // 2
    offs = torch.arange(-r - 1, r + 2, device=img.device)
    h, w = x.shape
    py = (ys.long()[:, None, None] + offs[None, :, None]).clamp(0, h - 1)
    px = (xs.long()[:, None, None] + offs[None, None, :]).clamp(0, w - 1)
    return harris_from_patches(x[py, px], block_size, harris_k)
