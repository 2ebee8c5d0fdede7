"""INTER_AREA / INTER_LINEAR / INTER_NEAREST resize, plus the octave
fast path.

Counterpart of ``libstacker_tpu/ops/resize.py`` (``_area_weights`` :35,
``_linear_weights`` :55, ``_banded_weights`` :79, ``_nearest_index``
:136, ``resize`` :142, ``scale_image_size`` :206, ``scale_image`` :217)
and of the 2x box-mean octave reduction in
``libstacker_tpu/ops/ecc.py:1019-1037``.  The per-axis weights are the
reference's, and ``resize`` makes the reference's choice per axis (rows
first, then columns) between the dense ``[dst, src]`` product and the
block-banded one (``L < src and dst > _BLOCK // 2``), whose layout
decides the order of the sums (below); neither product is formed.

The sums follow the order the JAX package's forms take on the CPU, as
far as it could be measured, so that uint8 results (``floor(x + 0.5)``)
agree bit for bit where possible (the ORB pyramid feeds FAST, which
compares integer pixels): each tap's product is rounded to float32, tap
``k`` goes to lane ``(k - base) % _LANES`` (``base`` is the band's
source origin on the banded form, 0 on the dense one), and the lanes are
summed as a tree of adjacent pairs.  An empty lane adds an exact 0.0,
so only a row's nonzero taps are gathered: the outputs are grouped by
the shape of their tree, and an output costs its few taps instead of a
product over the whole source axis.

XLA:CPU's own order also depends on the array's shape: for some
3- and 4-tap INTER_AREA rows, and for 2-D arrays, it uses fused
multiply-add chains instead.  The residual this leaves is measured and
pinned in ``tests/test_torch_resize.py`` (ROADMAP.md Queue C).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from .. import constants
from ..errors import InvalidParamsError

_BLOCK = 128  # output rows/cols per banded block
_LANES = 16  # lanes of the dense form's tree (it must cover a row's taps)


@functools.lru_cache(maxsize=256)
def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] float32 area-averaging weights (true INTER_AREA shrink)."""
    scale = src / dst
    w = np.zeros((dst, src), dtype=np.float64)
    inv = 1.0 / scale
    for x in range(dst):
        f0 = x * scale
        f1 = min(f0 + scale, float(src))
        j0 = int(math.floor(f0))
        j1 = int(math.ceil(f1))
        for j in range(j0, min(j1, src)):
            overlap = min(j + 1.0, f1) - max(float(j), f0)
            if overlap > 0:
                w[x, j] = overlap * inv
    # Normalise rows to guard against float drift at the right edge.
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _linear_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] float32 bilinear weights with OpenCV coordinate mapping."""
    scale = src / dst
    w = np.zeros((dst, src), dtype=np.float64)
    for x in range(dst):
        fx = (x + 0.5) * scale - 0.5
        sx = int(math.floor(fx))
        frac = fx - sx
        if sx < 0:
            sx, frac = 0, 0.0
        if sx >= src - 1:
            sx, frac = src - 2, 1.0
        if src == 1:
            w[x, 0] = 1.0
        else:
            w[x, sx] += 1.0 - frac
            w[x, sx + 1] += frac
    return w.astype(np.float32)


def _full_weights(src: int, dst: int, interpolation: int) -> np.ndarray:
    if interpolation == constants.INTER_AREA:
        return _area_weights(src, dst)
    return _linear_weights(src, dst)


@functools.lru_cache(maxsize=256)
def _band(src: int, dst: int, interpolation: int):
    """The reference's block-banded layout of the [dst, src] weights
    (``_banded_weights`` :79): ``(bases, L)``, block ``g`` of ``_BLOCK``
    outputs reading source window ``[bases[g], bases[g] + L)``."""
    full = _full_weights(src, dst, interpolation)
    spans = []
    for g in range(-(-dst // _BLOCK)):
        cols = np.nonzero(full[g * _BLOCK : (g + 1) * _BLOCK].any(axis=0))[0]
        spans.append((int(cols[0]), int(cols[-1]) + 1))
    L = max(hi - lo for lo, hi in spans)
    return tuple(min(lo, src - L) for lo, _ in spans), L


def _is_banded(src: int, dst: int, interpolation: int) -> bool:
    """The reference's per-axis choice (``resize`` :188-190)."""
    _, L = _band(src, dst, interpolation)
    return L < src and dst > _BLOCK // 2


def _lane_tree(taps, lanes: int):
    """The adjacent-pairs tree over ``lanes`` lanes holding ``taps``
    (``(lane, tap)`` pairs) as a nested tuple of tap numbers; empty
    lanes drop out, and the two children of a node are put in a fixed
    order (float addition is commutative, so this only merges equal
    sums)."""
    nodes = [None] * lanes
    for lane, tap in taps:
        nodes[lane] = tap
    while len(nodes) > 1:
        nxt = []
        for a, b in zip(nodes[0::2], nodes[1::2]):
            nxt.append(a if b is None else b if a is None
                       else tuple(sorted((a, b), key=repr)))
        nodes = nxt
    return nodes[0]


@functools.lru_cache(maxsize=256)
def _tap_plan(src: int, dst: int, interpolation: int):
    """Gather plan of one axis: ``[(tree, rows, idx, wt)]``, one entry per
    distinct summation tree; ``rows`` [G] are the outputs that use it,
    ``idx`` / ``wt`` [G, T] their taps' source indices and weights in
    ascending source order, and ``tree`` a nested tuple over 0..T-1."""
    full = _full_weights(src, dst, interpolation)
    bases, _ = _band(src, dst, interpolation)
    banded = _is_banded(src, dst, interpolation)
    nz = [np.nonzero(full[a])[0] for a in range(dst)]
    span = max(int(k[-1] - k[0]) + 1 for k in nz)
    lanes = max(_LANES, 1 << (span - 1).bit_length())
    groups = {}
    for a, ks in enumerate(nz):
        base = bases[a // _BLOCK] if banded else 0
        tree = _lane_tree(
            [((int(k) - base) % lanes, j) for j, k in enumerate(ks)], lanes)
        groups.setdefault(tree, []).append(a)
    plan = []
    for tree, rows in groups.items():
        idx = np.stack([nz[a] for a in rows]).astype(np.int64)
        wt = np.stack([full[a, nz[a]] for a in rows]).astype(np.float32)
        plan.append((tree, np.asarray(rows, np.int64), idx, wt))
    return plan


@functools.lru_cache(maxsize=256)
def _tap_plan_on(src: int, dst: int, interpolation: int, device: torch.device):
    """:func:`_tap_plan` with ``rows`` and each tap's indices and weights
    as tensors on ``device``, copied once: a copy from pageable host
    memory synchronises the device's stream."""
    plan = []
    for tree, rows, idx, wt in _tap_plan(src, dst, interpolation):
        plan.append((
            tree, torch.from_numpy(rows).to(device),
            [torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in idx.T],
            [torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in wt.T],
        ))
    return plan


def _resize_axis(x: torch.Tensor, axis: int, dst: int,
                 interpolation: int) -> torch.Tensor:
    """Resize float32 ``x`` along ``axis`` (-2 or -1), summing in the
    order of the module docstring."""
    axis = axis % x.ndim
    plan = _tap_plan_on(x.shape[axis], dst, interpolation, x.device)
    shape = list(x.shape)
    shape[axis] = dst
    out = None if len(plan) == 1 else torch.empty(shape, dtype=torch.float32,
                                                  device=x.device)
    for tree, rows, idx, wt in plan:
        wshape = [1] * x.ndim
        wshape[axis] = len(rows)
        prods = [x.index_select(axis, i) * w.reshape(wshape)
                 for i, w in zip(idx, wt)]
        if out is None:  # one group: every output, in order
            return _tree_sum(tree, prods)
        out.index_copy_(axis, rows, _tree_sum(tree, prods))
    return out


def _tree_sum(node, prods):
    """The products summed in the order ``node`` gives: a pair adds its
    halves' sums, an index is that product.  A module function, not a
    closure that calls itself: such a closure is a reference cycle that
    would keep ``prods`` (a full float32 image a tap) alive until the
    next garbage collection."""
    if isinstance(node, tuple):
        return _tree_sum(node[0], prods) + _tree_sum(node[1], prods)
    return prods[node]


def row_span(src: int, dst: int, first: int, last: int,
             interpolation: int = constants.INTER_AREA) -> Tuple[int, int]:
    """The source rows ``[lo, hi)`` that output rows ``[first, last)`` of
    a ``src`` -> ``dst`` row pass read."""
    full = _full_weights(src, dst, interpolation)[first:last]
    cols = np.nonzero(full.any(axis=0))[0]
    return int(cols[0]), int(cols[-1]) + 1


def resize_rows(x: torch.Tensor, src: int, dst: int, first: int, last: int,
                origin: int,
                interpolation: int = constants.INTER_AREA) -> torch.Tensor:
    """Output rows ``[first, last)`` of :func:`resize`'s row pass of a
    ``[..., src, W]`` image to ``dst`` rows, from ``x``, the image's rows
    from ``origin`` on (holding every row :func:`row_span` names): the
    same taps, products and sums as the whole image's row pass, so a row
    band's rows equal the whole image's bitwise."""
    out = torch.empty((*x.shape[:-2], last - first, x.shape[-1]),
                      dtype=torch.float32, device=x.device)
    xf = x.to(torch.float32)
    for tree, rows, idx, wt in _tap_plan(src, dst, interpolation):
        sel = (rows >= first) & (rows < last)
        if not sel.any():
            continue
        at = torch.from_numpy(rows[sel] - first).to(x.device)
        prods = [xf.index_select(-2, torch.from_numpy(i - origin).to(x.device))
                 * torch.from_numpy(w).to(x.device)[:, None]
                 for i, w in zip(idx[sel].T, wt[sel].T)]
        out.index_copy_(-2, at, _tree_sum(tree, prods))
    return out


@functools.lru_cache(maxsize=256)
def _nearest_index(src: int, dst: int) -> np.ndarray:
    scale = src / dst
    return np.minimum(np.floor(np.arange(dst) * scale), src - 1).astype(np.int64)


def resize(
    img: torch.Tensor,
    dsize: Tuple[int, int],
    interpolation: int = constants.INTER_AREA,
) -> torch.Tensor:
    """Resize the trailing two axes of ``[..., H, W]`` to ``dsize=(h, w)``.
    Float inputs stay float32; uint8 inputs are computed in float32 and
    rounded back (``floor(x + 0.5)``, clamped)."""
    dh, dw = int(dsize[0]), int(dsize[1])
    if dh <= 0 or dw <= 0:
        raise InvalidParamsError(f"invalid dsize {dsize}")
    sh, sw = img.shape[-2], img.shape[-1]
    if interpolation == constants.INTER_NEAREST:
        yi = torch.from_numpy(_nearest_index(sh, dh)).to(img.device)
        xi = torch.from_numpy(_nearest_index(sw, dw)).to(img.device)
        return img.index_select(-2, yi).index_select(-1, xi)
    if interpolation not in (constants.INTER_AREA, constants.INTER_LINEAR):
        raise InvalidParamsError(f"unsupported interpolation {interpolation}")
    out = _resize_axis(img.to(torch.float32), -2, dh, interpolation)
    out = _resize_axis(out, -1, dw, interpolation)
    if img.dtype == torch.uint8:
        return torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)
    return out


def resize_area_octave(x: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """INTER_AREA reduction for the coarse-to-fine octaves: an exact 2x
    reduction of even extents is a 2x2 box mean (the INTER_AREA weights
    are exactly 1/4), summed in the reference's order; anything else
    takes :func:`resize`."""
    h, w = x.shape[-2], x.shape[-1]
    if h == 2 * dh and w == 2 * dw:
        x4 = x.reshape(*x.shape[:-2], dh, 2, dw, 2)
        return (x4[..., 0, :, 0] + x4[..., 0, :, 1]
                + x4[..., 1, :, 0] + x4[..., 1, :, 1]) * 0.25
    return resize(x, (dh, dw), constants.INTER_AREA)


def scale_image_size(height: int, width: int, scale_down: float) -> Tuple[int, int]:
    """New (h, w) for ``scale_image``: scales so the *smaller* dimension
    equals ``scale_down`` (ref src/utils.rs:192-199, including the
    truncating ``as i32`` casts)."""
    if width < height:
        factor = float(scale_down) / float(width)
    else:
        factor = float(scale_down) / float(height)
    return int(height * factor), int(width * factor)


def scale_image(img: torch.Tensor, scale_down: float) -> torch.Tensor:
    """INTER_AREA rescale with the reference's smaller-dimension semantics
    (ref src/utils.rs:186-214) on ``[..., H, W]`` or ``[..., H, W, C]``
    (C <= 4)."""
    has_channels = img.ndim >= 3 and img.shape[-1] <= 4
    x = img.movedim(-1, -3) if has_channels else img
    nh, nw = scale_image_size(x.shape[-2], x.shape[-1], scale_down)
    out = resize(x, (nh, nw), constants.INTER_AREA)
    return out.movedim(-3, -1).contiguous() if has_channels else out
