"""RANSAC / LMEDS / least-squares homography estimation, batched over
frames.

Counterpart of ``libstacker_tpu/ops/ransac.py`` (``_normalise_points``
:45, ``_solve_h_4pt`` :62, ``_project`` :78, ``_sq_reproj_error`` :88,
``_dlt_least_squares`` :93, ``_gauss_newton_refine`` :109, ``_sample_ok``
:154, ``find_homography`` :187), OpenCV ``findHomography``'s
counterpart (ref src/lib.rs:267-276): Hartley-normalised 4-point DLT
hypotheses scored against every correspondence, OpenCV's
``RANSACUpdateNumIters`` stop rule, ``checkSubset``'s degenerate-sample
rejection, then a least-squares DLT on the inliers and a masked
Gauss-Newton polish.

Every function takes a leading batch axis of B frames, each with M
padded correspondences and a validity mask.  The JAX package's per-lane
``lax.while_loop`` becomes a host loop over slabs of ``_SLAB``
hypotheses for all lanes at once (:func:`_adaptive_best`): a lane stops
drawing when its ``needed_iters`` bound is met, and the loop ends when
every lane has stopped or ``max_iters`` is reached; the active mask
stays on the card and the host reads it once after each slab.
Hypotheses come from a ``torch.Generator``, so they differ from
``jax.random``'s: H agrees with the JAX package statistically, not
bitwise.  ``torch.linalg.solve_ex`` replaces ``jnp.linalg.solve``: a
singular system (``info != 0``) gives a non-finite result, which the
callers mask, as ``jnp.linalg.solve``'s does.

On the card the refit's two solves are one launch each
(``ops/ransac_cuda.py``, ``csrc/ransac_refit.cu``): the DLT's smallest
eigenvector and the whole Gauss-Newton polish, in float64; CPU tensors
take the plain versions here (``torch.linalg.eigh`` and ``solve_ex`` in
the points' dtype).  Nothing in :func:`find_homography` but the loop's
one read a slab makes the host wait for the card.

:func:`match_and_estimate` is the keypoint pipeline's align stage, on
one device and on each shard of a mesh: 2-NN matching against frame 0
(``ops/matcher``), then :func:`find_homography` (the JAX package's
``models/keypoint.py _match_and_estimate`` :181).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants
from ..utils.tracing import count_of, span_of
from . import matcher, ransac_cuda

_BIG = 1e18
# hypotheses per adaptive-loop slab
_SLAB = 128
_FLT_EPS = float(np.float32(1.1920929e-07))


class HomographyResult(NamedTuple):
    h: torch.Tensor  # [B,3,3] float32, maps src -> dst, h[2,2]=1
    inliers: torch.Tensor  # [B,M] bool
    num_inliers: torch.Tensor  # [B] int64
    ok: torch.Tensor  # [B] bool


def _eye(shape, device) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(
        *shape, 3, 3).clone()


def _normalise_points(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalisation of ``[B,M,2]``: translate to the valid
    points' centroid, scale their mean distance to sqrt(2).  Returns
    ``(pts_norm, T)`` with ``pts_norm = T @ [pts, 1]``."""
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(-1), min=1.0)
    mean = (pts * w[..., None]).sum(-2) / n[..., None]  # [B,2]
    d = torch.sqrt(((pts - mean[:, None]) ** 2).sum(-1) + 1e-12)
    mean_d = (d * w).sum(-1) / n
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-6)
    t = torch.zeros(pts.shape[0], 3, 3, dtype=torch.float32, device=pts.device)
    t[:, 0, 0] = s
    t[:, 1, 1] = s
    t[:, 0, 2] = -s * mean[:, 0]
    t[:, 1, 2] = -s * mean[:, 1]
    t[:, 2, 2] = 1.0
    return (pts - mean[:, None]) * s[:, None, None], t


def _solve_h_4pt(src4: torch.Tensor, dst4: torch.Tensor) -> torch.Tensor:
    """Exact DLT from 4 correspondences ``[..., 4, 2]``: the 8x8 system
    for h00..h21 with h22 = 1 -> ``[..., 3, 3]`` (non-finite where the
    system is singular)."""
    x, y = src4[..., 0], src4[..., 1]
    u, v = dst4[..., 0], dst4[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    a = torch.cat([rows_u, rows_v], dim=-2)  # [..., 8, 8]
    b = torch.cat([u, v], dim=-1)  # [..., 8]
    h8, info = torch.linalg.solve_ex(a, b)
    h8 = torch.where((info == 0)[..., None], h8, torch.full_like(h8, math.nan))
    return torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1).reshape(
        *h8.shape[:-1], 3, 3)


def _project(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply ``[..., 3, 3]`` homographies to ``[..., M, 2]`` points."""
    x, y = pts[..., 0], pts[..., 1]
    hh = h[..., None, :, :]
    w = hh[..., 2, 0] * x + hh[..., 2, 1] * y + hh[..., 2, 2]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    u = (hh[..., 0, 0] * x + hh[..., 0, 1] * y + hh[..., 0, 2]) / w
    v = (hh[..., 1, 0] * x + hh[..., 1, 1] * y + hh[..., 1, 2]) / w
    return torch.stack([u, v], dim=-1)


def _sq_reproj_error(h, src, dst) -> torch.Tensor:
    return ((_project(h, src) - dst) ** 2).sum(-1)


def _normalise_h22(h: torch.Tensor) -> torch.Tensor:
    h22 = h[..., 2:3, 2:3]
    return h / torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12),
                           h22)


def _dlt_least_squares(src, dst, weights) -> torch.Tensor:
    """Weighted DLT over ``[B,M,2]`` points: the eigenvector of the
    smallest eigenvalue of A^T A (9x9), scaled to h22 = 1 (the
    eigenvector's sign cancels there).  CUDA tensors launch
    ``ransac_cuda.dlt``, other tensors take :func:`_dlt_plain`."""
    if src.device.type == "cuda":
        return ransac_cuda.dlt(src, dst, weights)
    return _dlt_plain(src, dst, weights)


def _dlt_plain(src, dst, weights) -> torch.Tensor:
    """:func:`_dlt_least_squares` in PyTorch, in the points' dtype, on
    any device (``torch.linalg.eigh`` makes the host wait for a card)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    wt = weights[..., None]
    a = torch.cat([rows_u * wt, rows_v * wt], dim=-2)
    ata = a.transpose(-1, -2) @ a
    _, evecs = torch.linalg.eigh(ata)
    return _normalise_h22(evecs[..., :, 0].reshape(*ata.shape[:-2], 3, 3))


def _gauss_newton_refine(h, src, dst, weights, iters: int = 10):
    """Masked Gauss-Newton on the reprojection error (OpenCV's LM polish
    counterpart), over the 8 non-h22 entries; an update is kept only
    where it lowers the weighted SSE.  CUDA tensors launch
    ``ransac_cuda.refine``, other tensors take :func:`_refine_plain`."""
    if h.device.type == "cuda":
        return ransac_cuda.refine(h, src, dst, weights, iters)
    return _refine_plain(h, src, dst, weights, iters)


def _refine_plain(h, src, dst, weights, iters: int = 10):
    """:func:`_gauss_newton_refine` in PyTorch, in ``h``'s dtype, on any
    device (~100 launches a step on a card)."""
    x, y = src[..., 0], src[..., 1]
    z = torch.zeros_like(x)
    damp = 1e-6 * torch.eye(8, dtype=h.dtype, device=h.device)
    wt = weights[..., None]
    for _ in range(iters):
        hh = h[..., None, :, :]
        w = hh[..., 2, 0] * x + hh[..., 2, 1] * y + hh[..., 2, 2]
        w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
        u = (hh[..., 0, 0] * x + hh[..., 0, 1] * y + hh[..., 0, 2]) / w
        v = (hh[..., 1, 0] * x + hh[..., 1, 1] * y + hh[..., 1, 2]) / w
        iw = 1.0 / w
        ju = torch.stack(
            [x * iw, y * iw, iw, z, z, z, -u * x * iw, -u * y * iw], dim=-1)
        jv = torch.stack(
            [z, z, z, x * iw, y * iw, iw, -v * x * iw, -v * y * iw], dim=-1)
        ru = (u - dst[..., 0]) * weights
        rv = (v - dst[..., 1]) * weights
        jmat = torch.cat([ju * wt, jv * wt], dim=-2)
        r = torch.cat([ru, rv], dim=-1)
        jt = jmat.transpose(-1, -2)
        dp, info = torch.linalg.solve_ex(jt @ jmat + damp,
                                         (jt @ r[..., None])[..., 0])
        dp = torch.where(torch.isfinite(dp) & (info == 0)[..., None], dp,
                         torch.zeros_like(dp))
        h_new = h - torch.cat([dp, torch.zeros_like(dp[..., :1])],
                              dim=-1).reshape(h.shape)
        sse_old = (weights * _sq_reproj_error(h, src, dst)).sum(-1)
        sse_new = (weights * _sq_reproj_error(h_new, src, dst)).sum(-1)
        h = torch.where((sse_new < sse_old)[..., None, None], h_new, h)
    return h


def _sample_ok(samp, src_pts, dst_pts, count) -> torch.Tensor:
    """OpenCV getSubset/checkSubset for ``[B,S,4]`` samples: distinct
    indices and no 3 collinear points in either point set.  The six
    pairs and the four triples of a sample are each tested in one pass
    over a stacked axis (the same comparisons, element for element, as
    one pass a pair or triple)."""
    first, second = _pairs(samp[..., None])
    ok = (first != second).all(-1)[..., 0] & (count >= 4)[:, None]

    def non_collinear(pts):
        p = _gather_points(pts, samp)  # [B,S,4,2]
        i, j, k = _triples(p)  # [B,S,4,2]: the four triples' corners
        d1 = j - i
        d2 = k - i
        cross = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
        lim = _FLT_EPS * (d1[..., 0].abs() + d1[..., 1].abs()) * (
            d2[..., 0].abs() + d2[..., 1].abs())
        return (cross.abs() > lim).all(-1)

    return ok & non_collinear(src_pts) & non_collinear(dst_pts)


def _pairs(x: torch.Tensor):
    """The six pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3) of ``x``'s 4
    rows on axis -2, as two ``[..., 6, C]`` tensors of first and second
    members."""
    lead = x.shape[:-2]
    c = x.shape[-1]
    first = torch.cat([x[..., :1, :].expand(*lead, 3, c),
                       x[..., 1:2, :].expand(*lead, 2, c), x[..., 2:3, :]],
                      dim=-2)
    second = torch.cat([x[..., 1:4, :], x[..., 2:4, :], x[..., 3:4, :]],
                       dim=-2)
    return first, second


def _triples(p: torch.Tensor):
    """The corners ``(i, j, k)`` of the four triples (0,1,2) (0,1,3)
    (0,2,3) (1,2,3) of ``p``'s 4 points on axis -2, each ``[..., 4, 2]``."""
    lead = p.shape[:-2]
    i = torch.cat([p[..., :1, :].expand(*lead, 3, 2), p[..., 1:2, :]], dim=-2)
    j = torch.cat([p[..., 1:2, :], p[..., 1:3, :], p[..., 2:3, :]], dim=-2)
    k = torch.cat([p[..., 2:4, :], p[..., 3:4, :].expand(*lead, 2, 2)],
                  dim=-2)
    return i, j, k


def _gather_points(pts: torch.Tensor, samp: torch.Tensor) -> torch.Tensor:
    """``pts[b, samp[b, s, j]]`` -> ``[B,S,4,2]``."""
    bsz, s, k = samp.shape
    g = torch.gather(pts, 1, samp.reshape(bsz, s * k, 1).expand(-1, -1, 2))
    return g.reshape(bsz, s, k, 2)


def _lmeds_select(h_px, errs, ok_samp, count):
    """LMEDS scoring of ``[B,S]`` hypotheses: the one with the least
    median squared error, and its inlier threshold
    ``(2.5 * 1.4826 * (1 + 5 / (n - 4)) * sqrt(median))^2``."""
    countf = torch.clamp(count.to(torch.float32), min=1.0)
    errs_sorted, _ = torch.sort(errs, dim=-1)
    med_idx = torch.clamp((count - 1) // 2, min=0)
    scores = torch.gather(
        errs_sorted, 2, med_idx[:, None, None].expand(-1, errs.shape[1], 1)
    )[..., 0]
    scores = torch.where(ok_samp, scores, torch.full_like(scores, _BIG))
    best = torch.argmin(scores, dim=-1)
    med = torch.gather(scores, 1, best[:, None])[:, 0]
    sigma = 2.5 * 1.4826 * (
        1.0 + 5.0 / torch.clamp(countf - 4.0, min=1.0)) * torch.sqrt(med)
    best_h = h_px[torch.arange(h_px.shape[0], device=h_px.device), best]
    return best_h, torch.clamp(sigma * sigma, min=1e-12)


class _Points(NamedTuple):
    """One call's correspondences and what every hypothesis needs of
    them: the Hartley-normalised points, their transforms, the valid
    count and the valid slots first (``order``)."""

    src: torch.Tensor  # [B,M,2]
    dst: torch.Tensor  # [B,M,2]
    valid: torch.Tensor  # [B,M] bool
    count: torch.Tensor  # [B] int64
    src_n: torch.Tensor
    dst_n: torch.Tensor
    t_src: torch.Tensor  # [B,3,3]
    t_dst_inv: torch.Tensor  # [B,3,3]
    order: torch.Tensor  # [B,M] int64


def _points(src_pts, dst_pts, valid) -> _Points:
    src_n, t_src = _normalise_points(src_pts, valid)
    dst_n, t_dst = _normalise_points(dst_pts, valid)
    # ``inv_ex``: ``linalg.inv`` without its check of ``info``, which
    # would make the host wait for the card
    t_dst_inv = torch.linalg.inv_ex(t_dst)[0]
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)
    return _Points(src_pts, dst_pts, valid, valid.sum(-1), src_n, dst_n,
                   t_src, t_dst_inv, order)


def _hypotheses(p: _Points, generator: torch.Generator, n_hyp: int):
    """``n_hyp`` 4-point hypotheses per lane -> ``(h_px [B,n,3,3], errs
    [B,n,M], ok [B,n])``; draws ``[B, n_hyp, 4]`` uniforms from
    ``generator`` for every lane."""
    bsz = p.valid.shape[0]
    dev = p.src.device
    u = torch.rand((bsz, n_hyp, 4), generator=generator, device=dev)
    hi = torch.clamp(p.count, min=1)[:, None, None]
    pos = torch.minimum((u * hi).to(torch.int64), hi - 1)
    samp = torch.gather(p.order, 1, pos.reshape(bsz, -1)).reshape(pos.shape)
    ok_samp = _sample_ok(samp, p.src, p.dst, p.count)
    h_all = _solve_h_4pt(_gather_points(p.src_n, samp),
                         _gather_points(p.dst_n, samp))
    finite = torch.isfinite(h_all).flatten(-2).all(-1)
    ok_samp = ok_samp & finite
    h_all = torch.where(finite[..., None, None], h_all,
                        _eye((bsz, n_hyp), dev))
    h_px = p.t_dst_inv[:, None] @ h_all @ p.t_src[:, None]
    errs = _sq_reproj_error(h_px, p.src[:, None], p.dst[:, None])
    errs = torch.where(p.valid[:, None, :] & torch.isfinite(errs), errs,
                       torch.full_like(errs, _BIG))
    return h_px, errs, ok_samp


def _still_active(active: torch.Tensor) -> bool:
    """The adaptive loop's one read a slab: whether any lane of the
    ``[B]`` mask is still drawing (the host waits here for the card)."""
    return bool(active.any())


def _adaptive_best(p: _Points, generator: torch.Generator, thresh_sq: float,
                   max_iters: int, confidence: float, timer=None):
    """RANSAC's adaptive loop: slabs of ``_SLAB`` hypotheses for every
    lane at once, a lane keeping its best hypothesis until it has drawn
    OpenCV's ``RANSACUpdateNumIters`` bound (or ``max_iters``); the loop
    ends when no lane is active.  Returns ``(best_h [B,3,3], slabs run)``.

    Every lane starts active (its bound is ``max_iters`` until it holds
    4 inliers), so the first slab runs without a read, and the host
    reads the active mask once after each slab.  ``timer`` records a
    ``ransac.loop`` span a slab and a ``ransac.check`` span a read."""
    bsz = p.valid.shape[0]
    dev = p.src.device
    countf = torch.clamp(p.count.to(torch.float32), min=1.0)
    log_conf = float(np.float32(
        math.log(max(1.0 - float(np.float32(confidence)), 1e-12))))

    def active_lanes(best_ninl, done):
        w = best_ninl.to(torch.float32) / countf
        denom = torch.log(torch.clamp(1.0 - w ** 4, min=1e-30))
        need = torch.where(best_ninl >= 4, torch.ceil(log_conf / denom),
                           torch.full_like(w, float(max_iters)))
        need = torch.clamp(need, 1.0, float(max_iters)).to(torch.int64)
        return done < torch.clamp(need, max=max_iters)

    best_h = _eye((bsz,), dev)
    best_ninl = torch.full((bsz,), -1, dtype=torch.int64, device=dev)
    done = torch.zeros(bsz, dtype=torch.int64, device=dev)
    lanes = torch.arange(bsz, device=dev)
    active = active_lanes(best_ninl, done)
    slabs, more = 0, bsz > 0 and max_iters >= 1
    while more:
        with span_of(timer, "ransac.loop"):
            h_px, errs, ok_samp = _hypotheses(p, generator, _SLAB)
            n_inl = (errs <= thresh_sq).sum(-1)
            n_inl = torch.where(ok_samp, n_inl, torch.full_like(n_inl, -1))
            sbest = torch.argmax(n_inl, dim=-1)
            top = n_inl[lanes, sbest]
            better = active & (top > best_ninl)
            best_h = torch.where(better[:, None, None], h_px[lanes, sbest],
                                 best_h)
            best_ninl = torch.where(active, torch.maximum(best_ninl, top),
                                    best_ninl)
            done = done + _SLAB * active.to(torch.int64)
            active = active_lanes(best_ninl, done)
        slabs += 1
        with span_of(timer, "ransac.check"):
            more = _still_active(active)
    count_of(timer, "ransac_slabs", slabs)
    return best_h, slabs


def find_homography(
    src_pts: torch.Tensor,
    dst_pts: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator,
    method: int = constants.RANSAC,
    reproj_threshold: float = 3.0,
    max_iters: int = 2000,
    confidence: float = 0.995,
    refine_iters: int = 10,
    timer=None,
) -> HomographyResult:
    """Estimate per-frame H mapping src -> dst from ``[B,M,2]`` padded
    correspondences with ``valid`` ``[B,M]``.  ``method``: RANSAC,
    LMEDS or 0 (least squares over all points).  ``generator`` draws
    the hypotheses (on the points' device).  The host waits for the
    card once after each of RANSAC's slabs and nowhere else.  ``timer`` (a
    ``utils.tracing.PhaseTimer``) records the loop's spans, a
    ``ransac.refit`` span around the refit and the ``ransac_slabs``
    count."""
    dev = src_pts.device
    bsz = valid.shape[0]
    p = _points(src_pts, dst_pts, valid)
    count = p.count
    thresh_sq = float(np.float32(reproj_threshold)) ** 2

    if method == 0:
        # OpenCV method=0: one least-squares DLT over ALL points + polish
        wts = valid.to(torch.float32)
        h_px = _normalise_h22(p.t_dst_inv @ _dlt_least_squares(
            p.src_n, p.dst_n, wts) @ p.t_src)
        h_ref = _normalise_h22(_gauss_newton_refine(
            h_px, src_pts, dst_pts, wts, refine_iters))
        ok = (count >= 4) & torch.isfinite(h_ref).flatten(-2).all(-1)
        return HomographyResult(h=h_ref, inliers=valid, num_inliers=count,
                                ok=ok)

    if method == constants.LMEDS:
        # OpenCV's LMEDS runs a fixed budget: one batched slab
        best_h, inl_thresh = _lmeds_select(
            *_hypotheses(p, generator, min(max_iters, 1024)), count)
    else:
        best_h, _ = _adaptive_best(p, generator, thresh_sq, max_iters,
                                   confidence, timer)
        inl_thresh = torch.full((bsz,), thresh_sq, dtype=torch.float32,
                                device=dev)

    with span_of(timer, "ransac.refit"):
        best_err = _sq_reproj_error(best_h, src_pts, dst_pts)
        best_err = torch.where(torch.isfinite(best_err), best_err,
                               torch.full_like(best_err, _BIG))
        inliers = (best_err <= inl_thresh[:, None]) & valid
        num_inl = inliers.sum(-1)
        wts = inliers.to(torch.float32)

        # least-squares DLT on inliers (normalised coords), then GN polish
        h_ls_px = _normalise_h22(
            p.t_dst_inv @ _dlt_least_squares(p.src_n, p.dst_n, wts) @ p.t_src)
        good_ls = torch.isfinite(h_ls_px).flatten(-2).all(-1) & (num_inl >= 4)
        h_ref = torch.where(good_ls[:, None, None], h_ls_px, best_h)
        h_ref = _normalise_h22(_gauss_newton_refine(h_ref, src_pts, dst_pts,
                                                    wts, refine_iters))
        # the inlier set under the refined H (OpenCV's final mask)
        final_inl = (_sq_reproj_error(h_ref, src_pts, dst_pts)
                     <= inl_thresh[:, None]) & valid
        ok = (count >= 4) & torch.isfinite(h_ref).flatten(-2).all(-1) & (
            num_inl >= 4)
    return HomographyResult(h=h_ref, inliers=final_inl,
                            num_inliers=final_inl.sum(-1), ok=ok)


def match_and_estimate(
    feats,
    generator: torch.Generator,
    method: int,
    ransac_reproj_threshold: float,
    match_keep_ratio: float,
    match_ratio: float,
    max_iters: int = 2000,
    confidence: float = 0.995,
    timer=None,
):
    """Frames 1..N-1 of ``feats`` (an ``ops.orb.OrbFeatures`` with frame
    0 first) matched against frame 0 and their homographies (frame-i ->
    frame-0) estimated, all at once; the host waits for the card only
    inside RANSAC's loop, once after each slab.  ``timer`` records a
    ``kp.match`` span around the matching and RANSAC's spans.

    Returns (hs [N-1,3,3], oks [N-1], match_counts, inlier_counts)."""
    with span_of(timer, "kp.match"):
        knn = matcher.knn_match2(feats.descriptors[0], feats.descriptors[1:],
                                 feats.valid[0], feats.valid[1:])
        filt = matcher.ratio_filter_sort_keep(knn, match_ratio,
                                              match_keep_ratio)
        src = feats.xy[0][filt.query_idx]  # frame-0 points (match.query)
        dst = torch.gather(feats.xy[1:], 1,
                           filt.train_idx[..., None].expand(-1, -1, 2))
        enough = filt.count >= 5  # ref src/lib.rs:240-242
    # find_homography(dst_pts, src_pts): H maps frame-i -> frame-0
    res = find_homography(
        dst, src, filt.keep, generator, method=method,
        reproj_threshold=ransac_reproj_threshold, max_iters=max_iters,
        confidence=confidence, timer=timer,
    )
    det = torch.linalg.det(res.h)
    ok = enough & res.ok & (torch.abs(det) >= 1e-6)  # ref src/lib.rs:279-287
    return res.h, ok, filt.count, res.num_inliers
