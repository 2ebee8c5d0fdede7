"""Re-warping burst stackers: kappa-sigma clipping (``stacking=
"sigma_clip"``) and super-resolution (``output_scale > 1``).

Counterpart of ``libstacker_tpu/ops/stack.py`` (``_CLIP_TOL`` :59,
``clip_iterate`` :62, ``_coverage`` :112, ``_moments_chunk`` :166,
``_clipped_chunk`` :203, ``kappa_sigma_stack`` :240, ``_prepare_lanes``
:292, ``super_res_stack`` :418).

Sigma-clip: per pixel and channel, samples further than
``kappa`` standard deviations from the mean are excluded and the mean
recomputed.  No warped ``[N,H,W,3]`` intermediate exists: the burst is
re-warped once per pass and only the per-pixel moments stay resident:

  pass 0:  S0 = sum incl,  S1 = sum incl*v,  S2 = sum incl*v^2
  pass i:  mu = S1/S0, sigma^2 = S2/S0 - mu^2,
           m = incl AND |v - mu| <= kappa*sigma + tol,
           C0/C1/C2 = the same moments under m   (then S* <- C*)

A frame contributes to a pixel only where its unquantised source
coordinate lies inside the frame (coverage), so per-pixel denominators
replace the mean stack's divide-by-count.  Each pass is one call of
``ops/warp_accum_cuda.warp_moments_rgb`` over the whole burst: one
launch of kernel B4 on CUDA, which keeps no per-frame intermediate, so
the JAX package's frame chunks are not needed there.  The streams sweep
the files chunk by chunk through :func:`moments_chunk` on the rows of
:func:`sweep_lanes` that the chunk holds.

Super-resolution: every frame deposits its nearest samples on the
``factor``-times-finer grid with Gaussian sub-pixel weights; fine pixels
no sample lands near fall back to the bilinear mean.  On CUDA that is
one call of ``ops/sr_cuda.sr_image`` over the burst (one launch of
kernel B6 that writes only the image); on the CPU ``sr_deposit`` sums
chunks of frames and ``sr_cuda.normalise`` divides, as the JAX package
does.

A mesh's shards (``parallel/mesh.py``) run the same sweeps on their
lanes (:func:`moments_sweep`, :func:`deposit_sum`, the lane tables of
:func:`sweep_lanes` without the frame-0 lane) and reduce them over
``'data'`` before :func:`clip_stack`'s iteration or ``normalise``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import warp
from .sr_cuda import normalise, sr_deposit, sr_image
from .warp_accum_cuda import coverage, warp_moments_rgb

# half an 8-bit LSB in the [0,1] value domain: keeps bit-identical
# samples (sigma == 0) included instead of collapsing to frame 0
_CLIP_TOL = float(np.float32(0.5 / 255.0))


def clip_iterate(s0, s1, s2, kappa: float, iters: int, clipped_moments,
                 start_pass: int = 1, entry_state=None, pass_hook=None):
    """The kappa-sigma iteration (one source of the clip semantics).

    ``s0``: pass-0 per-pixel sample count ([H,W] or [H,W,C]);
    ``s1``/``s2``: value / squared-value sums ([H,W,C]).
    ``clipped_moments(mu, tol) -> (c0, c1, c2)`` recomputes the moments
    over the samples within ``tol`` of ``mu`` (per pixel and channel).

    Resume support for the streams: ``entry_state`` is the
    ``(s0c, s1, s2)`` state entering clip pass ``start_pass`` (1-based),
    as ``pass_hook(i, s0c, s1, s2)`` records it after each non-final
    pass; ``s0/s1/s2`` may then be None.

    Returns ``(out [H,W,C], kept [H,W,C])``: ``kept`` is the last pass's
    surviving-sample count before the clamp (an emptied pixel reports
    0).  Pixels with no surviving sample take that pass's mean."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if not kappa > 0.0:
        raise ValueError(f"kappa must be > 0, got {kappa}")
    if entry_state is not None:
        s0c, s1, s2 = entry_state
    else:
        s0c = s0[..., None] if s0.ndim == s1.ndim - 1 else s0
    kept = s0c
    for i in range(start_pass, iters + 1):
        denom = torch.clamp(s0c, min=1.0)
        mu = s1 / denom
        var = torch.clamp(s2 / denom - mu * mu, min=0.0)
        tol = kappa * torch.sqrt(var) + _CLIP_TOL
        s0c, s1, s2 = clipped_moments(mu, tol)
        kept = s0c
        # pixels where clipping removed everything fall back to mu
        s1 = torch.where(s0c > 0.0, s1, mu)
        s2 = torch.where(s0c > 0.0, s2, mu * mu)
        s0c = torch.clamp(s0c, min=1.0)
        if pass_hook is not None and i < iters:
            pass_hook(i + 1, s0c, s1, s2)
    return s1 / s0c, kept


def _coverage(mats3: torch.Tensor, h: int, w: int,
              perspective: bool) -> torch.Tensor:
    """[G,H,W] bool: output pixels whose inverse-mapped source
    coordinate is fully interior (no border contamination).  ``mats3``
    [G,3,3] FORWARD maps."""
    minv = warp.invert_3x3(mats3)
    return torch.stack([coverage(m, (h, w), perspective) for m in minv])


def _prepare_lanes(mats, oks, device, frame0: bool = True):
    """Prologue of the re-warping stackers: 2x3 affine -> 3x3, frame 0
    prepended as the identity lane (``frame0``; a mesh shard's lanes
    carry it themselves), failed lanes given the identity (a NaN matrix
    must not reach the inverse).  -> (mats_all [N,3,3], oks_all [N]
    bool)."""
    eye = torch.eye(3, dtype=torch.float32, device=device)
    mats3 = torch.as_tensor(mats, device=device).to(torch.float32)
    if mats3.shape[-2] == 2:
        mats3 = warp.affine_to_3x3(mats3)
    oks_all = torch.as_tensor(oks, device=device).to(torch.bool)
    if frame0:
        mats3 = torch.cat([eye[None], mats3])
        oks_all = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                             oks_all])
    mats_all = torch.where(oks_all[:, None, None], mats3, eye)
    return mats_all, oks_all


def sweep_lanes(mats, oks, device, frame0: bool = True):
    """The lane tables of a re-warping stack (:func:`_prepare_lanes`):
    (inverse maps [N,3,3], oks [N] bool).  A stream slices them per
    chunk of files."""
    mats_all, oks_all = _prepare_lanes(mats, oks, device, frame0)
    return warp.invert_3x3(mats_all).contiguous(), oks_all


def _chunk_step(frames, chunk: int) -> int:
    """Frames per call: all of them on CUDA (one launch), ``chunk`` for
    the plain CPU version (its sums add per chunk, as the JAX package's
    do)."""
    n = frames.shape[0]
    return n if frames.device.type == "cuda" else max(1, min(chunk, n))


def moments_chunk(frames, minv, oks, mu=None, tol=None, perspective=True):
    """One re-warp sweep over a chunk of frames (``minv`` / ``oks`` the
    chunk's rows of :func:`sweep_lanes`) -> (S0 [H,W], S1, S2 [H,W,3]),
    or with ``mu`` / ``tol`` the clipped moments (C0, C1, C2 [H,W,3]).
    One launch of kernel B4 on CUDA."""
    s0, s1, s2 = warp_moments_rgb(frames, minv, oks, mu, tol,
                                  quant_affine=not perspective)
    return (s0[..., 0], s1, s2) if mu is None else (s0, s1, s2)


def moments_sweep(frames, minv, oks, mu=None, tol=None, perspective=True,
                  chunk: int = 8):
    """:func:`moments_chunk` summed over the burst (or a mesh shard),
    ``chunk`` frames per plain CPU call, one launch on CUDA."""
    step = _chunk_step(frames, chunk)
    acc = None
    for s in range(0, frames.shape[0], step):
        part = moments_chunk(frames[s : s + step], minv[s : s + step],
                             oks[s : s + step], mu, tol, perspective)
        acc = part if acc is None else tuple(a + p for a, p in zip(acc, part))
    return acc


def clip_stack(sweep, kappa: float, iters: int) -> Tuple[torch.Tensor, float]:
    """The kappa-sigma stack from its sweep: ``sweep(mu=None, tol=None)``
    -> the moments over every lane (one device's, or a mesh's reduced
    over ``'data'``); :func:`clip_iterate` on them -> (image, clipped
    sample fraction)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    s0, s1, s2 = sweep()
    out, kept = clip_iterate(s0, s1, s2, kappa, iters, sweep)
    tk, ts = torch.stack([kept.sum(), s0.sum()]).tolist()
    return out, max(0.0, 1.0 - tk / max(ts * 3.0, 1.0))


def deposit_sum(frames, minv, oks, factor: int, kernel_sigma: float = 0.3,
                perspective: bool = True, chunk: int = 4):
    """B6's deposit form summed over the burst (or a mesh shard),
    ``chunk`` frames per plain CPU call, one launch on CUDA ->
    the deposit sums that ``sr_cuda.normalise`` divides (with the
    bilinear fallback's below ``kernel_sigma`` 0.15)."""
    step = _chunk_step(frames, chunk)
    acc = None
    for s in range(0, frames.shape[0], step):
        part = sr_deposit(frames[s : s + step], minv[s : s + step],
                          oks[s : s + step], factor, kernel_sigma,
                          perspective, kernel_sigma < 0.15)
        acc = part if acc is None else tuple(a + p for a, p in zip(acc, part))
    return acc


def kappa_sigma_stack(
    frames: torch.Tensor,  # [N,H,W,3] uint8 / uint16 — frame 0 = reference
    mats: torch.Tensor,  # [N-1,3,3] (or [N-1,2,3]) FULL-RES forward maps
    oks: torch.Tensor,  # [N-1] bool — dropped lanes contribute nothing
    perspective: bool = True,
    kappa: float = 2.5,
    iters: int = 1,
    chunk: int = 8,
) -> Tuple[torch.Tensor, float]:
    """Robust stack -> (``[H,W,3]`` float32 in [0,1], clipped-sample
    fraction).

    Frame 0 takes part with the identity warp (fully covered), so every
    pixel has a sample.  ``1 + iters`` sweeps over the burst
    (:func:`moments_sweep`); ``chunk`` bounds the frames per call of the
    plain CPU version; CUDA sweeps all frames in one launch."""
    minv, oks_all = sweep_lanes(mats, oks, frames.device)
    return clip_stack(
        lambda mu=None, tol=None: moments_sweep(
            frames, minv, oks_all, mu, tol, perspective, chunk),
        kappa, iters)


def super_res_stack(
    frames: torch.Tensor,  # [N,H,W,3] uint8 / uint16 — frame 0 = reference
    mats: torch.Tensor,  # [N-1,3,3] (or [N-1,2,3]) FULL-RES forward maps
    oks: torch.Tensor,  # [N-1] bool — dropped lanes contribute nothing
    factor: int = 2,
    kernel_sigma: float = 0.3,
    perspective: bool = True,
    chunk: int = 4,
) -> torch.Tensor:
    """Super-resolution stack -> ``[factor*H, factor*W, 3]`` float32 in
    [0,1].

    Shift-and-add on the finer grid: each frame deposits its NEAREST
    sample at every fine pixel's unquantised source coordinate, weighted
    by a Gaussian of the sub-pixel distance (``kernel_sigma`` in input
    pixels), and the weighted mean is taken per pixel.  Frame 0 deposits
    with the identity, so for ``kernel_sigma >= 0.15`` every fine pixel
    has weight above 1e-6; below it the deposit also sums the bilinear
    samples, and pixels with no weight take their bilinear mean.
    ``chunk`` bounds the frames per call of the plain CPU version
    (:func:`deposit_sum`); CUDA deposits all frames and normalises in
    one launch."""
    if factor < 2 or factor > 4:
        raise ValueError(f"factor must be in 2..4, got {factor}")
    if not kernel_sigma > 0.0:
        raise ValueError(f"kernel_sigma must be > 0, got {kernel_sigma}")
    minv, oks_all = sweep_lanes(mats, oks, frames.device)
    if frames.device.type == "cuda":
        return sr_image(frames, minv, oks_all, factor, kernel_sigma,
                        perspective, kernel_sigma < 0.15)
    return normalise(deposit_sum(frames, minv, oks_all, factor, kernel_sigma,
                                 perspective, chunk))
