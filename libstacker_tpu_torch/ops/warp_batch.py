"""Batched frame warps: the stacking stage's warp-and-sum and the
per-frame warp of the other border modes.

Counterpart of ``libstacker_tpu/ops/warp_batch.py`` (``warp_frames_batch``
:231, ``warp_accumulate_rgb`` :326).  Forward maps become inverse maps
(one float32 ``torch.linalg.inv``, shared by the kernels and the plain
paths).  :func:`warp_accumulate_rgb` runs
``ops/warp_accum_cuda.warp_accum_rgb`` (kernel B2 on CUDA);
:func:`warp_frames_batch` runs ``ops/warp_cuda.warp_frames`` (kernel B5
on the interleaved frames: one coordinate and tap set per pixel for
all its channels).  The TPU-only ``pallas_pick_config``
ladder, the source apron of the index-mapping border modes
(``pallas_required_apron``) and the ``allow_pallas`` / ``pallas_k`` /
``apron`` / ``pallas_tile_rows`` knobs have no counterpart: a thread
samples any source pixel and B5 maps border indices itself, so every
matrix runs through the kernels.

:func:`warp_sum_lanes` is the mean stack of both pipelines, on one
device and on each shard of a mesh (the JAX package's
``models/ecc.py _ecc_warp_accumulate_jit`` :111 and
``models/keypoint.py _warp_and_accumulate`` :295);
:func:`warp_sum_burst` adds frame 0 as itself.
"""

from __future__ import annotations

import torch

from . import color, warp
from .warp_accum_cuda import warp_accum_rgb
from .warp_cuda import warp_frames


def warp_frames_batch(
    frames: torch.Tensor,  # [N,H,W,C] or [N,H,W] float32
    mats: torch.Tensor,  # [N,3,3] (or [N,2,3]) FORWARD maps
    perspective: bool = True,
    border_value=0.0,
    border_mode="constant",
) -> torch.Tensor:
    """Warp each frame onto its own grid with the given border mode ->
    the shape of ``frames``, float32.  ``border_value`` is a scalar or
    one value per channel (BORDER_CONSTANT); BORDER_TRANSPARENT reads
    the zero base.  One launch of kernel B5's frames form."""
    has_c = frames.ndim == 4
    c = frames.shape[3] if has_c else 1
    border = warp._resolve_border(border_mode)
    if border_value is None or border == "transparent":
        border_value = 0.0
    m3 = mats.to(torch.float32)
    if m3.shape[-2] == 2:
        m3 = warp.affine_to_3x3(m3)
    minv = warp.invert_3x3(m3)
    bv = torch.as_tensor(border_value, dtype=torch.float32,
                         device=frames.device).reshape(-1)
    bvs = bv[:1].expand(c) if bv.numel() == 1 else bv[:c]
    src = frames.to(torch.float32).contiguous()
    out = warp_frames(src if has_c else src[..., None], minv,
                      border_value=bvs, border_mode=border,
                      quant_affine=not perspective)
    return out if has_c else out[..., 0]


def warp_accumulate_rgb(
    frames: torch.Tensor,  # [N,H,W,3] uint8 / uint16 / float32
    mats: torch.Tensor,  # [N,3,3] (or [N,2,3]) FORWARD maps
    oks: torch.Tensor,  # [N] bool — dropped lanes contribute 0
    perspective: bool = True,
    border_value=0.0,
) -> torch.Tensor:
    """``sum_n oks[n] * warp(frames[n], mats[n])`` -> ``[H,W,3]``
    float32, BORDER_CONSTANT.  Integer frames are widened per tap,
    bitwise equal to feeding ``color.to_unit_f32(frames)``."""
    m3 = mats.to(torch.float32)
    if m3.shape[-2] == 2:
        m3 = warp.affine_to_3x3(m3)
    eye = torch.eye(3, dtype=torch.float32, device=m3.device)
    m3 = torch.where(oks[:, None, None], m3, eye)
    minv = warp.invert_3x3(m3)
    return warp_accum_rgb(
        frames, minv, oks, border_value=border_value,
        quant_affine=not perspective,
    )


def warp_sum_lanes(
    frames: torch.Tensor,  # [N,H,W,3] uint8 / uint16 — the lanes
    maps: torch.Tensor,  # [N,3,3] (or [N,2,3]) FORWARD maps onto frame 0
    oks: torch.Tensor,  # [N] bool — dropped lanes contribute 0
    perspective: bool = True,
    border_value=0.0,
    border_mode="constant",
    scale_hw=None,
) -> torch.Tensor:
    """The masked sum of the aligned lanes on frame 0's grid ->
    ``[H,W,3]`` float32.  Maps solved on the ``scale_hw`` grid are
    rescaled first; failed lanes get the identity (their possibly wild
    or non-finite maps must not reach the warp: NaN * 0 is NaN).
    BORDER_CONSTANT and BORDER_TRANSPARENT (over the zero base, a zero
    border) run :func:`warp_accumulate_rgb` (kernel B2); the
    index-mapping modes ([N,3,3] maps) run B5's accumulate form, which
    skips the dropped lanes."""
    if scale_hw is not None:
        maps = warp.rescale_maps(maps, scale_hw, frames.shape[1:3])
    eye = torch.eye(3, dtype=maps.dtype, device=maps.device)
    maps = torch.where(oks[:, None, None], maps, eye[: maps.shape[1]])
    border = warp._resolve_border(border_mode)
    if border in ("constant", "transparent"):
        if border == "transparent":
            border_value = 0.0
        return warp_accumulate_rgb(frames, maps, oks, perspective=perspective,
                                   border_value=border_value)
    return warp_frames(frames, warp.invert_3x3(maps),
                       border_value=border_value, border_mode=border,
                       valid=oks)


def warp_sum_burst(frames: torch.Tensor, maps: torch.Tensor,
                   oks: torch.Tensor, **kw) -> torch.Tensor:
    """Frame 0 as itself plus :func:`warp_sum_lanes` of frames 1..N-1
    (``maps`` / ``oks`` theirs) -> ``[H,W,3]`` float32, the mean
    stack's sum."""
    return color.to_unit_f32(frames[0]) + warp_sum_lanes(
        frames[1:], maps, oks, **kw)
