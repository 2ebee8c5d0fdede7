"""``ecc_match`` pipeline — ECC-aligned burst stacking.

Counterpart of ``libstacker_tpu/models/ecc.py`` (``_adjust_warp_for_scale``
:49, stages of ``ecc_match_arrays`` :507, ``ecc_match`` :735), in the
reference's convention: template = current frame's grey, input = frame
0's grey (ref src/lib.rs:769-777); the solved warp is applied forward to
the current frame with BORDER_CONSTANT 0 (src/lib.rs:780-803); the sum
divides by the total frame count (src/lib.rs:837), and a failed frame
raises ``ProcessingError`` — or is dropped with ``on_failure="drop"``.

Stages, all on one device:

1. fixed-point grey (``ops/color``), INTER_AREA-scaled on the scaled path;
2. phase-correlation start (``ops/phasecorr``; translation, or with
   ``phase_init_rotation`` rotation/scale first; off when a ``mask`` is
   given);
3. batched ECC with optional 2x octaves (``ops/ecc``): kernel B1 (its
   4-plane form with a ``mask``), B1 without the Gram for
   ``solver="lazy"``, B7 for ``solver="ic"``;
4. fused warp + sum of the kept frames (``ops/warp_batch``, kernel B2),
   divided by the frame count; or, with ``stacking="sigma_clip"``, the
   kappa-sigma stack (``ops/stack``, kernel B4) with per-pixel divisors;
   or, with ``output_scale > 1``, the super-resolution stack
   (``ops/stack.super_res_stack``, kernel B6) on the finer grid.

Options this slice does not port raise ``NotImplementedError`` naming
the ROADMAP.md item that will port them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import constants
from ..errors import InvalidParamsError, NotEnoughFilesError, ProcessingError
from ..params import EccMatchParameters, MotionType
from ..ops import color, ecc as ecc_ops, phasecorr, resize
from ..ops import stack as stack_ops
from ..ops.warp_batch import warp_accumulate_rgb
from ..utils import io
from ..utils.device import resolve_device
from ..utils.tracing import PhaseTimer, PipelineStats

# frames per chunk of the grey conversion (bounds its int32 transients)
_GREY_CHUNK = 16


def _f32(x: float) -> float:
    """A Python float holding the float32 value of ``x`` (JAX's weakly
    typed scalars become float32 before they meet a float32 array)."""
    return float(np.float32(x))


def _adjust_warp_for_scale(
    warps: torch.Tensor, motion_type: MotionType, small_hw, full_hw,
) -> torch.Tensor:
    """Upscale warps estimated on scaled-down frames: the translation
    column scales by full/small, a homography's perspective row divides
    (ref src/lib.rs:941-958)."""
    sx = _f32(full_hw[1] / small_hw[1])
    sy = _f32(full_hw[0] / small_hw[0])
    w = warps.clone()
    w[..., 0, 2] *= sx
    w[..., 1, 2] *= sy
    if motion_type == MotionType.Homography:
        w[..., 2, 0] /= sx
        w[..., 2, 1] /= sy
    return w


def _ecc_grey(frames: torch.Tensor, scale_hw=None) -> torch.Tensor:
    """Stage 1: grey (raw 0..255 float32), INTER_AREA-scaled on the u8
    grey (rounded back to u8 before the float cast, like the
    reference's scale_image of the grey Mat)."""
    out = []
    for s in range(0, frames.shape[0], _GREY_CHUNK):
        grey = color.rgb_to_gray_u8(frames[s : s + _GREY_CHUNK])
        if scale_hw is not None:
            grey = resize.resize(grey, scale_hw)
        out.append(grey)
    return torch.cat(out).to(torch.float32)


def _ecc_warp_accumulate(
    frames: torch.Tensor, warps: torch.Tensor, oks: torch.Tensor,
    motion_type: MotionType, scale_hw=None,
) -> torch.Tensor:
    """Stage 3: rescale warps solved on scaled greys, warp every kept
    frame onto frame 0's grid and sum (frame 0 enters as itself)."""
    h, w = frames.shape[1], frames.shape[2]
    if scale_hw is not None:
        warps = _adjust_warp_for_scale(warps, motion_type, scale_hw, (h, w))
    eye = torch.eye(3, dtype=warps.dtype, device=warps.device)
    warps = torch.where(oks[:, None, None], warps, eye[: warps.shape[1]])
    return color.to_unit_f32(frames[0]) + warp_accumulate_rgb(
        frames[1:], warps, oks,
        perspective=motion_type == MotionType.Homography,
    )


def _ecc_mask(mask, hw, scale_hw=None, device="cpu") -> torch.Tensor:
    """Validate and binarise a user mask (nonzero = valid; ECC's
    reference-frame mask, the keypoint path's detection mask) and, on the
    scaled path, shrink it conservatively to the solve grid: a scaled
    pixel stays valid only if >= half its INTER_AREA footprint was
    (``libstacker_tpu/models/ecc.py`` :93-103, :600-609)."""
    mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    if mask.ndim == 3 and mask.shape[-1] == 1:
        mask = mask[..., 0]
    if mask.shape != tuple(hw):
        raise InvalidParamsError(
            f"mask must be [H,W] matching the frames, got {mask.shape}"
            f" for frames {tuple(hw)}"
        )
    m = torch.from_numpy(np.ascontiguousarray(mask > 0)).to(device)
    m = m.to(torch.float32)
    if scale_hw is not None:
        m = resize.resize(m, scale_hw, constants.INTER_AREA) >= 0.5
        m = m.to(torch.float32)
    return m


def _check_mesh(mesh) -> None:
    """Raise for the option this package does not port yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported to libstacker_tpu_torch yet (ROADMAP.md "
            "Queue A item 16)"
        )


def _single_frame_out(frame, params, device, device_output=False):
    """n == 1: the stack is frame 0 itself, as float32 in [0, 1] —
    INTER_LINEAR-upsampled when a super-resolution grid was asked for
    (``libstacker_tpu/models/keypoint.py`` :360-375).  A numpy frame
    moves to ``device`` first; the upsample runs there and the result is
    fetched to numpy unless ``device_output``."""
    if not isinstance(frame, torch.Tensor):
        frame = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
    scale = 65535.0 if frame.dtype == torch.uint16 else 255.0
    out = frame.to(torch.float32) / scale
    f = params.output_scale
    if f > 1:
        h, w = out.shape[:2]
        out = resize.resize(out.permute(2, 0, 1), (h * f, w * f),
                            constants.INTER_LINEAR).permute(1, 2, 0)
        out = out.contiguous()
    return out if device_output else out.cpu().numpy()


def ecc_match_arrays(
    frames,
    params: EccMatchParameters,
    scale_down_width: Optional[float] = None,
    on_failure: str = "raise",
    return_stats: bool = False,
    mask: Optional[np.ndarray] = None,
    mesh=None,
    device_output: bool = False,
    device="cuda",
):
    """Array-based ``ecc_match``: ``frames`` is ``[N,H,W,3]`` uint8 (or
    uint16) RGB, numpy or a tensor.  A numpy burst is copied to
    ``device`` once ("cuda" by default; asking for CUDA without a card
    raises — pass ``device="cpu"`` for the plain CPU path); a tensor
    runs on its own device.

    Returns the stacked ``[H,W,3]`` float32 RGB image in [0,1] on
    frame 0's grid as numpy, or as a tensor on the device with
    ``device_output=True`` (plus a ``PipelineStats`` with
    ``return_stats``; its ``phase_ms`` holds the stage times, each
    ending in a device synchronise).

    ``mask`` ([H,W], nonzero = valid) is cv2.findTransformECC's
    inputMask over frame 0 (the ECC input image here): it excludes
    pixels from the alignment, not from the stack, and turns the
    phase-correlation start off.  ``params.stacking = "sigma_clip"``
    stacks by per-pixel kappa-sigma clipping over the covered samples
    (``clipped_sample_frac`` in the stats).  ``params.output_scale = f``
    (2-4) returns the ``[f*H, f*W, 3]`` super-resolution stack;
    ``params.solver`` picks the ECC formulation ('forward', 'lazy',
    'ic') and ``params.phase_init_rotation`` the rotation/scale start.
    The super-resolution and sigma-clip images are final: failed frames
    are left out of them under ``on_failure="drop"``."""
    params.validate()
    _check_mesh(mesh)
    if isinstance(frames, torch.Tensor):
        dev = resolve_device(frames.device)
        dtype_ok = frames.dtype in (torch.uint8, torch.uint16)
    else:
        frames = np.asarray(frames)
        dev = resolve_device(device)
        dtype_ok = frames.dtype in (np.uint8, np.uint16)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise InvalidParamsError(
            f"frames must be [N,H,W,3] uint8/uint16, got {tuple(frames.shape)}"
        )
    if not dtype_ok:
        raise InvalidParamsError(
            f"frames must be uint8 or uint16, got {frames.dtype}"
        )
    n, h, w = frames.shape[:3]
    if n == 0:
        raise NotEnoughFilesError()
    num_iters, eps = params.resolve_criteria()

    scale_hw = None
    if scale_down_width is not None:
        if scale_down_width >= w:
            raise InvalidParamsError(
                "scale_down_to was larger (or equal) to the full image "
                f"width: full_size:{w}, scale_down_to:{scale_down_width}"
            )
        if scale_down_width <= 10.0:
            raise InvalidParamsError(
                f"scale_down_to was too small scale_down_to:{scale_down_width}"
            )
        scale_hw = resize.scale_image_size(h, w, scale_down_width)

    if n == 1:
        # reference: stacked = sum / 1 = frame 0 (src/lib.rs:836-843)
        out = _single_frame_out(frames[0], params, dev, device_output)
        if return_stats:
            return out, PipelineStats(frames_total=1, frames_kept=1,
                                      frames_dropped=0)
        return out

    if isinstance(frames, torch.Tensor):
        frames_t = frames.contiguous()
    else:
        frames_t = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
    timer = PhaseTimer(dev) if return_stats else None
    motion = params.motion_type
    input_mask = None
    if mask is not None:
        input_mask = _ecc_mask(mask, (h, w), scale_hw, dev)
    with ecc_ops._phase(timer, "grey"):
        grey = _ecc_grey(frames_t, scale_hw)
    warp_init = None
    if params.phase_init and input_mask is None:
        with ecc_ops._phase(timer, "phase init"):
            warp_init = phasecorr.phase_init_warps(
                grey[1:], grey[0], motion_type=motion,
                rotation=params.phase_init_rotation,
            )
    result = ecc_ops.find_transform_ecc_batched(
        grey[1:], grey[0], motion_type=motion, num_iters=num_iters,
        eps=eps, gauss_filt_size=params.gauss_filt_size,
        coarse_levels=params.coarse_levels, warp_init=warp_init,
        mode=params.solver, input_mask=input_mask, timer=timer,
    )
    del grey
    sigma = params.stacking == "sigma_clip"
    sr_factor = params.output_scale
    final = sigma or sr_factor > 1  # per-pixel divisors: no divide below
    clip_frac = None
    with ecc_ops._phase(timer, "stack"):
        warps = result.warp_matrix
        if final and scale_hw is not None:
            warps = _adjust_warp_for_scale(warps, motion, scale_hw, (h, w))
        if sr_factor > 1:
            stacked = stack_ops.super_res_stack(
                frames_t, warps, result.ok, factor=sr_factor,
                perspective=motion == MotionType.Homography,
            )
        elif sigma:
            stacked, clip_frac = stack_ops.kappa_sigma_stack(
                frames_t, warps, result.ok,
                perspective=motion == MotionType.Homography,
                kappa=params.sigma_kappa, iters=params.sigma_iters,
            )
        else:
            stacked = _ecc_warp_accumulate(
                frames_t, result.warp_matrix, result.ok, motion, scale_hw,
            )
    ok = result.ok.cpu().numpy()
    stats = None
    if return_stats:
        stats = PipelineStats(
            frames_total=n,
            frames_kept=1 + int(ok.sum()),
            frames_dropped=int((~ok).sum()),
            ecc_iterations=result.num_iters.cpu().tolist(),
            ecc_rho=result.rho.cpu().tolist(),
            clipped_sample_frac=clip_frac,
            phase_ms=timer.ms(),
        )
    fetch = (lambda x: x) if device_output else (lambda x: x.cpu().numpy())
    count = n
    if not ok.all():
        bad = np.nonzero(~ok)[0] + 1
        if on_failure == "raise":
            raise ProcessingError(
                "findTransformECC failed to converge for frames "
                f"{bad.tolist()} (NaN correlation or non-positive lambda "
                "denominator)"
            )
        # drop mode: failed frames contributed nothing to the sum
        count = 1 + int(ok.sum())
    # the sigma-clip and super-resolution images are final (per-pixel
    # divisors, failed lanes already excluded)
    out = fetch(stacked) if final else fetch(stacked) / count
    return (out, stats) if return_stats else out


def ecc_match(
    files: Sequence,
    params: EccMatchParameters,
    scale_down_width: Optional[float] = None,
    on_failure: str = "raise",
    return_stats: bool = False,
    mask: Optional[np.ndarray] = None,
    preserve_depth: bool = False,
    mesh=None,
    device="cuda",
):
    """Align and stack image files with ECC (ref src/lib.rs:702-717):
    decode on the host (``utils.io.load_frames``: the native loader, else
    PIL), then :func:`ecc_match_arrays` on ``device``.
    ``preserve_depth`` decodes 16-bit files to uint16 and stacks at full
    depth (alignment is unchanged; pair with
    ``save_image(..., bit_depth=16)``)."""
    frames = io.load_frames(files, preserve_depth=preserve_depth)
    return ecc_match_arrays(
        frames, params, scale_down_width, on_failure, return_stats,
        mask=mask, mesh=mesh, device=device,
    )


def ecc_match_stream(*args, **kwargs):
    """Streaming ``ecc_match`` — not ported yet."""
    raise NotImplementedError(
        "ecc_match_stream is not ported to libstacker_tpu_torch yet "
        "(ROADMAP.md Queue A item 14b)"
    )
