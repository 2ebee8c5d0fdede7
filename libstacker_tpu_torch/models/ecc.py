"""``ecc_match`` pipeline — ECC-aligned burst stacking.

Counterpart of ``libstacker_tpu/models/ecc.py`` (``_adjust_warp_for_scale``
:49, ``_stream_sigma_stack`` :170, stages of ``ecc_match_arrays`` :507,
``ecc_match`` :735, ``ecc_match_stream`` :763), in the
reference's convention: template = current frame's grey, input = frame
0's grey (ref src/lib.rs:769-777); the solved warp is applied forward to
the current frame with BORDER_CONSTANT 0 (src/lib.rs:780-803); the sum
divides by the total frame count (src/lib.rs:837), and a failed frame
raises ``ProcessingError`` — or is dropped with ``on_failure="drop"``.

Stages, all on one device (or per shard of a mesh):

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

``ecc_match_stream`` runs stages 1-4 chunk by chunk over decoded files
(the same kernels per chunk) and keeps only the running sum, or, for
sigma-clip, the warps and then the per-pixel moments; it is resumable
from a checkpoint file.  ``mesh=`` runs every entry point over a device
mesh (``parallel/mesh.py``): the burst's frames are sharded over the
mesh's ``'data'`` axis, each shard runs the stages above on its own
device, and the sums are reduced across devices and processes.
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
from ..utils import checkpoint as ckpt_mod
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


def _warp_lanes(
    frames: torch.Tensor, warps: torch.Tensor, oks: torch.Tensor,
    motion_type: MotionType, scale_hw=None,
) -> torch.Tensor:
    """Stage 3 without frame 0: rescale warps solved on scaled greys,
    give failed lanes the identity (NaN * 0 is NaN) and warp-and-sum the
    kept frames onto frame 0's grid (kernel B2)."""
    h, w = frames.shape[1], frames.shape[2]
    if scale_hw is not None:
        warps = _adjust_warp_for_scale(warps, motion_type, scale_hw, (h, w))
    eye = torch.eye(3, dtype=warps.dtype, device=warps.device)
    warps = torch.where(oks[:, None, None], warps, eye[: warps.shape[1]])
    return warp_accumulate_rgb(
        frames, warps, oks, perspective=motion_type == MotionType.Homography,
    )


def _ecc_warp_accumulate(
    frames: torch.Tensor, warps: torch.Tensor, oks: torch.Tensor,
    motion_type: MotionType, scale_hw=None,
) -> torch.Tensor:
    """Stage 3: frame 0 as itself plus the warped kept frames 1..N-1."""
    return color.to_unit_f32(frames[0]) + _warp_lanes(
        frames[1:], warps, oks, motion_type, scale_hw)


def _scale_hw(h: int, w: int, scale_down_width, min_width: bool = True):
    """The solve grid of the scaled path, or None; raises the reference's
    errors for a width >= the frame's and, on the ECC path
    (``min_width``), <= 10 (src/lib.rs:377, :883)."""
    if scale_down_width is None:
        return None
    if scale_down_width >= w:
        raise InvalidParamsError(
            "scale_down_to was larger (or equal) to the full image "
            f"width: full_size:{w}, scale_down_to:{scale_down_width}"
        )
    if min_width and scale_down_width <= 10.0:
        raise InvalidParamsError(
            f"scale_down_to was too small scale_down_to:{scale_down_width}"
        )
    return resize.scale_image_size(h, w, scale_down_width)


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


def _resolve_mesh(mesh, device):
    """The public ``mesh=`` argument -> a ``parallel.Mesh`` or None:
    ``"auto"`` is a data mesh over every visible CUDA device, or a
    one-device CPU mesh when ``device`` is the CPU (it never becomes a
    CPU mesh when a card was asked for); a mesh with a ``'data'`` axis
    passes through (``libstacker_tpu/models/ecc.py`` :381-406)."""
    if mesh is None:
        return None
    from ..parallel import mesh as pmesh

    if isinstance(mesh, str):
        if mesh != "auto":
            raise InvalidParamsError(
                "mesh must be None, 'auto' or a "
                f"libstacker_tpu_torch.parallel Mesh, got {mesh!r}"
            )
        dev = resolve_device(device)
        return pmesh.make_mesh([dev] if dev.type == "cpu" else None)
    if "data" not in getattr(mesh, "axis_names", ()):
        raise InvalidParamsError(
            "mesh must have a 'data' axis (parallel.make_mesh builds one)"
        )
    return mesh


def _numpy_device(device, mesh) -> torch.device:
    """Where an entry point puts a numpy burst: ``device``, or the first
    device of an explicit mesh (the shards then go to theirs)."""
    if isinstance(mesh, str) or "data" not in getattr(mesh, "axis_names", ()):
        return resolve_device(device)
    return mesh.devices[0, 0]


def _pad_burst(frames, ndata: int):
    """Pad the frame axis to a multiple of the ``'data'`` axis with
    copies of frame 0 -> ``(frames, lane_valid [N'] bool)``; the pad
    lanes are left out through ``lane_valid``
    (``libstacker_tpu/models/ecc.py`` :409-422)."""
    n = frames.shape[0]
    pad = (-n) % ndata
    if pad == 0:
        return frames, np.ones(n, bool)
    if isinstance(frames, torch.Tensor):
        frames = torch.cat([frames, frames[:1].expand(pad, *frames.shape[1:])])
    else:
        frames = np.concatenate([frames, np.repeat(frames[:1], pad, axis=0)])
    return frames, np.arange(n + pad) < n


def _frame0_lanes(n: int, final_sr: bool, sigma: bool):
    """How frame 0 (lane 0) enters a mesh stack -> ``(exclude, identity)``
    lane masks: the mean leaves lane 0 out of the sum and adds frame 0
    after the reduction, as the dense path adds it; sigma-clip stacks it
    with the exact identity; super-resolution uses its solved lane, as
    the JAX package's mesh does."""
    exclude = np.zeros(n, bool)
    identity = np.zeros(n, bool)
    if sigma:
        identity[0] = True
    elif not final_sr:
        exclude[0] = True
    return exclude, identity


def _ecc_match_arrays_sharded(frames, params, scale_hw, on_failure,
                              return_stats, mask, mesh, device_output):
    """``ecc_match_arrays`` over a mesh (``libstacker_tpu/models/ecc.py``
    :425-504): every frame (frame 0 included) is a lane of
    ``parallel.mesh``'s sharded step, the burst padded to the ``'data'``
    axis with copies of frame 0.  Returns as the dense path does."""
    from ..parallel import mesh as pmesh

    n, h, w = frames.shape[:3]
    dev0 = mesh.devices[0, 0]
    num_iters, eps = params.resolve_criteria()
    f0 = frames[:1]
    with pmesh._on(dev0):
        f0 = (f0 if isinstance(f0, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(f0))).to(dev0)
        input_mask = None
        if mask is not None:
            input_mask = _ecc_mask(mask, (h, w), scale_hw, dev0)
        ref_grey = _ecc_grey(f0, scale_hw)[0]
    sigma = params.stacking == "sigma_clip"
    sr_factor = params.output_scale
    final = sigma or sr_factor > 1
    frames_p, lane_valid = _pad_burst(frames, mesh.shape["data"])
    exclude, identity = _frame0_lanes(len(lane_valid), sr_factor > 1, sigma)
    total, ok, rho, iters, clip_frac = pmesh._ecc_step(
        frames_p, ref_grey, mesh, motion_type=params.motion_type,
        num_iters=num_iters, eps=eps, gauss_filt_size=params.gauss_filt_size,
        phase_init=params.phase_init,
        phase_init_rotation=params.phase_init_rotation,
        stacking=params.stacking, sigma_kappa=params.sigma_kappa,
        sigma_iters=params.sigma_iters, scale_hw=scale_hw,
        coarse_levels=params.coarse_levels, input_mask=input_mask,
        lane_valid=lane_valid & ~exclude, output_scale=sr_factor,
        mode=params.solver, identity=identity,
    )
    ok = ok[:n].copy()
    if not final:
        ok[0] = True
        total = color.to_unit_f32(f0[0]) + total
    stats = None
    if return_stats:
        stats = PipelineStats(
            frames_total=n,
            frames_kept=int(ok.sum()),
            frames_dropped=int((~ok).sum()),
            ecc_iterations=iters[1:n].tolist(),
            ecc_rho=rho[1:n].tolist(),
            clipped_sample_frac=clip_frac,
        )
    if not ok.all() and on_failure == "raise":
        bad = np.nonzero(~ok)[0]
        raise ProcessingError(
            "findTransformECC failed to converge for frames "
            f"{bad.tolist()} (NaN correlation or non-positive lambda "
            "denominator)"
        )
    fetch = (lambda x: x) if device_output else (lambda x: x.cpu().numpy())
    out = fetch(total) if final else fetch(total) / int(ok.sum())
    return (out, stats) if return_stats else out


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
    are left out of them under ``on_failure="drop"``.

    ``mesh``: None (one device), ``"auto"`` (every visible CUDA device;
    one CPU shard with ``device="cpu"``) or a ``parallel.Mesh`` with a
    ``'data'`` axis (``parallel.make_mesh``, ``make_global_mesh``): the
    frames are sharded over it (padded with copies of frame 0) and each
    shard is solved and stacked on its own device, the sums reduced
    across devices and processes; the result and stats are the dense
    path's."""
    params.validate()
    if isinstance(frames, torch.Tensor):
        dev = resolve_device(frames.device)
        dtype_ok = frames.dtype in (torch.uint8, torch.uint16)
    else:
        frames = np.asarray(frames)
        dev = _numpy_device(device, mesh)
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

    scale_hw = _scale_hw(h, w, scale_down_width)

    if n == 1:
        # reference: stacked = sum / 1 = frame 0 (src/lib.rs:836-843)
        out = _single_frame_out(frames[0], params, dev, device_output)
        if return_stats:
            return out, PipelineStats(frames_total=1, frames_kept=1,
                                      frames_dropped=0)
        return out

    mesh = _resolve_mesh(mesh, dev)
    if mesh is not None:
        return _ecc_match_arrays_sharded(
            frames, params, scale_hw, on_failure, return_stats, mask, mesh,
            device_output,
        )
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
            spans=timer.spans(),
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


def _mask_key(mask):
    """The user's mask as numpy, for the checkpoint's key."""
    if mask is None:
        return None
    return mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)


def _stream_guards(params, files):
    """The checks both streams make before decoding anything ->
    normalised file list."""
    params.validate()
    if params.output_scale != 1:
        raise InvalidParamsError(
            "output_scale stacking is not available in the"
            " streaming pipelines; use the whole-burst entry points"
        )
    files = io.normalize_files(files)
    if not files:
        raise NotEnoughFilesError()
    return files


def _stream_mesh(mesh, device, chunk_size: int):
    """A stream's mesh and chunk size: the ``mesh`` argument, or without
    one a one-device mesh on ``device``; the stream runs on its devices
    (``devices[0, 0]`` holds the running sum) and ``chunk_size`` rounds
    up to a multiple of the ``'data'`` axis, which the checkpoint's key
    then holds (``libstacker_tpu/models/ecc.py`` :808-811)."""
    from ..parallel import mesh as pmesh

    mesh = _resolve_mesh(mesh, device)
    if mesh is None:
        mesh = pmesh.make_mesh([resolve_device(device)])
    ndata = mesh.shape["data"]
    return mesh, -(-chunk_size // ndata) * ndata


def _sigma_resume(state: dict, cursor: int) -> dict:
    """The sweep state a phase=1 checkpoint holds."""
    return dict(
        pass_idx=int(state["pass_idx"]),
        cursor=int(cursor),
        part=(state["part0"], state["part1"], state["part2"]),
        base=((state["base0"], state["base1"], state["base2"])
              if int(state["has_base"]) else None),
        total_s0=float(state["total_s0"]),
    )


def _stream_sigma_stack(
    files,
    mats_full: np.ndarray,  # [N-1,2|3,3] full-res forward maps, frames 1..
    oks: np.ndarray,  # [N-1] bool
    perspective: bool,
    kappa: float,
    iters: int,
    chunk_size: int,
    hw,
    mesh,
    preserve_depth: bool = False,
    ckpt=None,
    checkpoint_every: int = 4,
    align_save: Optional[dict] = None,
    resume: Optional[dict] = None,
):
    """Streaming kappa-sigma stack: the S0/S1/S2 moments of
    ``ops/stack.py`` summed over decoded chunks of the files, ``1 +
    iters`` decode passes after the align pass; only the per-pixel
    moments stay resident.  Each chunk of files is padded to a multiple
    of the ``mesh``'s ``'data'`` axis (pad lanes ``oks=False``; no pad on
    one device), sharded, and each shard's moments (one launch of B4 on
    CUDA, ``stack.moments_chunk``) reduced over ``'data'``
    (``parallel.mesh.stream_moments``); lanes are indexed from file 0
    (frame 0 the identity lane).

    ``ckpt`` makes the sweeps resumable: every ``checkpoint_every``
    chunks the pass index, chunk cursor, partial moments, the pass's
    entry state and the pass-0 sample total are written (phase=1
    records; ``align_save`` carries the align pass's products, saved as
    ``al_*``).  ``resume`` is :func:`_sigma_resume` of such a record.

    Returns ``(image [H,W,3] float32 tensor, clipped_sample_frac)``."""
    from ..parallel import mesh as pmesh

    h, w = int(hw[0]), int(hw[1])
    device = mesh.devices[0, 0]
    minv, oks_all = stack_ops.sweep_lanes(
        torch.from_numpy(np.asarray(mats_full, np.float32)),
        torch.from_numpy(np.asarray(oks, bool)), device)
    n_all = minv.shape[0]
    up = pmesh.ShardUploader(mesh)
    pad = (-n_all) % mesh.shape["data"]
    eye = torch.eye(3, dtype=torch.float32, device=device)
    minv = torch.cat([minv, eye.expand(pad, 3, 3)])
    oks_all = torch.cat([oks_all, oks_all.new_zeros(pad)])
    # the pass running (0 = initial moments, 1..iters = clip passes), the
    # state ENTERING the current clip pass, the pass-0 sample total
    cell = {"pass": 0, "base": None,
            "total_s0": None if resume is None else resume["total_s0"]}

    def host(x):
        return x.cpu().numpy()

    def save_state(cursor, acc):
        state = dict(
            phase=np.int64(1), pass_idx=np.int64(cell["pass"]),
            part0=host(acc[0]), part1=host(acc[1]), part2=host(acc[2]),
            has_base=np.int64(cell["base"] is not None),
            total_s0=np.float64(cell["total_s0"] or 0.0),
        )
        if cell["base"] is not None:
            b = cell["base"]
            state.update(base0=host(b[0]), base1=host(b[1]), base2=host(b[2]))
        if align_save:
            state.update({f"al_{k}": v for k, v in align_save.items()})
        ckpt.save(cursor, **state)

    def sweep(mu=None, tol=None):
        acc = None
        start_chunk = 0
        if resume is not None and resume["pass_idx"] == cell["pass"]:
            start_chunk = resume["cursor"]
            acc = tuple(torch.from_numpy(x).to(device) for x in resume["part"])
        lane = start_chunk * chunk_size
        chunk_i = start_chunk
        for frames in io.prefetched_chunks(
            files, chunk_size, h, w, start=lane,
            preserve_depth=preserve_depth,
        ):
            sf = up.ready(up.put(up.padded(frames)))
            rows = slice(lane, lane + sf.n_global)
            part = pmesh.stream_moments(sf, minv[rows], oks_all[rows], mesh,
                                        mu, tol, perspective)
            acc = part if acc is None else tuple(
                a + p for a, p in zip(acc, part))
            lane += frames.shape[0]
            chunk_i += 1
            if (ckpt is not None and lane < n_all
                    and chunk_i % max(checkpoint_every, 1) == 0):
                save_state(chunk_i, acc)
        return acc

    def clip_cb(mu, tol):
        res = sweep(mu, tol)
        cell["pass"] += 1
        return res

    def pass_hook(i, s0c, s1, s2):
        cell["base"] = (s0c, s1, s2)

    if resume is not None and resume["pass_idx"] >= 1:
        cell["pass"] = resume["pass_idx"]
        entry = tuple(torch.from_numpy(x).to(device) for x in resume["base"])
        cell["base"] = entry
        out, kept = stack_ops.clip_iterate(
            None, None, None, kappa, iters, clip_cb, start_pass=cell["pass"],
            entry_state=entry, pass_hook=pass_hook,
        )
    else:
        s0, s1, s2 = sweep()
        cell["total_s0"] = float(s0.sum())
        cell["pass"] = 1
        cell["base"] = (s0[..., None], s1, s2)
        out, kept = stack_ops.clip_iterate(
            s0, s1, s2, kappa, iters, clip_cb, pass_hook=pass_hook,
        )
    kept_frac = float(kept.sum()) / max(cell["total_s0"] * 3.0, 1.0)
    return out, max(0.0, 1.0 - kept_frac)


def _ecc_stream_chunks(chunks, mesh, ref, ref_grey, params, scale_hw,
                       input_mask, hw):
    """The align pass of ``ecc_match_stream``: per chunk -> ``(sum of its
    kept frames, or for sigma-clip its full-resolution warps; ok;
    iterations; rho; is_last)``.  Each chunk is padded with frame 0 to a
    multiple of the mesh's ``'data'`` axis (no pad on one device),
    sharded (``parallel.mesh.ShardUploader``: each shard's rows copied to
    its own device), solved and summed per shard and the sums reduced;
    the pad lanes are left out and sliced off."""
    from ..parallel import mesh as pmesh

    num_iters, eps = params.resolve_criteria()
    solve = dict(
        motion_type=params.motion_type, num_iters=num_iters, eps=eps,
        gauss_filt_size=params.gauss_filt_size, phase_init=params.phase_init,
        phase_init_rotation=params.phase_init_rotation, scale_hw=scale_hw,
        coarse_levels=params.coarse_levels, input_mask=input_mask,
        mode=params.solver)
    for sf, n_real, last in pmesh.ShardUploader(mesh).staged(chunks,
                                                              fill=ref[0]):
        if params.stacking == "sigma_clip":
            part, rho, iters, ok = pmesh._ecc_solve_gathered(
                sf, ref_grey, mesh, full_hw=hw, **solve)
            part = part[:n_real]
        else:
            part, ok, rho, iters, _ = pmesh._ecc_step(
                sf, ref_grey, mesh, stacking="mean",
                sigma_kappa=params.sigma_kappa,
                sigma_iters=params.sigma_iters,
                lane_valid=np.arange(sf.n_global) < n_real, output_scale=1,
                **solve)
        yield part, ok[:n_real], iters[:n_real], rho[:n_real], last


def ecc_match_stream(
    files: Sequence,
    params: EccMatchParameters,
    scale_down_width: Optional[float] = None,
    chunk_size: int = 16,
    on_failure: str = "raise",
    mask: Optional[np.ndarray] = None,
    preserve_depth: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 4,
    return_stats: bool = False,
    mesh=None,
    device="cuda",
):
    """Streaming ``ecc_match`` for bursts larger than device memory:
    frames are decoded (one chunk ahead on a host thread,
    ``utils.io.prefetched_chunks``), aligned against frame 0 and summed
    in chunks of ``chunk_size``; only frame 0's grey and the running sum
    stay resident.  On CUDA each decoded chunk is copied through pinned
    memory on a side stream while the previous chunk's kernels run
    (``utils.device.ChunkUploader``).  Chunks hold the real frames only
    (each ECC lane stops on its own, so the JAX package's pad lanes
    change nothing and are not made on one device).

    ``checkpoint_path`` makes the run resumable: every
    ``checkpoint_every`` chunks the sum, ok flags, iterations and rho
    (the warps, for sigma-clip) are written atomically
    (``utils.checkpoint``), and a rerun of the same burst resumes at the
    last saved chunk.  The file is keyed to the files, parameters, chunk
    size and mask (a mismatched one is ignored) and removed on success.

    ``params.stacking = "sigma_clip"`` streams too: the align pass keeps
    the warps, then :func:`_stream_sigma_stack` sums the moments over
    ``1 + sigma_iters`` more decode passes.  ``output_scale != 1``
    raises.  Returns the ``[H,W,3]`` float32 stack as numpy (plus a
    ``PipelineStats`` with ``return_stats``); the divisor is the frame
    count, or ``1 + kept`` under ``on_failure="drop"``.

    Over a ``mesh`` (see :func:`ecc_match_arrays`) ``chunk_size`` rounds
    up to a multiple of its ``'data'`` axis; each chunk is padded with
    frame 0, sharded, and solved and summed per shard, the sums (or, for
    sigma-clip, each sweep's moments) reduced per chunk.  Without one the
    stream runs the same code on a one-device mesh."""
    from ..parallel import mesh as pmesh

    files = _stream_guards(params, files)
    mesh, chunk_size = _stream_mesh(mesh, device, chunk_size)
    dev = mesh.devices[0, 0]
    sigma = params.stacking == "sigma_clip"
    motion = params.motion_type

    ref = io.load_frames(files[:1], preserve_depth=preserve_depth)
    n_total = len(files)
    h, w = ref.shape[1:3]
    scale_hw = _scale_hw(h, w, scale_down_width)
    with pmesh._on(dev):
        ref_t = torch.from_numpy(ref).to(dev)
        ref_grey = _ecc_grey(ref_t, scale_hw)[0]
        input_mask = None
        if mask is not None:
            input_mask = _ecc_mask(mask, (h, w), scale_hw, dev)
        acc = color.to_unit_f32(ref_t[0])
    all_ok, all_iters, all_rho, all_warps = [], [], [], []
    ckpt = None
    chunks_done = 0
    sigma_resume = None
    if checkpoint_path is not None:
        ckpt = ckpt_mod.StreamCheckpoint(
            checkpoint_path,
            ckpt_mod.burst_key(files, params, scale_down_width, chunk_size,
                               extra="ecc", mask=_mask_key(mask)),
        )
        chunks_done, state = ckpt.load()
        if state is not None and int(state.get("phase", 0)) == 1:
            # inside the sigma-clip sweeps: the align pass is done
            sigma_resume = _sigma_resume(state, chunks_done)
            all_warps.append(state["al_warps"].astype(np.float32))
            all_ok.append(state["al_ok"].astype(bool))
            all_iters.append(state["al_iters"])
            all_rho.append(state["al_rho"])
            chunks_done = 0
        elif state is not None and chunks_done > 0:
            if "acc" in state:
                acc = torch.from_numpy(state["acc"]).to(dev)
            all_ok.append(state["ok"].astype(bool))
            all_iters.append(state["iters"])
            all_rho.append(state["rho"])
            if sigma:
                all_warps.append(state["warps"].astype(np.float32))

    def save_align():
        st = dict(ok=np.concatenate(all_ok), iters=np.concatenate(all_iters),
                  rho=np.concatenate(all_rho))
        if sigma:
            st["warps"] = np.concatenate(all_warps)
        else:
            st["acc"] = acc.cpu().numpy()
        ckpt.save(chunks_done, **st)

    chunks = () if sigma_resume is not None else io.prefetched_chunks(
        files, chunk_size, h, w, start=1 + chunks_done * chunk_size,
        preserve_depth=preserve_depth,
    )
    for part, ok_c, iters_c, rho_c, last in _ecc_stream_chunks(
            chunks, mesh, ref, ref_grey, params, scale_hw, input_mask,
            (h, w)):
        if sigma:
            all_warps.append(part)
        else:
            acc = acc + part
        all_ok.append(ok_c)
        all_iters.append(iters_c)
        all_rho.append(rho_c)
        chunks_done += 1
        if ckpt is not None and (
            chunks_done % max(checkpoint_every, 1) == 0 or last
        ):
            save_align()

    ok = np.concatenate(all_ok) if all_ok else np.zeros(0, bool)
    iters = np.concatenate(all_iters) if all_iters else np.zeros(0, np.int32)
    rho = np.concatenate(all_rho) if all_rho else np.zeros(0, np.float32)
    if ckpt is not None and not sigma:
        ckpt.remove()
    if not ok.all() and on_failure == "raise":
        bad = np.nonzero(~ok)[0] + 1
        raise ProcessingError(
            f"findTransformECC failed to converge for frames {bad.tolist()}"
        )
    clip_frac = None
    if sigma:
        mats = (np.concatenate(all_warps) if all_warps
                else np.zeros((0, 3, 3), np.float32))
        stacked, clip_frac = _stream_sigma_stack(
            files, mats, ok, perspective=motion == MotionType.Homography,
            kappa=params.sigma_kappa, iters=params.sigma_iters,
            chunk_size=chunk_size, hw=(h, w), mesh=mesh,
            preserve_depth=preserve_depth, ckpt=ckpt,
            checkpoint_every=checkpoint_every,
            align_save=(None if ckpt is None
                        else dict(warps=mats, ok=ok, iters=iters, rho=rho)),
            resume=sigma_resume,
        )
        out = stacked.cpu().numpy()
        if ckpt is not None:
            ckpt.remove()
    else:
        count = n_total if ok.all() else 1 + int(ok.sum())
        out = acc.cpu().numpy() / count
    if return_stats:
        stats = PipelineStats(
            frames_total=n_total,
            frames_kept=1 + int(ok.sum()),
            frames_dropped=int((~ok).sum()),
            ecc_iterations=iters.tolist(),
            ecc_rho=rho.tolist(),
            clipped_sample_frac=clip_frac,
        )
        return out, stats
    return out
