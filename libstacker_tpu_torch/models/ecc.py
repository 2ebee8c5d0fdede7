"""``ecc_match`` pipeline — ECC-aligned burst stacking.

Counterpart of ``libstacker_tpu/models/ecc.py`` (stages of
``ecc_match_arrays`` :507, ``ecc_match`` :735, ``ecc_match_stream``
:763), in the reference's convention: template = current frame's grey, input = frame
0's grey (ref src/lib.rs:769-777); the solved warp is applied forward to
the current frame with BORDER_CONSTANT 0 (src/lib.rs:780-803); the sum
divides by the total frame count (src/lib.rs:837), and a failed frame
raises ``ProcessingError`` — or is dropped with ``on_failure="drop"``.

Stages, all on one device (or per shard of a mesh):

1. fixed-point grey as float32 (``ops/color.burst_grey_f32``: one pass
   of ``csrc/grey.cu``, or INTER_AREA-scaled on the scaled path);
2. phase-correlation start (``ops/phasecorr``; translation, or with
   ``phase_init_rotation`` rotation/scale first; off when a ``mask`` is
   given), then
3. batched ECC with optional 2x octaves (``ops/ecc.align_lanes``): kernel
   B1 (its 4-plane form with a ``mask``), B1 without the Gram for
   ``solver="lazy"``, B7 for ``solver="ic"``;
4. fused warp + sum of the kept frames (``ops/warp_batch.warp_sum_burst``,
   kernel B2), divided by the frame count; or, with ``stacking="sigma_clip"``, the
   kappa-sigma stack (``ops/stack``, kernel B4) with per-pixel divisors;
   or, with ``output_scale > 1``, the super-resolution stack
   (``ops/stack.super_res_stack``, kernel B6) on the finer grid.

``ecc_match_stream`` runs stages 1-4 chunk by chunk over decoded files
(the same kernels per chunk) and keeps only the running sum, or, for
sigma-clip, the warps and then the per-pixel moments; it is resumable
from a checkpoint file.  ``mesh=`` runs every entry point over a device
mesh (``parallel/mesh.py``): the burst's frames are sharded over the
mesh's ``'data'`` axis, each shard runs the stages above on its own
device, and the sums are reduced across devices and processes.  The
plumbing shared with ``models/keypoint.py`` is ``models/_entry.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..errors import ProcessingError
from ..params import EccMatchParameters, MotionType
from ..ops import color, ecc as ecc_ops, warp
from ..ops import stack as stack_ops
from ..ops.warp_batch import warp_sum_burst
from ..parallel import mesh as pmesh
from ..utils import checkpoint as ckpt_mod
from ..utils import io
from ..utils.tracing import PhaseTimer, PipelineStats
from . import _entry


def _ecc_match_arrays_sharded(frames, params, scale_hw, on_failure,
                              return_stats, mask, mesh, device_output):
    """``ecc_match_arrays`` over a mesh (``libstacker_tpu/models/ecc.py``
    :425-504): every frame (frame 0 included) is a lane of
    ``parallel.mesh``'s sharded step, the burst padded to the ``'data'``
    axis with copies of frame 0.  Returns as the dense path does."""
    n, h, w = frames.shape[:3]
    dev0 = mesh.devices[0, 0]
    with pmesh._on(dev0):
        f0 = _entry.to_device(frames[:1], dev0).to(dev0)
        input_mask = None
        if mask is not None:
            input_mask = _entry.grid_mask(mask, (h, w), scale_hw, dev0)
        ref_grey = color.burst_grey_f32(f0, scale_hw)[0]
    sigma = params.stacking == "sigma_clip"
    sr_factor = params.output_scale
    final = sigma or sr_factor > 1
    frames_p, lane_valid, identity = _entry.mesh_lanes(
        frames, mesh, sr_factor > 1, sigma)
    total, ok, rho, iters, clip_frac = pmesh._ecc_step(
        frames_p, ref_grey, mesh, scale_hw=scale_hw, stacking=params.stacking,
        sigma_kappa=params.sigma_kappa, sigma_iters=params.sigma_iters,
        lane_valid=lane_valid, output_scale=sr_factor, identity=identity,
        **_entry.ecc_solve_args(params, input_mask),
    )
    out, ok = _entry.mesh_result(total, ok, n, f0, final, device_output)
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
    return (out, stats) if return_stats else out


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
    frames, dev = _entry.check_frames(frames, device, mesh)
    n, h, w = frames.shape[:3]
    scale_hw = _entry.solve_grid(h, w, scale_down_width)

    if n == 1:
        # reference: stacked = sum / 1 = frame 0 (src/lib.rs:836-843)
        out = _entry.single_frame_out(frames[0], params, dev, device_output)
        if return_stats:
            return out, PipelineStats(frames_total=1, frames_kept=1,
                                      frames_dropped=0)
        return out

    mesh = _entry.resolve_mesh(mesh, dev)
    if mesh is not None:
        return _ecc_match_arrays_sharded(
            frames, params, scale_hw, on_failure, return_stats, mask, mesh,
            device_output,
        )
    frames_t = _entry.to_device(frames, dev)
    timer = PhaseTimer(dev) if return_stats else None
    input_mask = None
    if mask is not None:
        input_mask = _entry.grid_mask(mask, (h, w), scale_hw, dev)
    with ecc_ops._phase(timer, "grey"):
        grey = color.burst_grey_f32(frames_t, scale_hw)
    result = ecc_ops.align_lanes(
        grey[1:], grey[0], timer=timer,
        **_entry.ecc_solve_args(params, input_mask),
    )
    del grey
    perspective = params.motion_type == MotionType.Homography
    sigma = params.stacking == "sigma_clip"
    sr_factor = params.output_scale
    final = sigma or sr_factor > 1  # per-pixel divisors: no divide below
    clip_frac = None
    with ecc_ops._phase(timer, "stack"):
        warps = result.warp_matrix
        if final and scale_hw is not None:
            warps = warp.rescale_maps(warps, scale_hw, (h, w))
        if sr_factor > 1:
            stacked = stack_ops.super_res_stack(
                frames_t, warps, result.ok, factor=sr_factor,
                perspective=perspective,
            )
        elif sigma:
            stacked, clip_frac = stack_ops.kappa_sigma_stack(
                frames_t, warps, result.ok, perspective=perspective,
                kappa=params.sigma_kappa, iters=params.sigma_iters,
            )
        else:
            stacked = warp_sum_burst(frames_t, warps, result.ok,
                                     perspective=perspective,
                                     scale_hw=scale_hw)
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
    out = _entry.fetch(stacked, device_output)
    if not final:
        out = out / count
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


def _ecc_stream_chunks(chunks, mesh, ref, ref_grey, params, scale_hw,
                       input_mask, hw):
    """The align pass of ``ecc_match_stream``: per chunk -> ``(sum of its
    kept frames, or for sigma-clip its full-resolution warps; ok;
    iterations; rho; is_last)``.  Each chunk is padded with frame 0 to a
    multiple of the mesh's ``'data'`` axis (no pad on one device),
    sharded (``parallel.mesh.ShardUploader``: each shard's rows copied to
    its own device), solved and summed per shard and the sums reduced;
    the pad lanes are left out and sliced off."""
    solve = _entry.ecc_solve_args(params, input_mask)
    for sf, n_real, last in pmesh.ShardUploader(mesh).staged(chunks,
                                                              fill=ref[0]):
        if params.stacking == "sigma_clip":
            part, rho, iters, ok = pmesh._ecc_solve_gathered(
                sf, ref_grey, mesh, scale_hw=scale_hw, full_hw=hw, **solve)
            part = part[:n_real]
        else:
            part, ok, rho, iters, _ = pmesh._ecc_step(
                sf, ref_grey, mesh, scale_hw=scale_hw,
                lane_valid=np.arange(sf.n_global) < n_real, **solve)
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
    the warps, then ``models/_entry.stream_sigma_stack`` sums the moments over
    ``1 + sigma_iters`` more decode passes.  ``output_scale != 1``
    raises.  Returns the ``[H,W,3]`` float32 stack as numpy (plus a
    ``PipelineStats`` with ``return_stats``); the divisor is the frame
    count, or ``1 + kept`` under ``on_failure="drop"``.

    Over a ``mesh`` (see :func:`ecc_match_arrays`) ``chunk_size`` rounds
    up to a multiple of its ``'data'`` axis; each chunk is padded with
    frame 0, sharded, and solved and summed per shard, the sums (or, for
    sigma-clip, each sweep's moments) reduced per chunk.  Without one the
    stream runs the same code on a one-device mesh."""
    files = _entry.stream_guards(params, files)
    mesh, chunk_size = _entry.stream_mesh(mesh, device, chunk_size)
    dev = mesh.devices[0, 0]
    sigma = params.stacking == "sigma_clip"
    motion = params.motion_type

    ref = io.load_frames(files[:1], preserve_depth=preserve_depth)
    n_total = len(files)
    h, w = ref.shape[1:3]
    scale_hw = _entry.solve_grid(h, w, scale_down_width)
    with pmesh._on(dev):
        ref_t = torch.from_numpy(ref).to(dev)
        ref_grey = color.burst_grey_f32(ref_t, scale_hw)[0]
        input_mask = None
        if mask is not None:
            input_mask = _entry.grid_mask(mask, (h, w), scale_hw, dev)
        acc = color.to_unit_f32(ref_t[0])
    all_ok, all_iters, all_rho, all_warps = [], [], [], []
    ckpt = None
    chunks_done = 0
    sigma_resume = None
    if checkpoint_path is not None:
        ckpt = ckpt_mod.StreamCheckpoint(
            checkpoint_path,
            ckpt_mod.burst_key(files, params, scale_down_width, chunk_size,
                               extra="ecc", mask=_entry.mask_key(mask)),
        )
        chunks_done, state = ckpt.load()
        if state is not None and int(state.get("phase", 0)) == 1:
            # inside the sigma-clip sweeps: the align pass is done
            sigma_resume = _entry.sigma_resume(state, chunks_done)
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
        stacked, clip_frac = _entry.stream_sigma_stack(
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
