"""``keypoint_match`` pipeline — ORB/RANSAC-aligned burst stacking.

Counterpart of ``libstacker_tpu/models/keypoint.py``
(``keypoint_match_arrays`` :466, ``keypoint_match`` :674,
``keypoint_match_stream`` :697), itself the counterpart of the
reference's ``keypoint_match`` (src/lib.rs:129-144, 146-601).  Stages,
all on one device:

1. grey (``ops/color.burst_grey_u8``), INTER_AREA-scaled on the scaled
   path;
2. ORB on every frame in one batched call per pyramid level
   (``ops/orb``, kernels B8 and B3), with an optional detection mask;
3. Hamming 2-NN matching against frame 0, ratio / sort / keep filter and
   RANSAC homographies (``ops/ransac.match_and_estimate``, called as this
   module's ``_match_and_estimate``), all frames at once;
4. frame 0 plus the masked sum of the aligned frames 1..N-1, divided by
   the kept count (``ops/warp_batch.warp_sum_burst``): BORDER_CONSTANT and
   BORDER_TRANSPARENT through the fused warp-and-sum (kernel B2), the
   index-mapping border modes through B5's accumulate form; or, with
   ``stacking="sigma_clip"``, the kappa-sigma stack
   (``ops/stack``, kernel B4); or, with ``output_scale > 1``, the
   super-resolution stack (``ops/stack.super_res_stack``, kernel B6).

Drop bookkeeping follows the JAX package (SURVEY.md §3.1): frames with
fewer than 5 kept matches, a failed estimate or |det H| < 1e-6 are
dropped, contribute nothing, and the divisor is ``1 + kept``.  The JAX
package's detection chunk budget and speculative warp exist for the
TPU and have no counterpart.  ``keypoint_match_stream`` runs stages
1-4 chunk by chunk over decoded files against frame 0's features and is
resumable from a checkpoint file.  ``mesh=`` runs every entry point
over a device mesh (``parallel/mesh.py``): each shard detects, matches
against frame 0's features and runs RANSAC from its own generator, and
the sums are reduced across devices and processes.  The plumbing
shared with ``models/ecc.py`` is ``models/_entry.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import constants
from ..errors import InvalidParamsError
from ..params import KeyPointMatchParameters
from ..ops import color, orb, ransac, warp
from ..ops import stack as stack_ops
from ..ops.warp_batch import warp_sum_burst
from ..parallel import mesh as pmesh
from ..utils import checkpoint as ckpt_mod
from ..utils import io
from ..utils.tracing import PhaseTimer, PipelineStats, phase_of
from . import _entry

# stage 3, called through this module attribute: the benchmark
# (stackbench) wraps it to record or move the homographies
_match_and_estimate = ransac.match_and_estimate


def _check_border(params: KeyPointMatchParameters) -> None:
    """Raise for sigma-clip or super-resolution with a border mode that
    has no coverage (``libstacker_tpu/models/keypoint.py`` :568-577)."""
    border = constants.border_mode_name(params.border_mode)
    if ((params.stacking == "sigma_clip" or params.output_scale > 1)
            and border not in ("constant", "transparent")):
        raise InvalidParamsError(
            "stacking='sigma_clip' / output_scale>1 require "
            "BORDER_CONSTANT or BORDER_TRANSPARENT (sample inclusion is "
            f"defined by warp coverage), got border mode {border!r}"
        )


def _keypoint_match_arrays_sharded(frames, params, scale_hw, seed,
                                   return_stats, mask, mesh, device_output):
    """``keypoint_match_arrays`` over a mesh
    (``libstacker_tpu/models/keypoint.py`` :378-465): frame 0's features
    detected once on ``devices[0, 0]``; every frame (frame 0 included) a
    lane of ``parallel.mesh``'s sharded step, the burst padded to the
    ``'data'`` axis with copies of frame 0.  Returns as the dense path
    does."""
    n, h, w = frames.shape[:3]
    dev0 = mesh.devices[0, 0]
    with pmesh._on(dev0):
        f0 = _entry.to_device(frames[:1], dev0).to(dev0)
        det_mask = None if mask is None else _entry.grid_mask(
            mask, (h, w), scale_hw, dev0)
        feats0 = orb.orb_detect_and_compute(
            color.burst_grey_u8(f0, scale_hw), mask=det_mask)
    sigma = params.stacking == "sigma_clip"
    sr_factor = params.output_scale
    final = sigma or sr_factor > 1
    frames_p, lane_valid, identity = _entry.mesh_lanes(
        frames, mesh, sr_factor > 1, sigma)
    total, ok, mc, ic, clip_frac = pmesh._kp_step(
        frames_p, feats0, mesh, seed=seed, scale_hw=scale_hw,
        det_mask=det_mask, stacking=params.stacking,
        sigma_kappa=params.sigma_kappa, sigma_iters=params.sigma_iters,
        border_mode=params.border_mode, border_value=params.border_value,
        lane_valid=lane_valid, output_scale=sr_factor, identity=identity,
        **_entry.kp_match_args(params),
    )
    out, ok = _entry.mesh_result(total, ok, n, f0, final, device_output)
    kept = int(ok.sum())
    dropped = n - kept
    if return_stats:
        stats = PipelineStats(
            frames_total=n, frames_kept=kept, frames_dropped=dropped,
            match_counts=mc[1:n].tolist(), inlier_counts=ic[1:n].tolist(),
            clipped_sample_frac=clip_frac,
        )
        return dropped, out, stats
    return dropped, out


def keypoint_match_arrays(
    frames,
    params: KeyPointMatchParameters = KeyPointMatchParameters(),
    scale_down_width: Optional[float] = None,
    seed: int = 0,
    return_stats: bool = False,
    mask: Optional[np.ndarray] = None,
    mesh=None,
    device_output: bool = False,
    device="cuda",
):
    """Array-based ``keypoint_match``: ``frames`` is ``[N,H,W,3]`` uint8
    (or uint16) RGB, numpy or a tensor.  A numpy burst is copied to
    ``device`` once ("cuda" by default; asking for CUDA without a card
    raises — pass ``device="cpu"`` for the plain CPU path); a tensor
    runs on its own device.  RANSAC draws from a ``torch.Generator``
    seeded with ``seed``.

    Returns ``(dropped_count, stacked)`` like the reference returns
    ``(i32, Mat)`` (src/lib.rs:129-144): the ``[H,W,3]`` float32 RGB
    stack in [0,1] on frame 0's grid, as numpy, or as a tensor on the
    device with ``device_output=True``; ``return_stats`` adds a
    ``PipelineStats`` (match and inlier counts per frame, stage times in
    ``phase_ms``, each ending in a device synchronise, the spans inside
    detection and RANSAC in ``spans`` and RANSAC's slab count in
    ``ransac_slabs``).  Without stats the host waits for the card
    inside RANSAC's loop (once a slab) and once for the kept flags.

    ``mask`` ([H,W], nonzero = valid) is cv2 ``detectAndCompute``'s
    detection mask, applied to every frame (shrunk to the detection
    grid on the scaled path).  ``params.border_mode`` takes every
    OpenCV mode the JAX package takes; ``params.stacking =
    "sigma_clip"`` (BORDER_CONSTANT or BORDER_TRANSPARENT only) stacks
    by per-pixel kappa-sigma clipping over the covered samples;
    ``params.output_scale = f`` (2-4, the same border modes) returns the
    ``[f*H, f*W, 3]`` super-resolution stack.  Both images are final.

    ``mesh`` as in ``ecc_match_arrays``: each shard detects, matches
    against frame 0's features and runs RANSAC from a generator seeded by
    ``(seed, global shard index)``, so the draws differ from the dense
    path's (the same drops, the stack within its statistical bars)."""
    params.validate()
    _check_border(params)
    frames, dev = _entry.check_frames(frames, device, mesh)
    n, h, w = frames.shape[:3]
    # the keypoint path has no minimum-width guard (src/lib.rs:377)
    scale_hw = _entry.solve_grid(h, w, scale_down_width, min_width=False)

    if n == 1:
        # the single-frame stack is frame 0 itself (src/lib.rs:306-343)
        out = _entry.single_frame_out(frames[0], params, dev, device_output)
        if return_stats:
            return 0, out, PipelineStats(frames_total=1, frames_kept=1,
                                         frames_dropped=0)
        return 0, out

    mesh = _entry.resolve_mesh(mesh, dev)
    if mesh is not None:
        return _keypoint_match_arrays_sharded(
            frames, params, scale_hw, seed, return_stats, mask, mesh,
            device_output,
        )
    frames_t = _entry.to_device(frames, dev)
    # the detection mask on the detection grid (libstacker_tpu/models/
    # keypoint.py _prepare_det_mask :341-357)
    det_mask = None if mask is None else _entry.grid_mask(mask, (h, w),
                                                          scale_hw, dev)
    timer = PhaseTimer(dev) if return_stats else None
    with phase_of(timer, "grey"):
        grey = color.burst_grey_u8(frames_t, scale_hw)
    with phase_of(timer, "detect"):
        feats = orb.orb_detect_and_compute(grey, mask=det_mask, timer=timer)
    del grey
    with phase_of(timer, "match+ransac"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        hs, oks, mcounts, icounts = _match_and_estimate(
            feats, gen, timer=timer, **_entry.kp_match_args(params),
        )
    sigma = params.stacking == "sigma_clip"
    sr_factor = params.output_scale
    final = sigma or sr_factor > 1  # per-pixel divisors: no divide below
    clip_frac = None
    with phase_of(timer, "stack"):
        hs_full = hs
        if final and scale_hw is not None:
            hs_full = warp.rescale_maps(hs, scale_hw, (h, w))
        if sr_factor > 1:
            stacked = stack_ops.super_res_stack(
                frames_t, hs_full, oks, factor=sr_factor, perspective=True,
            )
        elif sigma:
            stacked, clip_frac = stack_ops.kappa_sigma_stack(
                frames_t, hs_full, oks, perspective=True,
                kappa=params.sigma_kappa, iters=params.sigma_iters,
            )
        else:
            stacked = warp_sum_burst(
                frames_t, hs, oks, border_value=list(params.border_value[:3]),
                border_mode=params.border_mode, scale_hw=scale_hw,
            )
    ok = oks.cpu().numpy()
    kept = 1 + int(ok.sum())
    dropped = int((~ok).sum())
    # the sigma-clip and super-resolution images are final (per-pixel
    # divisors)
    out = _entry.fetch(stacked, device_output)
    if not final:
        out = out / kept
    if return_stats:
        stats = PipelineStats(
            frames_total=n,
            frames_kept=kept,
            frames_dropped=dropped,
            match_counts=mcounts.cpu().tolist(),
            inlier_counts=icounts.cpu().tolist(),
            clipped_sample_frac=clip_frac,
            phase_ms=timer.ms(),
            spans=timer.spans(),
            ransac_slabs=timer.counts.get("ransac_slabs"),
        )
        return dropped, out, stats
    return dropped, out


def keypoint_match(
    files: Sequence,
    params: KeyPointMatchParameters = KeyPointMatchParameters(),
    scale_down_width: Optional[float] = None,
    seed: int = 0,
    return_stats: bool = False,
    mask: Optional[np.ndarray] = None,
    preserve_depth: bool = False,
    mesh=None,
    device="cuda",
):
    """Align and stack image files by ORB keypoint matching
    (ref src/lib.rs:129-144): decode on the host (``utils.io.load_frames``:
    the native loader, else PIL), then :func:`keypoint_match_arrays` on
    ``device``.  ``preserve_depth`` decodes 16-bit files to uint16 and
    stacks at full depth (detection runs on the high byte)."""
    frames = io.load_frames(files, preserve_depth=preserve_depth)
    return keypoint_match_arrays(
        frames, params, scale_down_width, seed, return_stats, mask=mask,
        mesh=mesh, device=device,
    )


def _kp_stream_chunks(chunks, mesh, feats0, params, seed, scale_hw,
                      det_mask, chunk0):
    """The align pass of ``keypoint_match_stream``: per chunk -> ``(sum
    of its kept frames, or for sigma-clip its full-resolution
    homographies; ok; match counts; inlier counts; is_last)``; chunk
    ``chunk0`` is the first.  Each chunk is padded to a multiple of the
    mesh's ``'data'`` axis (no pad on one device), sharded and matched
    per shard and the sums reduced; the pad lanes are left out and
    sliced off."""
    solve = dict(seed=seed, scale_hw=scale_hw, det_mask=det_mask,
                 **_entry.kp_match_args(params))
    staged = pmesh.ShardUploader(mesh).staged(chunks)
    for c, (sf, n_real, last) in enumerate(staged, chunk0):
        real = np.arange(sf.n_global) < n_real
        if params.stacking == "sigma_clip":
            part, ok, mc, ic = pmesh.keypoint_solve_step(
                sf, feats0, mesh, lane_valid=real, chunk=c, **solve)
            part = part[:n_real]
        else:
            part, ok, mc, ic, _ = pmesh._kp_step(
                sf, feats0, mesh, border_mode=params.border_mode,
                border_value=params.border_value, lane_valid=real, chunk=c,
                **solve)
        yield part, ok[:n_real], mc[:n_real], ic[:n_real], last


def keypoint_match_stream(
    files: Sequence,
    params: KeyPointMatchParameters = KeyPointMatchParameters(),
    scale_down_width: Optional[float] = None,
    seed: int = 0,
    chunk_size: int = 16,
    mask: Optional[np.ndarray] = None,
    preserve_depth: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 4,
    return_stats: bool = False,
    mesh=None,
    device="cuda",
):
    """Streaming ``keypoint_match`` for bursts larger than device memory:
    frames are decoded (one chunk ahead on a host thread), ORB-matched
    against frame 0 and summed in chunks of ``chunk_size`` of real frames
    (no pad lanes on one device); only frame 0's features and the running
    sum stay resident, and on CUDA each chunk's copy runs on a side stream
    while the previous chunk's kernels do (``utils.device.ChunkUploader``).
    Returns ``(dropped_count, stacked [H,W,3] float32 numpy)`` like
    :func:`keypoint_match`; the divisor is ``1 + kept``.

    RANSAC draws from a generator seeded per chunk from ``(seed, chunk
    index)`` (and the global shard index on a mesh of several data
    shards), so the draws differ from the whole-burst path's (as the JAX
    package's do) and a run resumed from ``checkpoint_path`` (see
    :func:`libstacker_tpu_torch.models.ecc.ecc_match_stream`) equals an
    uninterrupted one bitwise.  ``params.stacking = "sigma_clip"``
    (BORDER_CONSTANT or BORDER_TRANSPARENT only) keeps the homographies,
    then sums the moments over ``1 + sigma_iters`` more decode passes.
    ``output_scale != 1`` raises.

    Over a ``mesh`` ``chunk_size`` rounds up to a multiple of its
    ``'data'`` axis; each chunk is padded, sharded and matched per shard,
    and its sums (or sigma-clip moments) are reduced per chunk.  Without
    one the stream runs the same code on a one-device mesh."""
    files = _entry.stream_guards(params, files)
    sigma = params.stacking == "sigma_clip"
    if sigma:
        border = constants.border_mode_name(params.border_mode)
        if border not in ("constant", "transparent"):
            raise InvalidParamsError(
                "stacking='sigma_clip' requires BORDER_CONSTANT or "
                "BORDER_TRANSPARENT (sample inclusion is defined by "
                f"warp coverage), got border mode {border!r}"
            )
    mesh, chunk_size = _entry.stream_mesh(mesh, device, chunk_size)
    dev = mesh.devices[0, 0]

    ref = io.load_frames(files[:1], preserve_depth=preserve_depth)
    h, w = ref.shape[1:3]
    scale_hw = _entry.solve_grid(h, w, scale_down_width, min_width=False)
    if len(files) == 1:
        scale = 65535.0 if ref.dtype == np.uint16 else 255.0
        out = ref[0].astype(np.float32) / scale
        if return_stats:
            return 0, out, PipelineStats(frames_total=1, frames_kept=1,
                                         frames_dropped=0)
        return 0, out

    with pmesh._on(dev):
        ref_t = torch.from_numpy(ref).to(dev)
        det_mask = None if mask is None else _entry.grid_mask(
            mask, (h, w), scale_hw, dev)
        feats0 = orb.orb_detect_and_compute(
            color.burst_grey_u8(ref_t, scale_hw), mask=det_mask)
        acc = color.to_unit_f32(ref_t[0])
    all_ok, all_mc, all_ic, all_hs = [], [], [], []
    ckpt = None
    chunks_done = 0
    sigma_resume = None
    if checkpoint_path is not None:
        ckpt = ckpt_mod.StreamCheckpoint(
            checkpoint_path,
            ckpt_mod.burst_key(files, params, scale_down_width, chunk_size,
                               extra=f"kp|{seed}", mask=_entry.mask_key(mask)),
        )
        chunks_done, state = ckpt.load()
        if state is not None and int(state.get("phase", 0)) == 1:
            # inside the sigma-clip sweeps: the align pass is done
            sigma_resume = _entry.sigma_resume(state, chunks_done)
            all_hs.append(state["al_warps"].astype(np.float32))
            all_ok.append(state["al_ok"].astype(bool))
            all_mc.append(state["al_mc"])
            all_ic.append(state["al_ic"])
            chunks_done = 0
        elif state is not None and chunks_done > 0:
            if "acc" in state:
                acc = torch.from_numpy(state["acc"]).to(dev)
            all_ok.append(state["ok"].astype(bool))
            all_mc.append(state["mc"])
            all_ic.append(state["ic"])
            if sigma:
                all_hs.append(state["hs"].astype(np.float32))

    def save_align():
        st = dict(ok=np.concatenate(all_ok), mc=np.concatenate(all_mc),
                  ic=np.concatenate(all_ic))
        if sigma:
            st["hs"] = np.concatenate(all_hs)
        else:
            st["acc"] = acc.cpu().numpy()
        ckpt.save(chunks_done, **st)

    chunks = () if sigma_resume is not None else io.prefetched_chunks(
        files, chunk_size, h, w, start=1 + chunks_done * chunk_size,
        preserve_depth=preserve_depth,
    )
    for part, oks_c, mc_c, ic_c, last in _kp_stream_chunks(
            chunks, mesh, feats0, params, seed, scale_hw, det_mask,
            chunks_done):
        if sigma:
            all_hs.append(part)
        else:
            acc = acc + part
        all_ok.append(oks_c)
        all_mc.append(mc_c)
        all_ic.append(ic_c)
        chunks_done += 1
        if ckpt is not None and (
            chunks_done % max(checkpoint_every, 1) == 0 or last
        ):
            save_align()

    ok = np.concatenate(all_ok)
    mc, ic = np.concatenate(all_mc), np.concatenate(all_ic)
    if ckpt is not None and not sigma:
        ckpt.remove()
    kept = 1 + int(ok.sum())
    dropped = int((~ok).sum())
    clip_frac = None
    if sigma:
        mats = np.concatenate(all_hs)
        stacked, clip_frac = _entry.stream_sigma_stack(
            files, mats, ok, perspective=True, kappa=params.sigma_kappa,
            iters=params.sigma_iters, chunk_size=chunk_size, hw=(h, w),
            mesh=mesh, preserve_depth=preserve_depth, ckpt=ckpt,
            checkpoint_every=checkpoint_every,
            align_save=(None if ckpt is None
                        else dict(warps=mats, ok=ok, mc=mc, ic=ic)),
            resume=sigma_resume,
        )
        out = stacked.cpu().numpy()
        if ckpt is not None:
            ckpt.remove()
    else:
        out = acc.cpu().numpy() / kept
    if return_stats:
        stats = PipelineStats(
            frames_total=len(files), frames_kept=kept, frames_dropped=dropped,
            match_counts=mc.tolist(), inlier_counts=ic.tolist(),
            clipped_sample_frac=clip_frac,
        )
        return dropped, out, stats
    return dropped, out
