"""The entry plumbing that ``models/ecc.py`` and ``models/keypoint.py``
share: the checks of a burst, the solve grid and the user's mask on it,
the ``mesh=`` argument, the padding of a burst to a mesh and how frame 0
enters its stack, the single-frame output, the streams' guards, mesh and
sigma-clip sweeps with their checkpoint state, and each method's
parameters-to-solve keywords (used alike by its dense path, its sharded
path and its stream).  Counterparts in ``libstacker_tpu/models/ecc.py``
(``_ecc_mask_jit`` :93-103, ``_resolve_mesh`` :381-406, ``_pad_burst``
:409-422, ``_stream_sigma_stack`` :170) and ``models/keypoint.py``
(``_single_frame_out`` :360-375)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import constants
from ..errors import InvalidParamsError, NotEnoughFilesError
from ..ops import color, resize
from ..ops import stack as stack_ops
from ..parallel import mesh as pmesh
from ..utils import io
from ..utils.device import resolve_device


def check_frames(frames, device, mesh):
    """A ``[N,H,W,3]`` uint8 / uint16 burst (numpy or a tensor), N >= 1
    -> ``(frames, device)``: a tensor's own device, or for numpy
    ``device`` or the first device of an explicit mesh (the shards then
    go to theirs)."""
    if isinstance(frames, torch.Tensor):
        dev = resolve_device(frames.device)
        dtype_ok = frames.dtype in (torch.uint8, torch.uint16)
    else:
        frames = np.asarray(frames)
        if isinstance(mesh, str) or "data" not in getattr(mesh, "axis_names",
                                                          ()):
            dev = resolve_device(device)
        else:
            dev = mesh.devices[0, 0]
        dtype_ok = frames.dtype in (np.uint8, np.uint16)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise InvalidParamsError(
            f"frames must be [N,H,W,3] uint8/uint16, got {tuple(frames.shape)}"
        )
    if not dtype_ok:
        raise InvalidParamsError(
            f"frames must be uint8 or uint16, got {frames.dtype}"
        )
    if frames.shape[0] == 0:
        raise NotEnoughFilesError()
    return frames, dev


def to_device(frames, dev) -> torch.Tensor:
    """A burst (or a frame) as a contiguous tensor: a tensor stays on its
    device, numpy is copied to ``dev`` once."""
    if isinstance(frames, torch.Tensor):
        return frames.contiguous()
    return torch.from_numpy(np.ascontiguousarray(frames)).to(dev)


def fetch(x: torch.Tensor, device_output: bool):
    """The result as the caller asked for it: the tensor, or numpy."""
    return x if device_output else x.cpu().numpy()


def solve_grid(h: int, w: int, scale_down_width, min_width: bool = True):
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


def grid_mask(mask, hw, scale_hw=None, device="cpu") -> torch.Tensor:
    """Validate and binarise a user mask (nonzero = valid; ECC's
    reference-frame mask, the keypoint path's detection mask) and, on the
    scaled path, shrink it conservatively to the solve grid: a scaled
    pixel stays valid only if >= half its INTER_AREA footprint was."""
    mask = mask_key(mask)
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


def mask_key(mask):
    """The user's mask as numpy, for the checkpoint's key."""
    if mask is None:
        return None
    return mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)


def resolve_mesh(mesh, device):
    """The public ``mesh=`` argument -> a ``parallel.Mesh`` or None:
    ``"auto"`` is a data mesh over every visible CUDA device, or a
    one-device CPU mesh when ``device`` is the CPU (it never becomes a
    CPU mesh when a card was asked for); a mesh with a ``'data'`` axis
    passes through."""
    if mesh is None:
        return None
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


def pad_burst(frames, ndata: int):
    """Pad the frame axis to a multiple of the ``'data'`` axis with
    copies of frame 0 -> ``(frames, lane_valid [N'] bool)``; the pad
    lanes are left out through ``lane_valid``."""
    n = frames.shape[0]
    pad = (-n) % ndata
    if pad == 0:
        return frames, np.ones(n, bool)
    if isinstance(frames, torch.Tensor):
        frames = torch.cat([frames, frames[:1].expand(pad, *frames.shape[1:])])
    else:
        frames = np.concatenate([frames, np.repeat(frames[:1], pad, axis=0)])
    return frames, np.arange(n + pad) < n


def mesh_lanes(frames, mesh, final_sr: bool, sigma: bool):
    """A burst as a mesh's lanes (frame 0 is lane 0): padded to the
    ``'data'`` axis (:func:`pad_burst`) -> ``(frames, lane_valid,
    identity)`` lane masks.  The mean leaves lane 0 out of the sum and
    adds frame 0 after the reduction, as the dense path adds it;
    sigma-clip stacks it with the exact identity; super-resolution uses
    its solved lane, as the JAX package's mesh does."""
    frames, lane_valid = pad_burst(frames, mesh.shape["data"])
    identity = np.zeros(len(lane_valid), bool)
    if sigma:
        identity[0] = True
    elif not final_sr:
        lane_valid[0] = False
    return frames, lane_valid, identity


def mesh_result(total, ok, n: int, f0, final: bool, device_output: bool):
    """A mesh step's ``(total, ok)`` on the dense path's terms -> ``(out,
    ok [n])``: the mean adds frame 0 (its lane was left out of the sum)
    and divides by the kept count; the sigma-clip and super-resolution
    images are final."""
    ok = ok[:n].copy()
    if final:
        return fetch(total, device_output), ok
    ok[0] = True
    out = fetch(color.to_unit_f32(f0[0]) + total, device_output)
    return out / int(ok.sum()), ok


def single_frame_out(frame, params, device, device_output=False):
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
    return fetch(out, device_output)


def ecc_solve_args(params, input_mask=None) -> dict:
    """ECC's parameters as the keywords of its align stage
    (``ops/ecc.align_lanes``, and ``parallel.mesh``'s sharded steps)."""
    num_iters, eps = params.resolve_criteria()
    return dict(
        motion_type=params.motion_type, num_iters=num_iters, eps=eps,
        gauss_filt_size=params.gauss_filt_size, phase_init=params.phase_init,
        phase_init_rotation=params.phase_init_rotation,
        coarse_levels=params.coarse_levels, input_mask=input_mask,
        mode=params.solver)


def kp_match_args(params) -> dict:
    """The keypoint path's parameters as the keywords of its align stage
    (``ops/ransac.match_and_estimate``, and ``parallel.mesh``'s sharded
    steps)."""
    return dict(
        method=params.method,
        ransac_reproj_threshold=params.ransac_reproj_threshold,
        match_keep_ratio=params.match_keep_ratio,
        match_ratio=params.match_ratio, max_iters=params.max_iters,
        confidence=params.confidence)


def stream_guards(params, files):
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


def stream_mesh(mesh, device, chunk_size: int):
    """A stream's mesh and chunk size: the ``mesh`` argument, or without
    one a one-device mesh on ``device``; the stream runs on its devices
    (``devices[0, 0]`` holds the running sum) and ``chunk_size`` rounds
    up to a multiple of the ``'data'`` axis, which the checkpoint's key
    then holds (``libstacker_tpu/models/ecc.py`` :808-811)."""
    mesh = resolve_mesh(mesh, device)
    if mesh is None:
        mesh = pmesh.make_mesh([resolve_device(device)])
    ndata = mesh.shape["data"]
    return mesh, -(-chunk_size // ndata) * ndata


def sigma_resume(state: dict, cursor: int) -> dict:
    """The sweep state a phase=1 checkpoint holds."""
    return dict(
        pass_idx=int(state["pass_idx"]),
        cursor=int(cursor),
        part=(state["part0"], state["part1"], state["part2"]),
        base=((state["base0"], state["base1"], state["base2"])
              if int(state["has_base"]) else None),
        total_s0=float(state["total_s0"]),
    )


def stream_sigma_stack(
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
    ``al_*``).  ``resume`` is :func:`sigma_resume` of such a record.

    Returns ``(image [H,W,3] float32 tensor, clipped_sample_frac)``."""
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
