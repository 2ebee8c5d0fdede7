"""Batched bilinear warps: the CUDA kernels B5 and B9 and their plain
versions.

Counterpart of ``libstacker_tpu/ops/warp_pallas.py`` (``_warp_kernel``
:217 via ``warp_bilinear_pallas`` :370; ``_warp3_kernel`` :475 via
``warp3_bilinear_pallas`` :594), inverse-map semantics
``dst(x, y) = src(M (x, y, 1))`` with OpenCV's 1/32-px quantisation:

- :func:`warp_bilinear` (B5): one output slot per matrix, each reading
  the source plane ``src_index[g]`` (slots may share a source), on an
  ``out_hw`` grid that may differ from the source extent, with a border
  value per slot and any border mode.
- :func:`warp_frames` (B5 on interleaved frames): each ``[H,W,C]``
  frame of a burst in its own type (u8 / u16 / f32, widened per tap as
  ``color.to_unit_f32`` widens it) warped onto its own grid with one
  coordinate and tap set per pixel, any border mode; with ``valid`` the
  validity-weighted sum over the burst in one launch (the keypoint
  path's stack with an index-mapping border);
- :func:`warp3_bilinear` (B9): three shared planes warped per lane with
  one coordinate and weight set, BORDER_CONSTANT 0.

CUDA tensors launch ``csrc/warp.cu`` or raise; CPU tensors take
:func:`warp_bilinear_reference` / :func:`warp_frames_reference` /
:func:`warp3_bilinear_reference`, built on ``ops/warp.py``.  Divergence from the TPU kernel, by design:
the index-mapping border modes (REPLICATE, REFLECT, REFLECT_101, WRAP)
map each tap index in the kernel (OpenCV's borderInterpolate), where
the JAX package padded the source by a host-sized apron and warped it
with BORDER_CONSTANT (``libstacker_tpu/ops/warp_batch.py:170-228``,
``:270-281``).  A thread reads any source pixel, so there is no apron,
no residual band, no host synchronisation and no fallback path.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Optional, Tuple

import torch

from ..utils import cuda_build
from . import color, warp

#: launches of B5 (``warp_bilinear``) since the last reset
launch_count = 0
#: launches of B5's frames form (``warp_frames`` without ``valid``)
frames_launch_count = 0
#: launches of B5's accumulate form (``warp_frames`` with ``valid``)
accum_launch_count = 0
#: launches of B9 (``warp3_bilinear``) since the last reset
warp3_launch_count = 0

# OpenCV's border-mode integers, as csrc/warp.cu switches on them
_MODE_CODE = {"constant": 0, "replicate": 1, "reflect": 2, "wrap": 3,
              "reflect101": 4}
_DTYPE_CODE = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_SCALE = {torch.uint8: color.U8_SCALE, torch.uint16: color.U16_SCALE,
          torch.float32: 1.0}


def _per_slot(border_value, g: int, device) -> torch.Tensor:
    bv = torch.as_tensor(border_value, dtype=torch.float32,
                         device=device).reshape(-1)
    if bv.numel() == 1:
        bv = bv.expand(g)
    if tuple(bv.shape) != (g,):
        raise ValueError(f"border_value must be a scalar or [{g}]")
    return bv.contiguous()


def _check_args(src, minv, src_index, out_hw):
    if src.ndim != 3:
        raise ValueError(f"src must be [S,H,W], got {tuple(src.shape)}")
    g = minv.shape[0]
    if tuple(minv.shape) != (g, 3, 3):
        raise ValueError(f"minv must be [G,3,3], got {tuple(minv.shape)}")
    if src_index is not None and tuple(src_index.shape) != (g,):
        raise ValueError(f"src_index must be [{g}], got "
                         f"{tuple(src_index.shape)}")
    if src_index is None and g > src.shape[0]:
        raise ValueError(f"{g} slots need src_index for {src.shape[0]} "
                         "sources")
    oh, ow = out_hw if out_hw is not None else src.shape[1:]
    return g, (int(oh), int(ow))


def warp_bilinear_reference(
    src: torch.Tensor,
    minv: torch.Tensor,
    border_value=0.0,
    src_index: Optional[torch.Tensor] = None,
    out_hw: Optional[Tuple[int, int]] = None,
    quant_affine: bool = False,
    border_mode="constant",
    rows: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_bilinear`: one
    ``ops/warp.py`` warp per slot."""
    g, out_hw = _check_args(src, minv, src_index, out_hw)
    border = warp._resolve_border(border_mode)
    bv = _per_slot(border_value, g, src.device)
    idx = range(g) if src_index is None else src_index.tolist()
    out = torch.empty((g, *out_hw), dtype=torch.float32, device=src.device)
    for i, s in enumerate(idx):
        out[i] = warp.warp_inverse(src[s].to(torch.float32), minv[i], out_hw,
                                   quant_affine, rows, border_mode=border,
                                   border_value=bv[i])
    return out


def warp_bilinear(
    src: torch.Tensor,
    minv: torch.Tensor,
    border_value=0.0,
    src_index: Optional[torch.Tensor] = None,
    out_hw: Optional[Tuple[int, int]] = None,
    quant_affine: bool = False,
    border_mode="constant",
    rows: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Warp ``G`` slots: ``out[g] = warp(src[src_index[g]], minv[g])``
    -> ``[G, *out_hw]`` float32.

    ``src`` [S,H,W] float32, ``minv`` [G,3,3] inverse maps,
    ``border_value`` scalar or [G] (BORDER_CONSTANT), ``src_index`` [G]
    (default ``arange(G)``), ``out_hw`` the output grid (default the
    source extent), ``border_mode`` an OpenCV integer or mode name
    (BORDER_TRANSPARENT reads the zero base: CONSTANT 0).  ``rows =
    (oy0, sy0)``: output row y is row ``y + oy0`` of a larger frame whose
    rows from ``sy0`` the sources hold (a row band, ``csrc/warp.cu``).
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/warp.cu`` or raise.  A border that is a Python number goes
    by value and ``src_index=None`` as a null pointer (the row warp's
    call builds no tensor); other borders and ``src_index`` go to the
    card, ``src_index`` range-checked there."""
    g, out_hw = _check_args(src, minv, src_index, out_hw)
    if src.device.type == "cpu":
        return warp_bilinear_reference(src, minv, border_value, src_index,
                                       out_hw, quant_affine, border_mode,
                                       rows)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    dev = src.device
    border = warp._resolve_border(border_mode)
    if border == "transparent":
        border, border_value = "constant", 0.0
    minv = minv.contiguous()
    _check_cuda(dev, src=src, minv=minv)
    s_n, h, w = src.shape
    if isinstance(border_value, numbers.Real):
        bv, value = None, float(border_value)
    else:
        bv, value = _per_slot(border_value, g, dev), 0.0
    sidx = None
    if src_index is not None:
        sidx = src_index.to(device=dev, dtype=torch.int32).contiguous()
        if bool(((sidx < 0) | (sidx >= s_n)).any()):
            raise ValueError(f"src_index outside 0..{s_n - 1}")
    out = torch.empty((g, *out_hw), dtype=torch.float32, device=dev)
    if g == 0:
        return out
    lib = _lib()
    cuda_build.launch(
        lib, "warp_bilinear", dev,
        src.data_ptr(), minv.data_ptr(), None if bv is None else bv.data_ptr(),
        value, None if sidx is None else sidx.data_ptr(), out.data_ptr(), g,
        h, w, out_hw[0], out_hw[1], _MODE_CODE[border], int(not quant_affine),
        int(rows[0]), int(rows[1]),
    )
    cuda_build.count(globals(), "launch_count")
    return out


def _check_frames(frames, minv, valid) -> None:
    if frames.ndim != 4 or not 1 <= frames.shape[-1] <= 4:
        raise ValueError(
            f"frames must be [N,H,W,C] with C in 1..4, got "
            f"{tuple(frames.shape)}")
    if frames.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported frame dtype {frames.dtype}")
    n = frames.shape[0]
    if tuple(minv.shape) != (n, 3, 3):
        raise ValueError(f"minv must be [{n},3,3], got {tuple(minv.shape)}")
    if valid is not None and tuple(valid.shape) != (n,):
        raise ValueError(f"valid must be [{n}], got {tuple(valid.shape)}")


def warp_frames_reference(
    frames: torch.Tensor,
    minv: torch.Tensor,
    border_value=0.0,
    border_mode="constant",
    quant_affine: bool = False,
    valid: Optional[torch.Tensor] = None,
    rows: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_frames`: per frame,
    ``color.to_unit_f32`` and :func:`warp_bilinear_reference` on its
    planes; with ``valid``, ``warped * valid[n]`` added to a running sum
    frame by frame, a frame with ``valid[n] == 0`` skipped."""
    _check_frames(frames, minv, valid)
    n, h, w, c = frames.shape
    bv = _per_slot(border_value, c, frames.device)
    if valid is None:
        out = torch.empty((n, h, w, c), dtype=torch.float32,
                          device=frames.device)
    else:
        vf = valid.to(device=frames.device, dtype=torch.float32)
        keep = vf.tolist()
        out = torch.zeros((h, w, c), dtype=torch.float32, device=frames.device)
    for i in range(n):
        if valid is not None and keep[i] == 0.0:
            continue
        planes = color.to_unit_f32(frames[i]).permute(2, 0, 1)
        wp = warp_bilinear_reference(
            planes, minv[i].expand(c, 3, 3), bv, quant_affine=quant_affine,
            border_mode=border_mode, rows=rows).permute(1, 2, 0)
        if valid is None:
            out[i] = wp
        else:
            out = out + wp * vf[i]
    return out


def warp_frames(
    frames: torch.Tensor,
    minv: torch.Tensor,
    border_value=0.0,
    border_mode="constant",
    quant_affine: bool = False,
    valid: Optional[torch.Tensor] = None,
    rows: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Warp each frame of ``frames`` [N,H,W,C] (u8, u16 or float32, C in
    1..4) by its inverse map ``minv`` [N,3,3] onto its own grid, integer
    taps widened to [0,1] as ``color.to_unit_f32`` widens them ->
    ``[N,H,W,C]`` float32; with ``valid`` [N] (bool or float) ->
    ``sum_n valid[n] * warp(frames[n])``, ``[H,W,C]`` float32, summed in
    frame order (a frame with ``valid[n] == 0`` adds nothing).
    ``border_value`` is a scalar or one value per channel
    (BORDER_CONSTANT), ``border_mode`` an OpenCV integer or mode name
    (BORDER_TRANSPARENT reads the zero base), ``rows`` the row origins
    of a band as in :func:`warp_bilinear`.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/warp.cu`` or raise."""
    _check_frames(frames, minv, valid)
    if frames.device.type == "cpu":
        return warp_frames_reference(frames, minv, border_value, border_mode,
                                     quant_affine, valid, rows)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    dev = frames.device
    border = warp._resolve_border(border_mode)
    if border == "transparent":
        border, border_value = "constant", 0.0
    minv = minv.contiguous()
    _check_cuda(dev, minv=minv)
    n, h, w, c = frames.shape
    # on the host: the kernel takes the values by value
    bv = (ctypes.c_float * c)(*_per_slot(border_value, c, "cpu").tolist())
    if valid is None:
        out = torch.empty((n, h, w, c), dtype=torch.float32, device=dev)
        if n == 0:
            return out
        vptr = None
    else:
        out = torch.empty((h, w, c), dtype=torch.float32, device=dev)
        vf = valid.to(device=dev, dtype=torch.float32).contiguous()
        vptr = vf.data_ptr()
    lib = _lib()
    cuda_build.launch(
        lib, "warp_frames", dev,
        frames.data_ptr(), minv.data_ptr(), bv, vptr,
        out.data_ptr(), n, h, w, c, _DTYPE_CODE[frames.dtype],
        _MODE_CODE[border], int(not quant_affine), _SCALE[frames.dtype],
        int(rows[0]), int(rows[1]),
    )
    if valid is None:
        cuda_build.count(globals(), "frames_launch_count")
    else:
        cuda_build.count(globals(), "accum_launch_count")
    return out


def warp3_bilinear_reference(
    srcs: torch.Tensor, minv: torch.Tensor, quant_affine: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp3_bilinear`: three
    ``ops/warp.py`` warps per lane."""
    b = minv.shape[0]
    _, h, w = srcs.shape
    out = torch.empty((b, 3, h, w), dtype=torch.float32, device=srcs.device)
    for i in range(b):
        for c in range(3):
            out[i, c] = warp.warp_inverse(srcs[c].to(torch.float32), minv[i],
                                          (h, w), quant_affine)
    return out


# csrc/warp.cu's B9: threads a block, pixels a thread along x
_W3_THREADS, _W3_PX = 256, 4


def warp3_plan(h: int, w: int):
    """``(tiles, vector)`` of a B9 launch on ``[3,H,W]`` planes: a tile is
    ``_W3_THREADS`` threads of ``_W3_PX`` consecutive pixels of a row (in
    row-major order of the quads), the grid ``tiles * B`` blocks with the
    lane fastest (block ``tile * B + lane``); 16-byte stores where every
    row starts 16-byte aligned (``W % 4 == 0``)."""
    quads = h * -(-w // _W3_PX)
    return -(-quads // _W3_THREADS), w % _W3_PX == 0


def warp3_bilinear(
    srcs: torch.Tensor, minv: torch.Tensor, quant_affine: bool = False
) -> torch.Tensor:
    """Warp the three shared planes ``srcs`` [3,H,W] float32 with each
    lane's inverse map ``minv`` [B,3,3] -> ``[B,3,H,W]`` float32,
    BORDER_CONSTANT 0.  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/warp.cu`` or raise."""
    if srcs.ndim != 3 or srcs.shape[0] != 3:
        raise ValueError(f"srcs must be [3,H,W], got {tuple(srcs.shape)}")
    b = minv.shape[0]
    if tuple(minv.shape) != (b, 3, 3):
        raise ValueError(f"minv must be [B,3,3], got {tuple(minv.shape)}")
    if srcs.device.type == "cpu":
        return warp3_bilinear_reference(srcs, minv, quant_affine)
    if srcs.device.type != "cuda":
        raise ValueError(f"unsupported device {srcs.device}")
    dev = srcs.device
    minv = minv.contiguous()
    _check_cuda(dev, srcs=srcs, minv=minv)
    _, h, w = srcs.shape
    out = torch.empty((b, 3, h, w), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    tiles, vector = warp3_plan(h, w)
    lib = _lib()
    cuda_build.launch(
        lib, "warp3_bilinear", dev,
        srcs.data_ptr(), minv.data_ptr(), out.data_ptr(), b, h, w,
        int(not quant_affine), tiles, int(vector),
    )
    cuda_build.count(globals(), "warp3_launch_count")
    return out


def _check_cuda(dev, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"{name} must be a contiguous float32 tensor on {dev}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("warp")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.warp_bilinear.argtypes = ([vp] * 3 + [ctypes.c_float]
                                  + [vp] * 2 + [ci] * 9 + [vp])
    lib.warp_bilinear.restype = ci
    lib.warp3_bilinear.argtypes = ([vp] * 3 + [ci] * 4
                                   + [ctypes.c_uint, ci, vp])
    lib.warp3_bilinear.restype = ci
    lib.warp_frames.argtypes = ([vp, vp, ctypes.POINTER(ctypes.c_float),
                                 vp, vp] + [ci] * 7 + [ctypes.c_float, ci, ci,
                                                       vp])
    lib.warp_frames.restype = ci
    return lib
