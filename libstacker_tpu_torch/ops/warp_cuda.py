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
- :func:`warp3_bilinear` (B9): three shared planes warped per lane with
  one coordinate and weight set, BORDER_CONSTANT 0.

CUDA tensors launch ``csrc/warp.cu`` or raise; CPU tensors take
:func:`warp_bilinear_reference` / :func:`warp3_bilinear_reference`,
built on ``ops/warp.py``.  Divergence from the TPU kernel, by design:
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
from typing import Optional, Tuple

import torch

from ..utils import cuda_build
from . import warp

#: launches of B5 (``warp_bilinear``) since the last reset
launch_count = 0
#: launches of B9 (``warp3_bilinear``) since the last reset
warp3_launch_count = 0

# OpenCV's border-mode integers, as csrc/warp.cu switches on them
_MODE_CODE = {"constant": 0, "replicate": 1, "reflect": 2, "wrap": 3,
              "reflect101": 4}


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
                                   quant_affine, border_mode=border,
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
) -> torch.Tensor:
    """Warp ``G`` slots: ``out[g] = warp(src[src_index[g]], minv[g])``
    -> ``[G, *out_hw]`` float32.

    ``src`` [S,H,W] float32, ``minv`` [G,3,3] inverse maps,
    ``border_value`` scalar or [G] (BORDER_CONSTANT), ``src_index`` [G]
    (default ``arange(G)``), ``out_hw`` the output grid (default the
    source extent), ``border_mode`` an OpenCV integer or mode name
    (BORDER_TRANSPARENT reads the zero base: CONSTANT 0).  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/warp.cu`` or
    raise."""
    global launch_count
    g, out_hw = _check_args(src, minv, src_index, out_hw)
    if src.device.type == "cpu":
        return warp_bilinear_reference(src, minv, border_value, src_index,
                                       out_hw, quant_affine, border_mode)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    dev = src.device
    border = warp._resolve_border(border_mode)
    if border == "transparent":
        border, border_value = "constant", 0.0
    minv = minv.contiguous()
    _check_cuda(dev, src=src, minv=minv)
    s_n, h, w = src.shape
    if src_index is None:
        sidx = torch.arange(g, dtype=torch.int32, device=dev)
    else:
        sidx = src_index.to(device=dev, dtype=torch.int32).contiguous()
        if bool(((sidx < 0) | (sidx >= s_n)).any()):
            raise ValueError(f"src_index outside 0..{s_n - 1}")
    bv = _per_slot(border_value, g, dev)
    out = torch.empty((g, *out_hw), dtype=torch.float32, device=dev)
    if g == 0:
        return out
    lib = _lib()
    err = lib.warp_bilinear(
        src.data_ptr(), minv.data_ptr(), bv.data_ptr(), sidx.data_ptr(),
        out.data_ptr(), g, h, w, out_hw[0], out_hw[1], _MODE_CODE[border],
        int(not quant_affine), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "warp_bilinear")
    launch_count += 1
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


def warp3_bilinear(
    srcs: torch.Tensor, minv: torch.Tensor, quant_affine: bool = False
) -> torch.Tensor:
    """Warp the three shared planes ``srcs`` [3,H,W] float32 with each
    lane's inverse map ``minv`` [B,3,3] -> ``[B,3,H,W]`` float32,
    BORDER_CONSTANT 0.  CPU tensors take the plain version; CUDA tensors
    launch ``csrc/warp.cu`` or raise."""
    global warp3_launch_count
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
    lib = _lib()
    err = lib.warp3_bilinear(
        srcs.data_ptr(), minv.data_ptr(), out.data_ptr(), b, h, w,
        int(not quant_affine), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "warp3_bilinear")
    warp3_launch_count += 1
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
    lib.warp_bilinear.argtypes = [vp] * 5 + [ci] * 7 + [vp]
    lib.warp_bilinear.restype = ci
    lib.warp3_bilinear.argtypes = [vp] * 3 + [ci] * 4 + [vp]
    lib.warp3_bilinear.restype = ci
    return lib
