"""Super-resolution deposit: the CUDA kernel B6 and its plain version.

Counterpart of ``libstacker_tpu/ops/sr_pallas.py`` (``_sr_kernel`` :47,
``sr_deposit_pallas`` :192) with the semantics of the XLA formulation
``libstacker_tpu/ops/stack.py _sr_chunk`` (:344-415): every pixel of the
``factor``-times-finer output grid takes, from every valid frame, the
frame's NEAREST sample at the pixel's unquantised source coordinate,
weighted by ``exp(-d^2 / (2 sigma^2))`` of the sub-pixel distance ``d``
to that sample, summed over the burst into ``acc_v`` and ``acc_w``.
With ``with_fallback`` (the stack's ``sigma < 0.15``) it also sums the
border-clamped bilinear sample and the coverage count, for fine pixels
no sample lands near.

Not ported, because it exists for the TPU's windowed DMA, residual band
and lane padding: the phase decomposition (one sweep per output phase
with matrix ``minv @ T(c_p)``, ``sr_pallas.py:9-16``,
``stack.py:541-568``), ``_sr_interleave_phases`` (``stack.py:493-515``)
and ``_sr_pick_config``.  A CUDA thread writes its own fine pixel.

:func:`sr_image` runs the same sweep and ends it with the stack's
normalisation (``av / max(aw, 1e-6)``, with the bilinear fallback where
no sample landed), so the card's super-resolution stack is one launch
that writes only the image (``libstacker_tpu/ops/stack.py:474``
normalises right after its sweep too).

CUDA tensors launch ``csrc/sr_deposit.cu`` (one launch over all frames)
or raise; CPU tensors take :func:`sr_deposit_reference` /
:func:`sr_image_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import cuda_build
from . import color

#: launches of B6 (``sr_deposit``) since the last reset
launch_count = 0
#: launches of B6's image form (``sr_image``) since the last reset
image_launch_count = 0

_DTYPE_CODE = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_SCALE = {torch.uint8: color.U8_SCALE, torch.uint16: color.U16_SCALE,
          torch.float32: 1.0}
# csrc/sr_deposit.cu: threads a block, fine pixels a thread along X
_THREADS, _PX = 256, 4
# the float32 2 sigma^2 the kernel takes: normal and below 2^126
_C_MIN, _C_MAX = np.finfo(np.float32).tiny, np.float32(2.0 ** 126)


def launch_plan(h: int, w: int, factor: int):
    """``(blocks, vector, wide)`` of a B6 launch on ``[H,W,3]`` frames:
    one thread per ``_PX`` consecutive fine pixels of a row, ``_THREADS``
    a block; 16-byte stores where every row starts 16-byte aligned
    (``fW % 4 == 0``); 64-bit tap offsets only where a frame's
    ``H * W * 3`` values do not fit 31 bits."""
    hf, wf = h * factor, w * factor
    quads = hf * -(-wf // _PX)
    blocks = -(-quads // _THREADS)
    return blocks, wf % _PX == 0, h * w * 3 >= 2 ** 31


def _scalar(x: float, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``.  Dividing by it is a true
    division on every device: PyTorch's CUDA division by a Python scalar
    multiplies by the reciprocal instead, an ulp away from the kernel's
    (and the CPU's) quotient, enough to flip a nearest tap."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _fine_coords(h: int, w: int, factor: int, device):
    """Fine-pixel centres on frame 0's grid: ``(Y + 0.5) / f - 0.5``
    ([fH,1]) and ``(X + 0.5) / f - 0.5`` ([1,fW])."""
    f = _scalar(factor, device)
    gy = (torch.arange(h * factor, dtype=torch.float32, device=device)[:, None]
          + 0.5) / f - 0.5
    gx = (torch.arange(w * factor, dtype=torch.float32, device=device)[None, :]
          + 0.5) / f - 0.5
    return gy, gx


def sr_deposit_reference(
    frames: torch.Tensor,
    minv: torch.Tensor,
    valid: torch.Tensor,
    factor: int,
    kernel_sigma: float,
    perspective: bool = True,
    with_fallback: bool = False,
):
    """Plain PyTorch version of :func:`sr_deposit`, term for term as
    ``_sr_chunk``, summing the frames in order."""
    n, h, w, _ = frames.shape
    dev = frames.device
    gy, gx = _fine_coords(h, w, factor, dev)
    two_sigma_sq = _scalar(2.0 * kernel_sigma ** 2, dev)
    ok_all = valid.to(device=dev, dtype=torch.bool)
    acc = None
    for i in range(n):
        frame = color.to_unit_f32(frames[i])
        m = minv[i].to(torch.float32)
        ok = ok_all[i]
        if perspective:
            den = m[2, 0] * gx + m[2, 1] * gy + m[2, 2]
            inv = 1.0 / torch.where(den.abs() > 1e-12, den,
                                    torch.full_like(den, 1e-12))
        else:
            inv = 1.0
        sx = (m[0, 0] * gx + m[0, 1] * gy + m[0, 2]) * inv
        sy = (m[1, 0] * gx + m[1, 1] * gy + m[1, 2]) * inv
        qy = torch.round(sy)
        qx = torch.round(sx)
        d2 = (sy - qy) ** 2 + (sx - qx) ** 2
        inside = (qy >= 0) & (qy <= h - 1) & (qx >= 0) & (qx <= w - 1)
        if perspective:
            inside &= den > 1e-6
        wgt = torch.where(inside & ok, torch.exp(-d2 / two_sigma_sq),
                          torch.zeros_like(d2))
        qyi = torch.clamp(qy, 0, h - 1).to(torch.int64)
        qxi = torch.clamp(qx, 0, w - 1).to(torch.int64)
        parts = [wgt[..., None] * frame[qyi, qxi], wgt]
        if with_fallback:
            y0 = torch.clamp(torch.floor(sy), 0, h - 2)
            x0 = torch.clamp(torch.floor(sx), 0, w - 2)
            fy = torch.clamp(sy - y0, 0.0, 1.0)[..., None]
            fx = torch.clamp(sx - x0, 0.0, 1.0)[..., None]
            y0i = y0.to(torch.int64)
            x0i = x0.to(torch.int64)
            bl = (
                frame[y0i, x0i] * (1 - fy) * (1 - fx)
                + frame[y0i, x0i + 1] * (1 - fy) * fx
                + frame[y0i + 1, x0i] * fy * (1 - fx)
                + frame[y0i + 1, x0i + 1] * fy * fx
            )
            cov = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1) & ok
            if perspective:
                cov &= den > 1e-6
            covf = cov.to(torch.float32)
            parts += [bl * covf[..., None], covf]
        acc = parts if acc is None else [a + p for a, p in zip(acc, parts)]
    if acc is None:
        hf, wf = h * factor, w * factor
        z3 = torch.zeros((hf, wf, 3), dtype=torch.float32, device=dev)
        z1 = torch.zeros((hf, wf), dtype=torch.float32, device=dev)
        acc = [z3, z1] + ([z3.clone(), z1.clone()] if with_fallback else [])
    return tuple(acc)


def normalise(acc) -> torch.Tensor:
    """The super-resolution image of a deposit ``(acc_v, acc_w[, bl,
    cnt])``: the weighted mean per fine pixel and, with the fallback
    sums, their bilinear mean where no sample landed (the tail of
    ``libstacker_tpu/ops/stack.py super_res_stack``, :474, :481-490).  Every
    divisor is a tensor, so CUDA divides exactly as the CPU does."""
    av, aw = acc[0], acc[1]
    out = av / torch.clamp(aw, min=1e-6)[..., None]
    if len(acc) == 4:
        bl, cnt = acc[2], acc[3]
        fallback = bl / torch.clamp(cnt, min=1.0)[..., None]
        out = torch.where((aw > 1e-6)[..., None], out, fallback)
    return out


def sr_image_reference(
    frames: torch.Tensor,
    minv: torch.Tensor,
    valid: torch.Tensor,
    factor: int,
    kernel_sigma: float,
    perspective: bool = True,
    with_fallback: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sr_image`: the deposit over all
    frames in one sum, then :func:`normalise`."""
    return normalise(sr_deposit_reference(frames, minv, valid, factor,
                                          kernel_sigma, perspective,
                                          with_fallback))


def _checked(frames, minv, valid, factor, kernel_sigma):
    """Raise on arguments neither form takes; -> the burst's (n, h, w)."""
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be [N,H,W,3], got {tuple(frames.shape)}")
    if frames.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported frame dtype {frames.dtype}")
    n, h, w, _ = frames.shape
    if tuple(minv.shape) != (n, 3, 3) or tuple(valid.shape) != (n,):
        raise ValueError(
            f"minv must be [{n},3,3] and valid [{n}], got "
            f"{tuple(minv.shape)} and {tuple(valid.shape)}"
        )
    if not 1 <= factor <= 4:
        raise ValueError(f"factor must be in 1..4, got {factor}")
    if not kernel_sigma > 0.0:
        raise ValueError(f"kernel_sigma must be > 0, got {kernel_sigma}")
    # the kernel divides by float32(2 sigma^2) as a normal number below
    # 2^126 (csrc/sr_deposit.cu make_div): sigma in ~[7.7e-20, 6.5e18]
    if not _C_MIN <= np.float32(2.0 * kernel_sigma ** 2) < _C_MAX:
        raise ValueError(f"kernel_sigma out of range, got {kernel_sigma}")
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {frames.device}")
    if frames.device.type == "cuda":
        if not frames.is_contiguous():
            raise ValueError("frames must be contiguous")
        if minv.dtype != torch.float32 or minv.device != frames.device:
            raise ValueError(f"minv must be float32 on {frames.device}")
    return n, h, w


def _launch(entry, frames, minv, valid, outs, factor, kernel_sigma,
            perspective, with_fallback):
    """One launch of ``csrc/sr_deposit.cu``'s ``entry`` over the burst,
    writing ``outs`` (pointers, None where unused)."""
    n, h, w, _ = frames.shape
    dev = frames.device
    minv = minv.contiguous()
    vb = valid.to(device=dev, dtype=torch.uint8).contiguous()
    blocks, vector, wide = launch_plan(h, w, factor)
    lib = _lib()
    cuda_build.launch(
        lib, entry, dev,
        frames.data_ptr(), minv.data_ptr(), vb.data_ptr(), *outs, n, h, w,
        factor, 2.0 * kernel_sigma ** 2, _DTYPE_CODE[frames.dtype],
        int(perspective), int(with_fallback), _SCALE[frames.dtype], blocks,
        int(vector), int(wide),
    )


def sr_deposit(
    frames: torch.Tensor,
    minv: torch.Tensor,
    valid: torch.Tensor,
    factor: int,
    kernel_sigma: float,
    perspective: bool = True,
    with_fallback: bool = False,
):
    """Super-resolution deposit of a burst -> ``(acc_v [fH,fW,3], acc_w
    [fH,fW])`` float32, plus ``(bl [fH,fW,3], cnt [fH,fW])`` with
    ``with_fallback``.

    ``frames`` [N,H,W,3] uint8 / uint16 / float32, ``minv`` [N,3,3]
    inverse maps (frame-0 grid -> frame n), ``valid`` [N] bool.  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/sr_deposit.cu`` or raise."""
    _, h, w = _checked(frames, minv, valid, factor, kernel_sigma)
    if frames.device.type == "cpu":
        return sr_deposit_reference(frames, minv, valid, factor,
                                    kernel_sigma, perspective, with_fallback)
    dev = frames.device
    hf, wf = h * factor, w * factor
    acc = [torch.empty((hf, wf, 3), dtype=torch.float32, device=dev),
           torch.empty((hf, wf), dtype=torch.float32, device=dev)]
    if with_fallback:
        acc += [torch.empty((hf, wf, 3), dtype=torch.float32, device=dev),
                torch.empty((hf, wf), dtype=torch.float32, device=dev)]
    ptrs = [a.data_ptr() for a in acc] + [None] * (4 - len(acc))
    _launch("sr_deposit", frames, minv, valid, ptrs, factor, kernel_sigma,
            perspective, with_fallback)
    cuda_build.count(globals(), "launch_count")
    return tuple(acc)


def sr_image(
    frames: torch.Tensor,
    minv: torch.Tensor,
    valid: torch.Tensor,
    factor: int,
    kernel_sigma: float,
    perspective: bool = True,
    with_fallback: bool = False,
) -> torch.Tensor:
    """Super-resolution image of a burst -> ``[fH,fW,3]`` float32: the
    deposit of :func:`sr_deposit` normalised as :func:`normalise` does,
    the sums kept in the kernel's registers (no ``acc_w``, ``bl`` or
    ``cnt`` array is written).  Arguments as :func:`sr_deposit`; CPU
    tensors take :func:`sr_image_reference`, CUDA tensors launch
    ``csrc/sr_deposit.cu`` once or raise."""
    _, h, w = _checked(frames, minv, valid, factor, kernel_sigma)
    if frames.device.type == "cpu":
        return sr_image_reference(frames, minv, valid, factor, kernel_sigma,
                                  perspective, with_fallback)
    out = torch.empty((h * factor, w * factor, 3), dtype=torch.float32,
                      device=frames.device)
    _launch("sr_image", frames, minv, valid, [out.data_ptr()], factor,
            kernel_sigma, perspective, with_fallback)
    cuda_build.count(globals(), "image_launch_count")
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("sr_deposit")
    vp, ci, cf, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    plan = [cu, ci, ci, vp]  # blocks, vector, wide, stream
    lib.sr_deposit.argtypes = ([vp] * 7 + [ci] * 4 + [cf] + [ci] * 3 + [cf]
                               + plan)
    lib.sr_image.argtypes = [vp] * 4 + [ci] * 4 + [cf] + [ci] * 3 + [cf] + plan
    lib.sr_deposit.restype = lib.sr_image.restype = ci
    return lib
