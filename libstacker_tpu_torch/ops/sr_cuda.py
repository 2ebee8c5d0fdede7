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

CUDA tensors launch ``csrc/sr_deposit.cu`` (one launch over all frames)
or raise; CPU tensors take :func:`sr_deposit_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import cuda_build
from . import color

#: launches of B6 (``sr_deposit``) since the last reset
launch_count = 0

_DTYPE_CODE = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_SCALE = {torch.uint8: color.U8_SCALE, torch.uint16: color.U16_SCALE,
          torch.float32: 1.0}


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
    global launch_count
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
    if frames.device.type == "cpu":
        return sr_deposit_reference(frames, minv, valid, factor,
                                    kernel_sigma, perspective, with_fallback)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    dev = frames.device
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if minv.dtype != torch.float32 or minv.device != dev:
        raise ValueError(f"minv must be float32 on {dev}")
    minv = minv.contiguous()
    vb = valid.to(device=dev, dtype=torch.uint8).contiguous()
    hf, wf = h * factor, w * factor
    av = torch.empty((hf, wf, 3), dtype=torch.float32, device=dev)
    aw = torch.empty((hf, wf), dtype=torch.float32, device=dev)
    bl = cnt = None
    if with_fallback:
        bl = torch.empty((hf, wf, 3), dtype=torch.float32, device=dev)
        cnt = torch.empty((hf, wf), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.sr_deposit(
        frames.data_ptr(), minv.data_ptr(), vb.data_ptr(), av.data_ptr(),
        aw.data_ptr(), None if bl is None else bl.data_ptr(),
        None if cnt is None else cnt.data_ptr(), n, h, w, factor,
        2.0 * kernel_sigma ** 2, _DTYPE_CODE[frames.dtype], int(perspective),
        int(with_fallback), _SCALE[frames.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, err, "sr_deposit")
    launch_count += 1
    return (av, aw, bl, cnt) if with_fallback else (av, aw)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("sr_deposit")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sr_deposit.argtypes = (
        [vp] * 7 + [ci] * 4 + [cf] + [ci] * 3 + [cf, vp]
    )
    lib.sr_deposit.restype = ci
    return lib
