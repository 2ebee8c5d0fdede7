"""The four sharpness metrics of a burst in one pass: ``csrc/sharpness.cu``
and its plain version.

:func:`sharpness_sums` takes ``[N,H,W]`` contiguous u8, u16 or float32
grey and returns, per frame, the six sums the metrics are made of,
``[N, 6]`` float64 (:data:`SUMS`), and the metrics LAPM, LAPV, TENG and
GLVN (:data:`METRICS`), ``[4, N]`` float32.  CUDA tensors launch the
kernel (two launches, whatever N) or raise; CPU tensors take the plain
version :func:`sharpness_sums_reference`: the float32 planes of
``ops/filters.sep_filter2d``, their squares and sums in float64, and the
same finalisation (:func:`metrics_from_sums`).  For u8 at ``k_size`` 1
and 3 the sums are exact integers (quarters for LAPM), so the kernel's
equal the plain version's; elsewhere they differ in their last bits.

Replaces no TPU kernel: the JAX package scores with XLA-level jnp
(``libstacker_tpu/ops/sharpness.py`` :38-97).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..errors import InvalidParamsError
from ..utils import cuda_build
from . import filters

#: launches of csrc/sharpness.cu since the last reset: two a call (the
#: sums, then the frames' finalisation)
launch_count = 0

#: the six per-frame sums, in order
SUMS = ("sum|Lx|+|Ly|", "sum lap", "sum lap^2", "sum gx^2+gy^2", "sum x",
        "sum x^2")
#: the metrics, in the order of the rows of the metrics tensor
METRICS = ("lapm", "lapv", "teng", "glvn")

#: the dtypes read as they are, and their codes in csrc/sharpness.cu
DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_EPS_F64 = 2.220446049250313e-16  # f64::EPSILON used at ref src/lib.rs:1163


def check_k_size(k_size: int) -> None:
    """TENG's ksize, as the reference validates it (src/lib.rs:1103-1107)."""
    if k_size not in (1, 3, 5, 7):
        raise InvalidParamsError("Kernel size must be 1, 3, 5, or 7")


def _check(x: torch.Tensor, k_size: int) -> None:
    """Raise where the kernel or the plain version refuses ``x``."""
    check_k_size(k_size)
    if x.ndim != 3 or x.dtype not in DTYPES:
        raise ValueError(f"x must be [N,H,W] uint8, uint16 or float32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    r = max(1, k_size // 2)
    if x.shape[1] <= r or x.shape[2] <= r:
        raise ValueError(f"{x.shape[1]}x{x.shape[2]} frames must exceed the "
                         f"reflect radius {r} of k_size {k_size}")


def sharpness_sums(x: torch.Tensor, k_size: int = 3
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums [N,6] float64, metrics [4,N] float32)`` of ``[N,H,W]``
    contiguous grey, TENG at ``k_size``.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/sharpness.cu`` or raise."""
    _check(x, k_size)
    if x.device.type == "cpu":
        return sharpness_sums_reference(x, k_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, h, w = x.shape
    sums = torch.empty((n, 6), dtype=torch.float64, device=x.device)
    metrics = torch.empty((4, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return sums, metrics
    lib = _lib()
    code = DTYPES[x.dtype]
    slots = lib.sharpness_slots(n, h, w, code, k_size)
    if slots <= 0:
        raise ValueError(f"{n} frames of {h}x{w} exceed the kernel's grid")
    partials = torch.empty((n, slots, 6), dtype=torch.float64,
                           device=x.device)
    cuda_build.launch(lib, "sharpness_metrics", x.device, x.data_ptr(),
                      partials.data_ptr(), sums.data_ptr(),
                      metrics.data_ptr(), n, h, w, code, k_size)
    cuda_build.count(globals(), "launch_count", 2)
    return sums, metrics


def sharpness_sums_reference(x: torch.Tensor, k_size: int = 3
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``ops/sharpness._SCORE_CHUNK`` frames a pass,
    each metric's float32 planes through ``filters.sep_filter2d`` as the
    reference forms them, squared and summed in float64."""
    from . import sharpness  # its _SCORE_CHUNK, read at call time

    _check(x, k_size)
    n, h, w = x.shape
    chunk = sharpness._SCORE_CHUNK
    m = (-1.0, 2.0, -1.0)
    g = filters.gaussian_kernel(3, -1.0)
    parts = []
    for s in range(0, max(n, 1), chunk):
        f = x[s : s + chunk].to(torch.float32)
        lapm = filters.sep_filter2d(f, m, g).abs_()
        lapm += filters.sep_filter2d(f, g, m).abs_()
        lap = filters.laplacian(f, ksize=3, border="replicate")
        gx = filters.sobel(f, 1, 0, ksize=k_size)
        gy = filters.sobel(f, 0, 1, ksize=k_size)
        parts.append(torch.stack([
            _sum(lapm), _sum(lap), _sum_sq(lap), _sum_grad(gx, gy),
            _sum(f), _sum_sq(f)], dim=-1))
    sums = torch.cat(parts)
    return sums, metrics_from_sums(sums, h * w)


def _sum(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float64).sum(dim=(-2, -1))


def _sum_sq(v: torch.Tensor) -> torch.Tensor:
    d = v.to(torch.float64)
    return (d * d).sum(dim=(-2, -1))


def _sum_grad(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """sum(gx^2 + gy^2), each pixel's value formed in float64."""
    dx, dy = gx.to(torch.float64), gy.to(torch.float64)
    return (dx * dx + dy * dy).sum(dim=(-2, -1))


def metrics_from_sums(sums: torch.Tensor, npx: int) -> torch.Tensor:
    """``[N,6]`` float64 sums of frames of ``npx`` pixels -> ``[4,N]``
    float32 LAPM, LAPV, TENG, GLVN, formed in float64 and rounded once
    (the kernel's finalisation)."""
    s = sums / float(npx)
    mu = s[:, 4]
    lapv = s[:, 2] - s[:, 1] * s[:, 1]
    glvn = (s[:, 5] - mu * mu) / torch.clamp(mu, min=_EPS_F64)
    return torch.stack([s[:, 0], lapv, s[:, 3], glvn]).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("sharpness")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sharpness_slots.argtypes = [ci] * 5
    lib.sharpness_slots.restype = ci
    lib.sharpness_metrics.argtypes = [vp] * 4 + [ci] * 5 + [vp]
    lib.sharpness_metrics.restype = ci
    return lib
