"""ECC iteration moments: the CUDA kernels B1 and B7 and their plain
versions.

Counterpart of ``libstacker_tpu/ops/ecc_pallas.py`` (``moments_layout``
:57, ``_jac_tile_fields`` :70, ``_moments_kernel`` :92,
``ecc_iteration_moments`` :299, ``unpack_moments`` :400; the
inverse-compositional ``_ic_moments_kernel`` :460 and
``ecc_ic_iteration_moments`` :631).  B7's moments share B1's layout
(``ic_moments_layout`` :449, ``unpack_ic_moments`` :728 return the same
entries as ``moments_layout`` and ``unpack_moments`` here).

B1, :func:`ecc_iteration_moments`: one forward-
additive ECC iteration per lane — bilinear warp of image, gx and gy,
INTER_NEAREST validity mask, motion Jacobian — reduced to the raw Gram
moments the solver (``ops/ecc.py``) rebuilds OpenCV's quantities from:

    [ n, S(m*i), S(m*i^2), S(m*t), S(m*t^2), S(m*t*i),
      S(jac_p*i) (P), S(jac_p*m) (P), S(jac_p*m*t) (P)
      [, H_pq upper triangle (P(P+1)/2) when with_hessian] ]

:func:`ecc_iteration_moments` runs the hand-written kernel
``csrc/ecc_moments.cu`` for CUDA tensors and the plain PyTorch version
:func:`ecc_iteration_moments_reference` for CPU tensors; there is no
other dispatch.  The kernel reads the source planes interleaved as
``[H,W,4]`` texels (:func:`pack_texels`), which a solver packs once per
pyramid level.  With a 4th source plane (cv2's preprocessed binary
inputMask, ``ops/ecc.py``), its INTER_NEAREST tap replaces the all-ones
validity mask: the 4-plane variant of the kernel (``ecc_pallas.py``
:202-247).  ``with_hessian=False`` drops the Gram: the sweep of the
lazy solver, which carries the Gram from each lane's first iteration.

B7, :func:`ecc_ic_iteration_moments`: one inverse-compositional
iteration per lane — bilinear warp of the input image only, its
INTER_NEAREST validity mask, and the TEMPLATE's central-difference
gradients and Jacobian at the identity warp — reduced to

    [ n, S(m*i), S(m*i^2), S(m*t), S(m*t^2), S(m*t*i),
      S(m*jt_p*i) (P), S(m*jt_p) (P), S(m*jt_p*t) (P)
      [, S(m*jt_p*jt_q) upper triangle (P(P+1)/2) when with_hessian] ]

CUDA tensors launch ``csrc/ecc_ic_moments.cu`` or raise; CPU tensors
take :func:`ecc_ic_iteration_moments_reference`.

The solve's Gaussian pre-filter, :func:`gaussian_prefilter`: OpenCV's
GaussianBlur with reflect-101 borders on ``[N,H,W]`` float32 planes, the
templates of a level and its input image.  CUDA tensors launch
``csrc/ecc_blur.cu`` (one pass, bitwise equal to the plain version) or
raise; CPU tensors take ``ops/filters.gaussian_blur``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from .. import constants
from ..params import MotionType
from ..utils import cuda_build
from . import filters, warp

#: launches of B1's 3-plane kernel with the Gram since the last reset
#: (one per call)
launch_count = 0
#: launches of B1's 3-plane kernel without the Gram (the lazy solver's
#: sweep) since the last reset
lite_launch_count = 0
#: launches of B1's 4-plane (masked) kernel, with or without the Gram
masked_launch_count = 0
#: launches of B7 (the inverse-compositional sweep) since the last reset
ic_launch_count = 0
#: launches of the Gaussian pre-filter (csrc/ecc_blur.cu) since the last
#: reset: one for the templates and one for the input image a solved level
blur_launch_count = 0

_IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def moments_layout(
    motion_type: MotionType, with_hessian: bool = True
) -> Tuple[int, int]:
    """(n_params, n_out) for the moments vector of a motion model."""
    p = motion_type.num_params
    n = 6 + 3 * p
    if with_hessian:
        n += p * (p + 1) // 2
    return p, n


def _jacobian(
    motion_type: MotionType, gxw, gyw, xs, ys, sx, sy, m
) -> List[torch.Tensor]:
    """Jacobian fields [P x (H,W)] (``_jac_tile_fields``); ``m`` holds
    the 9 matrix entries, ``sx``/``sy`` the warped coordinates."""
    if motion_type == MotionType.Translation:
        return [gxw, gyw]
    if motion_type == MotionType.Euclidean:
        h0, h1 = m[0], m[3]
        hat_x = -xs * h1 - ys * h0
        hat_y = xs * h0 - ys * h1
        return [gxw * hat_x + gyw * hat_y, gxw, gyw]
    if motion_type == MotionType.Affine:
        return [gxw * xs, gyw * xs, gxw * ys, gyw * ys, gxw, gyw]
    den = m[6] * xs + m[7] * ys + 1.0
    inv_den = 1.0 / den
    gxd = gxw * inv_den
    gyd = gyw * inv_den
    tmp = sx * gxd + sy * gyd
    return [gxd * xs, gyd * xs, -tmp * xs, gxd * ys, gyd * ys, -tmp * ys,
            gxd, gyd]


def ecc_iteration_moments_reference(
    srcs: torch.Tensor,
    templates: torch.Tensor,
    m3: torch.Tensor,
    motion_type: MotionType,
    quant_affine: bool = False,
    active: Optional[torch.Tensor] = None,
    with_hessian: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: full warped fields through
    ``ops/warp.py``, then mask (times the nearest-warped 4th plane when
    there is one), Jacobian and the moment sums (taken in float64,
    returned as float32).  Inactive lanes give zero rows."""
    _, h, w = srcs.shape
    b = templates.shape[0]
    _, n_out = moments_layout(motion_type, with_hessian)
    out = torch.zeros((b, n_out), dtype=torch.float32, device=srcs.device)
    ys = torch.arange(h, dtype=torch.float32, device=srcs.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=srcs.device)[None, :]
    xs = xs.expand(h, w)
    ys = ys.expand(h, w)
    for lane in range(b):
        if active is not None and not bool(active[lane]):
            continue
        mm = m3[lane].to(torch.float32)
        imw, gxw, gyw = (
            warp.warp_inverse(s, mm, (h, w), quant_affine) for s in srcs[:3]
        )
        mask = warp.warp_valid_mask(mm, (h, w), (h, w))
        if srcs.shape[0] == 4:
            mask = mask * warp.warp_inverse(
                srcs[3], mm, (h, w), quant_affine,
                interpolation=constants.INTER_NEAREST)
        sx, sy = warp._dst_coords(mm, (h, w), perspective=True)
        jac = _jacobian(
            motion_type, gxw, gyw, xs, ys, sx, sy, mm.reshape(9)
        )
        tmpl = templates[lane]
        mi = mask * imw
        mt = mask * tmpl
        terms = [mask, mi, mi * imw, mt, mt * tmpl, mt * imw]
        terms += [j * imw for j in jac]
        terms += [j * mask for j in jac]
        terms += [j * mt for j in jac]
        if with_hessian:
            terms += [
                jac[a] * jac[q]
                for a in range(len(jac)) for q in range(a, len(jac))
            ]
        out[lane] = torch.stack(
            [t.to(torch.float64).sum() for t in terms]
        ).to(torch.float32)
    return out


def pack_texels(srcs: torch.Tensor) -> torch.Tensor:
    """``[3|4,H,W]`` source planes -> the ``[H,W,4]`` float32 texels B1
    reads (image, gx, gy, and the inputMask or 0): one 16-byte load per
    bilinear tap.  Pack once per pyramid level and pass the result to
    every :func:`ecc_iteration_moments` sweep of that level."""
    c, h, w = srcs.shape
    tex = torch.zeros((h, w, 4), dtype=torch.float32, device=srcs.device)
    tex[..., :c] = srcs.permute(1, 2, 0)
    return tex


def ecc_iteration_moments(
    srcs: torch.Tensor,
    templates: torch.Tensor,
    m3: torch.Tensor,
    motion_type: MotionType,
    quant_affine: bool = False,
    active: Optional[torch.Tensor] = None,
    with_hessian: bool = True,
    texels: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One ECC iteration sweep -> ``[B, n_out]`` float32 raw moments.

    ``srcs`` [3,H,W] float32 (image, gx, gy) or [4,H,W] (plus the
    preprocessed inputMask, gx and gy already multiplied by it),
    ``templates`` [B,H,W] float32, ``m3`` [B,3,3] inverse maps,
    ``active`` [B] bool (inactive lanes return zero rows).  CPU tensors
    take the plain version; CUDA tensors launch ``csrc/ecc_moments.cu``
    or raise.  ``texels`` is ``pack_texels(srcs)``, made once by a caller
    that sweeps the same sources many times; without it a CUDA call
    packs its own."""
    if srcs.ndim != 3 or srcs.shape[0] not in (3, 4):
        raise ValueError(f"srcs must be [3,H,W] or [4,H,W], got "
                         f"{tuple(srcs.shape)}")
    masked = srcs.shape[0] == 4
    b, ht, wt = templates.shape
    _, h, w = srcs.shape
    if (ht, wt) != (h, w):
        raise ValueError(f"templates {ht}x{wt} != source extent {h}x{w}")
    if tuple(m3.shape) != (b, 3, 3):
        raise ValueError(f"m3 must be [{b},3,3], got {tuple(m3.shape)}")
    if srcs.device.type == "cpu":
        return ecc_iteration_moments_reference(
            srcs, templates, m3, motion_type, quant_affine, active,
            with_hessian,
        )
    if srcs.device.type != "cuda":
        raise ValueError(f"unsupported device {srcs.device}")
    p, n_out = moments_layout(motion_type, with_hessian)
    dev = srcs.device
    if b == 0:
        return torch.zeros((0, n_out), dtype=torch.float32, device=dev)
    for name, t in (("srcs", srcs), ("templates", templates), ("m3", m3)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"{name} must be a contiguous float32 tensor on {dev}"
            )
    if texels is None:
        texels = pack_texels(srcs)
    elif (tuple(texels.shape) != (h, w, 4) or texels.dtype != torch.float32
          or not texels.is_contiguous() or texels.device != dev):
        raise ValueError(f"texels must be pack_texels(srcs): a contiguous "
                         f"[{h},{w},4] float32 tensor on {dev}")
    if active is None:
        act = torch.ones((b,), dtype=torch.uint8, device=dev)
    else:
        act = active.to(device=dev, dtype=torch.uint8).contiguous()
    lib = _lib()
    nblk = lib.ecc_moments_num_blocks(h, w)
    partials = torch.empty((b, n_out, nblk), dtype=torch.float32, device=dev)
    out = torch.empty((b, n_out), dtype=torch.float32, device=dev)
    cuda_build.launch(
        lib, "ecc_moments", dev,
        texels.data_ptr(), templates.data_ptr(), m3.data_ptr(), act.data_ptr(),
        partials.data_ptr(), out.data_ptr(), b, h, w, p, int(with_hessian),
        int(quant_affine), int(masked),
    )
    if masked:
        cuda_build.count(globals(), "masked_launch_count")
    elif with_hessian:
        cuda_build.count(globals(), "launch_count")
    else:
        cuda_build.count(globals(), "lite_launch_count")
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("ecc_moments")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ecc_moments.argtypes = [vp] * 6 + [ci] * 7 + [vp]
    lib.ecc_moments.restype = ci
    lib.ecc_moments_num_blocks.argtypes = [ci, ci]
    lib.ecc_moments_num_blocks.restype = ci
    return lib


def gaussian_prefilter(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """``filters.gaussian_blur(x, ksize)`` of ``[N,H,W]`` contiguous
    float32 planes into a new tensor.  CPU tensors take that plain
    version; CUDA tensors launch ``csrc/ecc_blur.cu`` on the current
    stream (bitwise the plain version, with no padded copy and no
    intermediate plane) or raise.  ``ksize`` is any odd size >= 1
    (``filters.gaussian_kernel``'s taps); H and W must exceed its radius,
    as the plain version's reflect pad requires."""
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"x must be [N,H,W] float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"ksize must be odd and >= 1, got {ksize}")
    n, h, w = x.shape
    r = ksize // 2
    if h <= r or w <= r:
        raise ValueError(f"{h}x{w} planes must exceed the radius {r} of "
                         f"ksize {ksize}")
    if x.device.type == "cpu":
        return filters.gaussian_blur(x, ksize)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x)
    cuda_build.launch(
        _blur_lib(), "gaussian_prefilter", x.device, x.data_ptr(),
        out.data_ptr(), _taps_on(x.device, ksize).data_ptr(), n, h, w, r,
    )
    cuda_build.count(globals(), "blur_launch_count")
    return out


@functools.lru_cache(maxsize=None)
def _taps_on(device: torch.device, ksize: int) -> torch.Tensor:
    """``filters.gaussian_kernel(ksize)`` as float32 on ``device``, copied
    once (a copy from pageable host memory synchronises the stream)."""
    return torch.tensor(filters.gaussian_kernel(ksize), dtype=torch.float32,
                        device=device)


@functools.lru_cache(maxsize=None)
def _blur_lib() -> ctypes.CDLL:
    lib = cuda_build.load("ecc_blur")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gaussian_prefilter.argtypes = [vp] * 3 + [ci] * 4 + [vp]
    lib.gaussian_prefilter.restype = ci
    return lib


def _template_gradients(t: torch.Tensor):
    """Central differences ``0.5 * (t[x+1] - t[x-1])`` (and along y) of
    one template, zero on the first and last column (row): reflect-101
    central differences vanish there (``ecc_pallas.py`` :574-585)."""
    gtx = torch.zeros_like(t)
    gty = torch.zeros_like(t)
    gtx[:, 1:-1] = 0.5 * (t[:, 2:] - t[:, :-2])
    gty[1:-1, :] = 0.5 * (t[2:, :] - t[:-2, :])
    return gtx, gty


def ecc_ic_iteration_moments_reference(
    src: torch.Tensor,
    templates: torch.Tensor,
    m3: torch.Tensor,
    motion_type: MotionType,
    quant_affine: bool = False,
    active: Optional[torch.Tensor] = None,
    with_hessian: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of B7: the input image warped through
    ``ops/warp.py``, its validity mask, the template-side Jacobian at the
    identity warp, and the moment sums (in float64, returned as float32);
    the oracle of ``tests/test_ecc_pallas.py`` :310-370.  Inactive lanes
    give zero rows."""
    h, w = src.shape
    b = templates.shape[0]
    _, n_out = moments_layout(motion_type, with_hessian)
    dev = src.device
    out = torch.zeros((b, n_out), dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ident = torch.tensor(_IDENTITY, dtype=torch.float32, device=dev)
    for lane in range(b):
        if active is not None and not bool(active[lane]):
            continue
        mm = m3[lane].to(torch.float32)
        imw = warp.warp_inverse(src, mm, (h, w), quant_affine)
        mask = warp.warp_valid_mask(mm, (h, w), (h, w))
        tmpl = templates[lane]
        gtx, gty = _template_gradients(tmpl)
        jac = _jacobian(motion_type, gtx, gty, xs, ys, xs, ys, ident)
        jm = [j * mask for j in jac]
        mi = mask * imw
        mt = mask * tmpl
        terms = [mask, mi, mi * imw, mt, mt * tmpl, mt * imw]
        terms += [j * imw for j in jm]
        terms += jm
        terms += [j * tmpl for j in jm]
        if with_hessian:
            terms += [
                jm[a] * jac[q]
                for a in range(len(jac)) for q in range(a, len(jac))
            ]
        out[lane] = torch.stack(
            [t.to(torch.float64).sum() for t in terms]
        ).to(torch.float32)
    return out


def ecc_ic_iteration_moments(
    src: torch.Tensor,
    templates: torch.Tensor,
    m3: torch.Tensor,
    motion_type: MotionType,
    quant_affine: bool = False,
    active: Optional[torch.Tensor] = None,
    with_hessian: bool = False,
) -> torch.Tensor:
    """One inverse-compositional ECC sweep -> ``[B, n_out]`` float32 raw
    moments in B1's layout (``moments_layout``).

    ``src`` [H,W] float32 (the blurred input image), ``templates``
    [B,H,W] float32 (blurred), ``m3`` [B,3,3] inverse maps, ``active``
    [B] bool (inactive lanes return zero rows).  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/ecc_ic_moments.cu`` or
    raise."""
    if src.ndim != 2:
        raise ValueError(f"src must be [H,W], got {tuple(src.shape)}")
    b, ht, wt = templates.shape
    h, w = src.shape
    if (ht, wt) != (h, w):
        raise ValueError(f"templates {ht}x{wt} != source extent {h}x{w}")
    if tuple(m3.shape) != (b, 3, 3):
        raise ValueError(f"m3 must be [{b},3,3], got {tuple(m3.shape)}")
    if src.device.type == "cpu":
        return ecc_ic_iteration_moments_reference(
            src, templates, m3, motion_type, quant_affine, active,
            with_hessian,
        )
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    p, n_out = moments_layout(motion_type, with_hessian)
    dev = src.device
    if b == 0:
        return torch.zeros((0, n_out), dtype=torch.float32, device=dev)
    for name, t in (("src", src), ("templates", templates), ("m3", m3)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"{name} must be a contiguous float32 tensor on {dev}"
            )
    if active is None:
        act = torch.ones((b,), dtype=torch.uint8, device=dev)
    else:
        act = active.to(device=dev, dtype=torch.uint8).contiguous()
    lib = _ic_lib()
    nblk = lib.ecc_ic_moments_num_blocks(h, w)
    partials = torch.empty((b, n_out, nblk), dtype=torch.float32, device=dev)
    out = torch.empty((b, n_out), dtype=torch.float32, device=dev)
    cuda_build.launch(
        lib, "ecc_ic_moments", dev,
        src.data_ptr(), templates.data_ptr(), m3.data_ptr(), act.data_ptr(),
        partials.data_ptr(), out.data_ptr(), b, h, w, p, int(with_hessian),
        int(quant_affine),
    )
    cuda_build.count(globals(), "ic_launch_count")
    return out


@functools.lru_cache(maxsize=None)
def _ic_lib() -> ctypes.CDLL:
    lib = cuda_build.load("ecc_ic_moments")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ecc_ic_moments.argtypes = [vp] * 6 + [ci] * 6 + [vp]
    lib.ecc_ic_moments.restype = ci
    lib.ecc_ic_moments_num_blocks.argtypes = [ci, ci]
    lib.ecc_ic_moments_num_blocks.restype = ci
    return lib


def unpack_moments(
    mom: torch.Tensor, motion_type: MotionType, with_hessian: bool = True
):
    """[B, n_out] moments -> (n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti,
    hessian [B,P,P] (or None), j_i [B,P], j_m [B,P], j_mt [B,P])."""
    p = motion_type.num_params
    n_raw = mom[:, 0]
    s_mi, s_mii, s_mt, s_mtt, s_mti = (mom[:, i] for i in range(1, 6))
    j_i = mom[:, 6 : 6 + p]
    j_m = mom[:, 6 + p : 6 + 2 * p]
    j_mt = mom[:, 6 + 2 * p : 6 + 3 * p]
    hess = None
    if with_hessian:
        o = 6 + 3 * p
        tri = mom[:, o : o + p * (p + 1) // 2]
        rows, cols = torch.triu_indices(p, p, device=mom.device)
        hess = torch.zeros((mom.shape[0], p, p), dtype=mom.dtype,
                           device=mom.device)
        hess[:, rows, cols] = tri
        hess[:, cols, rows] = tri
    return n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti, hess, j_i, j_m, j_mt

