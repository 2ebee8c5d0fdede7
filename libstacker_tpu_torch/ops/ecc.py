"""Batched Enhanced Correlation Coefficient (ECC) alignment.

Counterpart of ``libstacker_tpu/ops/ecc.py``: OpenCV's forward-additive
``findTransformECC`` (Evangelidis & Psarakis, PAMI 2008) for a batch of
templates against one shared input image, and the JAX package's two
opt-in formulations of the same objective.

- ``identity_warp`` :105, ``_as_3x3`` :113, ``_update_warp`` :117
  (OpenCV's parameter order), ``_compose_warp_ic`` :145,
  ``_input_fields`` :236 (Gaussian pre-filter, [-0.5, 0, 0.5] central
  differences, reflect-101), ``_reactivate_carry`` :273,
  ``_rescale_warp_batch`` :1006, the template prep and solve carry
  ``(m, rho=-1, last_rho=-eps, it=0, ok=True[, gram, h_ok])`` of
  :936-959, and ``find_transform_ecc_batched`` :1150 with
  ``coarse_levels``, ``warp_init`` and the cross-scale ``rho_init`` seed
  (:1214-1348).
- The Gaussian pre-filter of the input image and of the templates is
  ``ecc_cuda.gaussian_prefilter``: one pass of ``csrc/ecc_blur.cu`` on
  the card, bitwise ``filters.gaussian_blur``, which the CPU runs.
- ``mode='forward'`` (the default): every Gauss-Newton iteration is one
  sweep of kernel B1 (``ops/ecc_cuda.ecc_iteration_moments``, the TPU's
  ``_moments_kernel``); OpenCV's statistics, projections and the update
  are rebuilt from its raw moments as ``ecc.py:778-906`` does.
- ``mode='lazy'`` (:735-769): the same forward linearisation, but the
  Jacobian Gram is computed on each lane's first iteration (B1 with the
  Gram) and carried; later sweeps run B1 without it (30 instead of 66
  reductions for a homography).  No rho guard (:879-886).
- ``mode='ic'`` (:627-721): inverse-compositional — kernel B7
  (``ecc_cuda.ecc_ic_iteration_moments``) warps only the input image and
  takes the Jacobian on the template side at the identity, the Gram is
  carried as in 'lazy', the update is role-swapped and composes
  ``W <- W @ inv(w(dp))``, and a lane whose rho drops by more than
  ``max(eps, 1e-5)`` after its first iteration is failed (:694-697).
- Rescue (:1512-1527): a lane that ends an 'ic' or 'lazy' solve with
  ``ok == False`` restarts from its original init and is solved again in
  forward mode, the port's exact formulation (the JAX package runs that
  rescue on its XLA path); every other lane stays as it ended.
- The loop is plain Python over iterations with a per-lane ``active``
  mask; convergence (``|rho - last_rho| < eps``, iteration budget,
  failure) is read on the host every ``_CHUNK_ITERS`` iterations.
  Inactive lanes are frozen, so the iterates do not depend on how often
  the host looks.

The port has this one code path on every device, so ``mode`` means the
same on the CPU (the kernels' plain versions) as on the card; the JAX
package runs 'lazy' and 'ic' only through its Pallas kernels and solves
forward on the CPU unless ``LIBSTACKER_FORCE_PALLAS`` is set.  Its
``LIBSTACKER_ECC_MODE`` override, an A/B knob, is not ported:
``EccMatchParameters.solver`` is the switch.

Not ported, because it exists only for TPU limits: the lane groups,
slabs and watchdog bound (``ecc.py:983-1003``, ``:1362-1426``), the
residual band ladder ``_K_LADDER`` with its ``residual_domain_ok``
checks, the ``esc`` carry flag and the escalation (``:1470-1511``), and
``_solve_octave_nosync``'s dispatch without host syncs.  A thread on the
card gathers any source pixel, so there is no band to escape.  Every
octave runs the solve loop and carries the octave's shrunken
``input_mask`` as ``_solve_octave_nosync`` does (``:1099-1130``); a
'forward' or 'lazy' octave skips the rescue as that function does, and
a failed 'lazy' octave lane hands the next level its pre-solve init
(:1130-1139), while an 'ic' octave runs with its rescue (:1285-1317).
``input_mask`` (cv2's inputMask, ``_prepare_masked_input``) rides kernel
B1 as a 4th source plane; with a mask 'ic' solves in forward mode
(:1210-1213).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..params import MotionType
from ..utils import cuda_build
from . import ecc_cuda, filters, resize, warp

# Iterations between host convergence checks (the reference's
# while_loop chunk).
_CHUNK_ITERS = 4

_MODES = ("forward", "lazy", "ic")
# floor of the IC solver's rho-monotonicity guard (ecc.py:694-697)
_IC_GUARD_FLOOR = 1e-5

#: lanes that the 'ic' / 'lazy' rescue re-solved in forward mode since
#: the last reset
rescued_lane_count = 0


class EccResult(NamedTuple):
    rho: torch.Tensor  # correlation coefficient, [] or [N]
    warp_matrix: torch.Tensor  # [2,3] or [3,3] (batched: leading N)
    ok: torch.Tensor  # bool, False if the solver hit an OpenCV error case
    num_iters: torch.Tensor  # iterations actually executed


def identity_warp(motion_type: MotionType, device=None) -> torch.Tensor:
    """eye(3,3) for a homography, eye(2,3) otherwise."""
    rows = 3 if motion_type == MotionType.Homography else 2
    return torch.eye(3, dtype=torch.float32, device=device)[:rows]


def _as_3x3(m: torch.Tensor) -> torch.Tensor:
    return m if m.shape[-2] == 3 else warp.affine_to_3x3(m)


def _update_warp(
    motion_type: MotionType, m: torch.Tensor, dp: torch.Tensor
) -> torch.Tensor:
    """Batched OpenCV ``update_warping_matrix_ECC``: m [B,r,3], dp [B,P]."""
    if motion_type == MotionType.Translation:
        new = m.clone()
        new[:, 0, 2] = m[:, 0, 2] + dp[:, 0]
        new[:, 1, 2] = m[:, 1, 2] + dp[:, 1]
        return new
    if motion_type == MotionType.Euclidean:
        theta = dp[:, 0] + torch.asin(torch.clamp(m[:, 1, 0], -1.0, 1.0))
        c, s = torch.cos(theta), torch.sin(theta)
        row0 = torch.stack([c, -s, m[:, 0, 2] + dp[:, 1]], dim=1)
        row1 = torch.stack([s, c, m[:, 1, 2] + dp[:, 2]], dim=1)
        return torch.stack([row0, row1], dim=1)
    if motion_type == MotionType.Affine:
        upd = torch.stack(
            [torch.stack([dp[:, 0], dp[:, 2], dp[:, 4]], dim=1),
             torch.stack([dp[:, 1], dp[:, 3], dp[:, 5]], dim=1)], dim=1,
        )
        return m + upd
    zero = torch.zeros_like(dp[:, 0])
    upd = torch.stack(
        [torch.stack([dp[:, 0], dp[:, 3], dp[:, 6]], dim=1),
         torch.stack([dp[:, 1], dp[:, 4], dp[:, 7]], dim=1),
         torch.stack([dp[:, 2], dp[:, 5], zero], dim=1)], dim=1,
    )
    return m + upd


def _compose_warp_ic(
    motion_type: MotionType, m: torch.Tensor, dp: torch.Tensor
) -> torch.Tensor:
    """Batched inverse-compositional update ``W <- W @ inv(w(dp))``,
    ``w(dp)`` being OpenCV's parameter layout applied to the identity; a
    homography renormalises to ``m22 = 1``, the other motion types keep
    the top two rows (their compositions stay in the class)."""
    eye = identity_warp(motion_type, m.device).expand(m.shape[0], -1, -1)
    delta = _update_warp(motion_type, eye, dp)
    # failed lanes' dp may be non-finite: their result is masked out
    inv, _ = torch.linalg.inv_ex(_as_3x3(delta))
    new = _as_3x3(m) @ inv
    if motion_type == MotionType.Homography:
        return new / new[:, 2:3, 2:3]
    return new[:, :2]


def _input_fields(input_image: torch.Tensor, gauss_filt_size: int):
    """Input-side fields: Gaussian pre-filter + central-difference
    gradients (OpenCV ecc.cpp's image preparation)."""
    image_f = ecc_cuda.gaussian_prefilter(
        input_image.to(torch.float32).contiguous()[None], gauss_filt_size
    )[0]
    dx = (-0.5, 0.0, 0.5)
    gx = filters.sep_filter2d(image_f, dx, (1.0,), border="reflect101")
    gy = filters.sep_filter2d(image_f, (1.0,), dx, border="reflect101")
    return image_f, gx, gy


def _rescale_warp_batch(
    warps: torch.Tensor, motion_type: MotionType, s: float
) -> torch.Tensor:
    """Warps estimated on a 1/s-scale grid -> full scale (translation
    column scales; the homography's perspective row divides)."""
    w = warps.clone()
    w[..., 0, 2] *= s
    w[..., 1, 2] *= s
    if motion_type == MotionType.Homography:
        w[..., 2, 0] /= s
        w[..., 2, 1] /= s
    return w


_NO_SPAN = contextlib.nullcontext()


def _phase(timer, name: str):
    return _NO_SPAN if timer is None else timer.phase(name)


def _span(timer, name: str):
    """``timer.span(name)``; without a timer one shared no-op, so an
    untraced solve pays one branch a span and allocates nothing."""
    return _NO_SPAN if timer is None else timer.span(name)


def _prepare_masked_input(input_image, input_mask, gauss_filt_size: int):
    """Input-side fields plus OpenCV's inputMask preprocessing
    (``_ecc_prepare_input_masked_jit`` :257-270): binarise, Gaussian-blur
    with ``gauss_filt_size``, re-threshold at 0.95 through ``round(pre_f
    * 0.5/0.95)`` (half to even, like cvRound), and multiply the
    gradients by the binary mask -> ``[4,H,W]`` (image, gx, gy, mask)."""
    image_f, gx, gy = _input_fields(input_image, gauss_filt_size)
    pre = (input_mask > 0).to(torch.float32)
    pre_f = filters.gaussian_blur(pre, gauss_filt_size)
    pre_bin = torch.round(pre_f * (0.5 / 0.95))
    return torch.stack([image_f, gx * pre_bin, gy * pre_bin, pre_bin])


def _resolve_mode(mode: Optional[str], input_mask) -> str:
    """``None`` -> 'forward'; anything outside ``_MODES`` raises; a
    masked 'ic' solve runs forward (B7 has no mask operand)."""
    if mode is None:
        mode = "forward"
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if input_mask is not None and mode == "ic":
        return "forward"
    return mode


def find_transform_ecc(
    template: torch.Tensor,
    input_image: torch.Tensor,
    motion_type: MotionType = MotionType.Affine,
    num_iters: int = 200,
    eps: float = -1.0,
    gauss_filt_size: int = 5,
    warp_init: Optional[torch.Tensor] = None,
    mode: Optional[str] = None,
    input_mask=None,
) -> EccResult:
    """Estimate the warp aligning ``input_image`` to ``template``
    (``cv2.findTransformECC`` semantics: the returned ``M`` warps the
    input onto the template grid as dst(x, y) = input(M (x, y))).
    Images are [H,W] uint8 or float on the raw 0..255 scale;
    ``input_mask`` ([H,W], nonzero = valid) is cv2's inputMask."""
    template = torch.as_tensor(template)
    res = find_transform_ecc_batched(
        template[None],
        torch.as_tensor(input_image, device=template.device),
        motion_type=motion_type,
        num_iters=num_iters,
        eps=eps,
        gauss_filt_size=gauss_filt_size,
        warp_init=None if warp_init is None else torch.as_tensor(warp_init)[None],
        mode=mode,
        input_mask=input_mask,
    )
    return EccResult(
        rho=res.rho[0], warp_matrix=res.warp_matrix[0], ok=res.ok[0],
        num_iters=res.num_iters[0],
    )


def find_transform_ecc_batched(
    templates: torch.Tensor,
    input_image: torch.Tensor,
    motion_type: MotionType = MotionType.Affine,
    num_iters: int = 200,
    eps: float = -1.0,
    gauss_filt_size: int = 5,
    coarse_levels: int = 0,
    warp_init: Optional[torch.Tensor] = None,
    mode: Optional[str] = None,
    input_mask=None,
    rho_init: Optional[torch.Tensor] = None,
    timer=None,
) -> EccResult:
    """Batched ECC: one warp per template frame ([N,H,W]) against a
    shared input image ([H,W]), on the templates' device.

    ``coarse_levels`` > 0 first solves on cascaded 2x INTER_AREA
    octaves (levels whose smaller side stays >= 64 px) and refines at
    full resolution from that warm start, seeding each lane's
    ``last_rho`` with its octave's converged correlation (``rho_init``,
    ignored when ``eps <= 0``).  ``warp_init`` ([N,2|3,3]) is in
    full-resolution pixels.  ``input_mask`` ([H,W], nonzero = valid) is
    cv2.findTransformECC's inputMask over ``input_image``; each octave
    solves with its INTER_AREA-shrunk mask (valid where >= 0.5).
    ``timer`` (a ``utils.tracing.PhaseTimer``) records the octave build,
    the octave solves and the full-resolution solve as phases, and in
    each solve the spans ``ecc.prep`` (the fields, the template blur,
    the texel pack and the carry), ``ecc.sweep`` (one iteration over
    every lane), ``ecc.check`` (the host's convergence read) and
    ``ecc.rescue`` (the forward re-solve of failed lanes).

    ``mode``: 'forward' (``None``; OpenCV's formulation), 'lazy' or
    'ic' (module docstring).  The ``rho_init`` seed applies to 'forward'
    and 'lazy' only: 'ic''s divergence guard compares against the
    running rho (:1404)."""
    mode = _resolve_mode(mode, input_mask)
    dev = templates.device
    input_image = input_image.to(dev)
    if input_mask is not None:
        input_mask = torch.as_tensor(input_mask).to(dev)
        if tuple(input_mask.shape) != tuple(input_image.shape):
            raise ValueError(
                f"input_mask shape {tuple(input_mask.shape)} must match "
                f"input_image shape {tuple(input_image.shape)}"
            )
    init = warp_init
    if init is not None:
        init = torch.as_tensor(init, dtype=torch.float32).to(dev)
    rho_seed = None if rho_init is None else rho_init.to(dev)
    if coarse_levels > 0:
        n, h, w = templates.shape
        levels = [
            lvl for lvl in range(1, coarse_levels + 1)
            if min(h, w) // 2 ** lvl >= 64
        ]
        octaves = {}
        with _phase(timer, "ecc octave build"):
            tl, il = templates.to(torch.float32), input_image.to(torch.float32)
            ml = (None if input_mask is None
                  else (input_mask > 0).to(torch.float32))
            for lvl in range(1, (max(levels) + 1) if levels else 1):
                dh, dw = h // 2 ** lvl, w // 2 ** lvl
                tl = resize.resize_area_octave(tl, dh, dw)
                il = resize.resize_area_octave(il, dh, dw)
                if ml is not None:
                    ml = resize.resize_area_octave(ml, dh, dw)
                if lvl in levels:
                    # a coarse pixel stays valid only if >= half its
                    # INTER_AREA footprint was
                    octaves[lvl] = (tl, il, None if ml is None else ml >= 0.5)
        init_at_full_scale = init is not None
        rho_seed = None  # the octaves' own seed replaces the caller's
        for lvl in sorted(octaves, reverse=True):
            s = 2 ** lvl
            tl, il, mlv = octaves[lvl]
            if init_at_full_scale:
                init = _rescale_warp_batch(init, motion_type, 1.0 / s)
                init_at_full_scale = False
            with _phase(timer, "ecc octave solve"):
                res = _solve_lanes(
                    tl, il, motion_type, num_iters, eps, gauss_filt_size,
                    init, None, mlv, mode, rescue=mode == "ic", timer=timer,
                )
            wm = res.warp_matrix
            if mode == "lazy":
                # a failed lane's frozen iterate is no warm start: hand
                # the next level its pre-solve init
                m0 = (identity_warp(motion_type, dev).expand_as(wm)
                      if init is None else init)
                wm = torch.where(res.ok[:, None, None], wm, m0)
            init = _rescale_warp_batch(wm, motion_type, 2.0)
            rho_seed = torch.where(
                res.ok & (res.rho > -1.0), res.rho,
                torch.full_like(res.rho, -1.0),
            )
    with _phase(timer, "ecc full-res solve"):
        return _solve_lanes(
            templates, input_image, motion_type, num_iters, eps,
            gauss_filt_size, init, rho_seed, input_mask, mode,
            rescue=mode != "forward", timer=timer,
        )


class _Carry(NamedTuple):
    """The solve carry: OpenCV's (m, rho, last_rho, it, ok) per lane, and
    for 'lazy' / 'ic' the carried Gram [B,P,P] and ``h_ok`` [B] (the
    lane's Gram is computed)."""

    m: torch.Tensor
    rho: torch.Tensor
    last_rho: torch.Tensor
    it: torch.Tensor
    ok: torch.Tensor
    gram: torch.Tensor
    h_ok: torch.Tensor


def _solve_lanes(
    templates: torch.Tensor,
    input_image: torch.Tensor,
    motion_type: MotionType,
    num_iters: int,
    eps: float,
    gauss_filt_size: int,
    warp_init: Optional[torch.Tensor],
    rho_init: Optional[torch.Tensor],
    input_mask: Optional[torch.Tensor] = None,
    mode: str = "forward",
    rescue: bool = False,
    timer=None,
) -> EccResult:
    """One resolution's solve: template prep, carry, masked GN loop, and
    with ``rescue`` the forward re-solve of the lanes an 'ic' / 'lazy'
    solve failed; ``timer`` records their spans."""
    n, h, w = templates.shape
    dev = templates.device
    rows = 3 if motion_type == MotionType.Homography else 2
    if n == 0:
        return EccResult(
            rho=torch.zeros((0,), dtype=torch.float32, device=dev),
            warp_matrix=torch.zeros((0, rows, 3), dtype=torch.float32,
                                    device=dev),
            ok=torch.zeros((0,), dtype=torch.bool, device=dev),
            num_iters=torch.zeros((0,), dtype=torch.int32, device=dev),
        )
    with _span(timer, "ecc.prep"):
        if input_mask is None:
            srcs = torch.stack(_input_fields(input_image, gauss_filt_size))
        else:
            srcs = _prepare_masked_input(input_image, input_mask,
                                         gauss_filt_size)
        srcs = srcs.contiguous()
        # B1 reads the planes as interleaved texels: pack once per level
        texels = ecc_cuda.pack_texels(srcs) if srcs.is_cuda else None
        templates_f = ecc_cuda.gaussian_prefilter(
            templates.to(torch.float32).contiguous(), gauss_filt_size
        )

        if warp_init is None:
            m = identity_warp(motion_type, dev).repeat(n, 1, 1)
        else:
            m = warp_init.to(device=dev, dtype=torch.float32).clone()
        rho = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
        last_rho = torch.zeros((n,), dtype=torch.float32, device=dev)
        if rho_init is not None and eps > 0 and mode != "ic":
            # seeded lanes: rho = octave rho, last_rho 2*eps below it so the
            # first iteration always runs (the -eps shift below applies to
            # both); unseeded lanes keep the (-1, -eps) cold start
            r0 = rho_init.to(torch.float32)
            valid = r0 > -1.0
            rho = torch.where(valid, r0, rho)
            last_rho = torch.where(valid, r0 - eps, last_rho)
        p = motion_type.num_params
        st = _Carry(
            m=m, rho=rho, last_rho=last_rho - eps,
            it=torch.zeros((n,), dtype=torch.int32, device=dev),
            ok=torch.ones((n,), dtype=torch.bool, device=dev),
            gram=torch.zeros((n, p, p), dtype=torch.float32, device=dev),
            h_ok=torch.zeros((n,), dtype=torch.bool, device=dev),
        )
    st = _drive(srcs, texels, templates_f, st, motion_type, num_iters, eps,
                mode, timer)
    if rescue and mode != "forward":
        bad = ~st.ok
        if bool(bad.any()):
            # _reactivate_carry on the failed lanes, restarted from their
            # ORIGINAL init: a lane the 'ic' guard froze holds a
            # mid-divergence iterate (ecc.py:1517-1526)
            cuda_build.count(globals(), "rescued_lane_count",
                             int(bad.sum()))
            with _span(timer, "ecc.rescue"):
                st = _Carry(
                    m=torch.where(bad[:, None, None], m, st.m),
                    rho=torch.where(bad, -1.0, st.rho),
                    last_rho=torch.where(bad, -float(eps), st.last_rho),
                    it=torch.where(bad, 0, st.it),
                    ok=st.ok | bad,
                    gram=st.gram,
                    h_ok=st.h_ok & ~bad,
                )
                st = _drive(srcs, texels, templates_f, st, motion_type,
                            num_iters, eps, "forward", timer)
    return EccResult(rho=st.rho, warp_matrix=st.m, ok=st.ok,
                     num_iters=st.it)


def _drive(srcs, texels, templates_f, st: _Carry, motion_type: MotionType,
           num_iters: int, eps: float, mode: str, timer=None) -> _Carry:
    """Iterate until no lane is active, checking on the host every
    ``_CHUNK_ITERS`` iterations: one ``ecc.check`` span a check, one
    ``ecc.sweep`` span an iteration."""

    def active_lanes(c):
        return (c.it < num_iters) & ((c.rho - c.last_rho).abs() >= eps) & c.ok

    # 'lazy' / 'ic': the JAX package computes the Gram when any active
    # lane lacks one (lax.cond on need_h = active & ~h_ok).  A lane
    # inactive once stays inactive, so every lane that ever runs is
    # active on the first iteration and gets its Gram there: only that
    # sweep needs the Gram form, which the host knows without a sync.
    with_gram = mode != "forward"
    while True:
        with _span(timer, "ecc.check"):
            if not bool(active_lanes(st).any()):
                return st
        for _ in range(_CHUNK_ITERS):
            with _span(timer, "ecc.sweep"):
                st = _iterate(srcs, texels, templates_f, st,
                              active_lanes(st), motion_type, mode, eps,
                              with_gram)
            with_gram = False


def _iterate(srcs, texels, templates_f, st: _Carry, active,
             motion_type: MotionType, mode: str, eps: float,
             with_gram: bool) -> _Carry:
    """One masked Gauss-Newton iteration over every lane (the reference's
    ``iter_body``: the fused-moments branch for 'forward' and 'lazy',
    the IC branch for 'ic')."""
    perspective = motion_type == MotionType.Homography
    m3 = _as_3x3(st.m).contiguous()
    kw = dict(quant_affine=not perspective, active=active)
    with_hessian = mode == "forward" or with_gram
    if mode == "ic":
        mom = ecc_cuda.ecc_ic_iteration_moments(
            srcs[0], templates_f, m3, motion_type,
            with_hessian=with_hessian, **kw,
        )
    else:
        mom = ecc_cuda.ecc_iteration_moments(
            srcs, templates_f, m3, motion_type, with_hessian=with_hessian,
            texels=texels, **kw,
        )
    (n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti,
     hess_new, j_i, j_m, j_mt) = ecc_cuda.unpack_moments(
        mom, motion_type, with_hessian)
    gram, h_ok = st.gram, st.h_ok
    if mode == "forward":
        hessian = hess_new
    else:
        if hess_new is not None:
            need_h = active & ~h_ok
            gram = torch.where(need_h[:, None, None], hess_new, gram)
        h_ok = h_ok | active
        hessian = gram
    n = torch.clamp(n_raw, min=1.0)
    img_mean = s_mi / n
    img_std = torch.sqrt(torch.clamp(s_mii / n - img_mean**2, min=0.0))
    tmp_mean = s_mt / n
    tmp_std = torch.sqrt(torch.clamp(s_mtt / n - tmp_mean**2, min=0.0))
    img_norm = torch.sqrt(n) * img_std
    tmp_norm = torch.sqrt(n) * tmp_std
    correlation = (
        s_mti - img_mean * s_mt - tmp_mean * s_mi
        + tmp_mean * img_mean * n_raw
    )
    image_proj = j_i - img_mean[:, None] * j_m
    template_proj = j_mt - tmp_mean[:, None] * j_m

    # inactive lanes carry zero moments (singular H): inv_ex reports
    # instead of raising, and their results are masked out below
    hessian_inv, _ = torch.linalg.inv_ex(hessian)
    new_rho = correlation / (img_norm * tmp_norm)
    if mode == "ic":
        # role-swapped update: the template is the moving image
        tph = (hessian_inv @ template_proj[..., None])[..., 0]
        lambda_n = tmp_norm**2 - (template_proj * tph).sum(dim=1)
        lambda_d = correlation - (image_proj * tph).sum(dim=1)
    else:
        iph = (hessian_inv @ image_proj[..., None])[..., 0]
        lambda_n = img_norm**2 - (image_proj * iph).sum(dim=1)
        lambda_d = correlation - (template_proj * iph).sum(dim=1)
    failed = torch.isnan(new_rho) | (lambda_d <= 0.0)
    if mode == "ic":
        # rho-monotonicity guard: the frozen template Gram blunts the
        # lambda_d test on diverging lanes (ecc.py:685-697)
        failed = failed | ((st.it > 0) & (
            new_rho < st.rho - max(eps, _IC_GUARD_FLOOR)))
    lam = lambda_n / torch.where(
        lambda_d == 0.0, torch.ones_like(lambda_d), lambda_d
    )
    if mode == "ic":
        error_proj = lam[:, None] * image_proj - template_proj
        dp = (hessian_inv @ error_proj[..., None])[..., 0]
        new_m = _compose_warp_ic(motion_type, st.m, dp)
    else:
        # err = lam * template_zm - image_zm: its Jacobian projection is
        # the same linear combination of the projections
        error_proj = lam[:, None] * template_proj - image_proj
        dp = (hessian_inv @ error_proj[..., None])[..., 0]
        new_m = _update_warp(motion_type, st.m, dp)
    new_m = torch.where(failed[:, None, None], st.m, new_m)

    upd = (active & ~failed)[:, None, None]
    minus_one = torch.full_like(st.rho, -1.0)
    return _Carry(
        m=torch.where(upd, new_m, st.m),
        rho=torch.where(active, torch.where(failed, minus_one, new_rho),
                        st.rho),
        last_rho=torch.where(active, st.rho, st.last_rho),
        it=torch.where(active, st.it + 1, st.it),
        ok=st.ok & ~(active & failed),
        gram=gram,
        h_ok=h_ok,
    )
