"""Batched phase correlation — the warm start of the ECC solve.

Counterpart of ``libstacker_tpu/ops/phasecorr.py`` (``_hann2d`` :40,
``_parabolic`` :51, ``_auto_downscale`` :60, ``_pool`` :72,
``phase_correlate_batched`` :85, ``_bilinear_sample`` :140,
``_logpolar_magnitude`` :165, ``phase_correlate_rotscale`` :195, the
gates :280-281, ``phase_init_warps`` :287).  ``torch.fft`` stands where
``jnp.fft`` stood; the log-polar resampling is a plain gather on the
burst's device (no kernel: a few tens of thousands of samples).

For ``a(x) = b(x + t)`` the normalised cross-power spectrum of (A, B)
inverse-transforms to a peak at ``-t`` (wrapped); with ECC's convention
(template = current frame, input = frame 0) the warp translation is
``t``.
"""

from __future__ import annotations

import math

import torch

from ..params import MotionType

# peak response below this is noise: keep the identity init
_MIN_RESPONSE = 0.05
# rotation/scale start gates: a log-polar response below this, or a
# scale change beyond exp(+-_MAX_LOG_SCALE) (~1.4x, far beyond any
# handheld burst), keeps the translation-only start
_MIN_RS_RESPONSE = 0.10
_MAX_LOG_SCALE = 0.35


def _hann2d(h: int, w: int, device) -> torch.Tensor:
    """Separable Hann window (cv2 createHanningWindow semantics)."""
    ay = torch.arange(h, dtype=torch.float32, device=device)
    ax = torch.arange(w, dtype=torch.float32, device=device)
    wy = 0.5 - 0.5 * torch.cos(2.0 * math.pi * ay / (h - 1))
    wx = 0.5 - 0.5 * torch.cos(2.0 * math.pi * ax / (w - 1))
    return wy[:, None] * wx[None, :]


def _parabolic(c_m1, c_0, c_p1):
    """3-point parabola vertex offset in [-0.5, 0.5]."""
    den = c_m1 - 2.0 * c_0 + c_p1
    off = torch.where(
        den.abs() > 1e-12, 0.5 * (c_m1 - c_p1) / den, torch.zeros_like(den)
    )
    return off.clamp(-0.5, 0.5)


def _auto_downscale(h: int, w: int) -> int:
    """Smallest power-of-2 pooling factor that brings the correlation
    grid under ~0.6 Mpx (a 4K burst pools 4x)."""
    d = 1
    while (h // d) * (w // d) > 600_000 and min(h, w) // (2 * d) >= 64:
        d *= 2
    return d


def _pool(x: torch.Tensor, d: int) -> torch.Tensor:
    """d x d average pooling (trailing rows/cols beyond a multiple of d
    are cropped)."""
    if d == 1:
        return x
    h, w = x.shape[-2], x.shape[-1]
    hc, wc = (h // d) * d, (w // d) * d
    x = x[..., :hc, :wc]
    x = x.reshape(*x.shape[:-2], hc // d, d, wc // d, d)
    return x.mean(dim=(-3, -1))


def phase_correlate_batched(
    templates: torch.Tensor,  # [N,H,W] float32 (current frames' grey)
    input_image: torch.Tensor,  # [H,W] float32 (reference grey)
    window: bool = True,
    downscale: int = 1,
):
    """Per-frame translation ``t`` ([N,2], (tx, ty) in full-resolution
    pixels) with ``templates[i](x) ≈ input_image(x + t_i)``, and the
    normalised correlation peak height ``response`` [N]."""
    n = templates.shape[0]
    a = _pool(templates.to(torch.float32), downscale)
    b = _pool(input_image.to(torch.float32), downscale)
    h, w = a.shape[-2], a.shape[-1]
    if window:
        win = _hann2d(h, w, a.device)
        a = a * win
        b = b * win
    fa = torch.fft.rfft2(a)
    fb = torch.fft.rfft2(b)
    cross = fa * torch.conj(fb)[None]
    cross = cross / torch.clamp(cross.abs(), min=1e-12)
    r = torch.fft.irfft2(cross, s=(h, w))  # [N,H,W], peak at -t

    flat = r.reshape(n, h * w)
    idx = torch.argmax(flat, dim=1)
    py = idx // w
    px = idx % w
    resp = flat.gather(1, idx[:, None])[:, 0]

    def at(dy, dx):
        yy = torch.remainder(py + dy, h)
        xx = torch.remainder(px + dx, w)
        return flat.gather(1, (yy * w + xx)[:, None])[:, 0]

    sub_y = _parabolic(at(-1, 0), resp, at(1, 0))
    sub_x = _parabolic(at(0, -1), resp, at(0, 1))
    fy = py.to(torch.float32) + sub_y
    fx = px.to(torch.float32) + sub_x
    ty = -torch.where(fy > h / 2.0, fy - h, fy) * downscale
    tx = -torch.where(fx > w / 2.0, fx - w, fx) * downscale
    return torch.stack([tx, ty], dim=1), resp


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample each image of ``img`` [B,H,W] at float coordinates
    ``ys``, ``xs`` ([B,P,Q], or [P,Q] shared by every image), zero
    outside -> [B,P,Q]."""
    b, h, w = img.shape
    flat = img.reshape(b, h * w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    rows = b if ys.ndim == 3 else 1  # per-image or shared coordinates
    out_shape = (b,) + tuple(ys.shape[-2:])

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = flat.gather(1, idx.reshape(rows, -1).expand(b, -1))
        v = v.reshape(out_shape)
        return torch.where(ok, v, torch.zeros_like(v))

    return (
        tap(y0i, x0i) * (1 - fy) * (1 - fx)
        + tap(y0i, x0i + 1) * (1 - fy) * fx
        + tap(y0i + 1, x0i) * fy * (1 - fx)
        + tap(y0i + 1, x0i + 1) * fy * fx
    )


def _logpolar_magnitude(x: torch.Tensor, n_theta: int,
                        n_rho: int) -> torch.Tensor:
    """High-pass-filtered FFT magnitude of each image of ``x`` [B,H,W]
    resampled onto a (theta, log-rho) grid -> [B, n_theta, n_rho]: the
    Reddy-Chatterji transform (IEEE TIP 1996), where a rotation of the
    image is a cyclic shift along theta and a uniform scaling a shift
    along log-rho.  Theta spans [0, pi) (the magnitude spectrum is
    pi-periodic)."""
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device
    f = torch.abs(torch.fft.fftshift(torch.fft.fft2(x), dim=(-2, -1)))
    # Reddy-Chatterji high-pass: removes the DC blob that would dominate
    fy = (torch.arange(h, dtype=torch.float32, device=dev) - h // 2) / h
    fx = (torch.arange(w, dtype=torch.float32, device=dev) - w // 2) / w
    cc = torch.cos(math.pi * fy)[:, None] * torch.cos(math.pi * fx)[None, :]
    f = f * (1.0 - cc) * (2.0 - cc)
    cy, cx = h // 2, w // 2
    rho_max = min(h, w) / 2.0 - 1.0
    rho_min = 1.0
    base = (rho_max / rho_min) ** (1.0 / (n_rho - 1))
    rs = rho_min * base ** torch.arange(n_rho, dtype=torch.float32, device=dev)
    ths = math.pi * torch.arange(n_theta, dtype=torch.float32,
                                 device=dev) / n_theta
    ys = cy + rs[None, :] * torch.sin(ths)[:, None]  # [n_theta, n_rho]
    xs = cx + rs[None, :] * torch.cos(ths)[:, None]
    return _bilinear_sample(f, ys, xs)


def phase_correlate_rotscale(
    templates: torch.Tensor,  # [N,H,W] float32
    input_image: torch.Tensor,  # [H,W] float32
    downscale: int = 1,
    n_theta: int = 180,
    n_rho: int = 128,
):
    """Per-frame (rotation, scale) of the linear part of the ECC warp
    (``template(x) ≈ input(W x)``, W = scale * R(theta) about the image
    centre composed with a translation) by log-polar phase correlation
    of the FFT magnitudes, which are blind to the shift.

    Returns ``(theta, scale, response)``: ``theta`` [N] radians in
    (-pi/2, pi/2] (the magnitude spectrum is pi-periodic), ``scale``
    [N], ``response`` [N] the normalised correlation peak height."""
    n = templates.shape[0]
    a = _pool(templates.to(torch.float32), downscale)
    b = _pool(input_image.to(torch.float32), downscale)
    h, w = a.shape[-2], a.shape[-1]
    dev = a.device
    win = _hann2d(h, w, dev)
    lp_a = _logpolar_magnitude(a * win, n_theta, n_rho)
    lp_b = _logpolar_magnitude((b * win)[None], n_theta, n_rho)[0]
    # theta is cyclic (pi-periodic magnitude), log-rho is not: window it
    # so the cyclic correlation's wrap-around does not bias the scale
    wr = 0.5 - 0.5 * torch.cos(
        2.0 * math.pi * torch.arange(n_rho, dtype=torch.float32, device=dev)
        / (n_rho - 1)
    )
    lp_a = lp_a * wr[None, None, :]
    lp_b = lp_b * wr[None, :]

    fa = torch.fft.rfft2(lp_a)
    fb = torch.fft.rfft2(lp_b)
    cross = fa * torch.conj(fb)[None]
    cross = cross / torch.clamp(cross.abs(), min=1e-12)
    r = torch.fft.irfft2(cross, s=(n_theta, n_rho))

    flat = r.reshape(n, n_theta * n_rho)
    idx = torch.argmax(flat, dim=1)
    pt = idx // n_rho
    pr = idx % n_rho
    resp = flat.gather(1, idx[:, None])[:, 0]

    def at(dt, dr):
        tt = torch.remainder(pt + dt, n_theta)
        rr = torch.remainder(pr + dr, n_rho)
        return flat.gather(1, (tt * n_rho + rr)[:, None])[:, 0]

    sub_t = _parabolic(at(-1, 0), resp, at(1, 0))
    sub_r = _parabolic(at(0, -1), resp, at(0, 1))
    ft = pt.to(torch.float32) + sub_t
    fr = pr.to(torch.float32) + sub_r
    # a peak at p encodes a cyclic shift of -delta: unwrap both axes
    # about zero (burst scale changes are tiny)
    dth_bins = -torch.where(ft > n_theta / 2.0, ft - n_theta, ft)
    drho_bins = -torch.where(fr > n_rho / 2.0, fr - n_rho, fr)
    rho_max = min(h, w) / 2.0 - 1.0
    base = rho_max ** (1.0 / (n_rho - 1))
    # rotating the image rotates |F| the same way; scaling it by s
    # scales |F| by 1/s, hence the sign flip on the log-rho axis only
    theta = dth_bins * (math.pi / n_theta)
    scale = base ** (-drho_bins)
    theta = torch.where(theta > math.pi / 2, theta - math.pi, theta)
    theta = torch.where(theta <= -math.pi / 2, theta + math.pi, theta)
    return theta, scale, resp


def _translation_start(templates, input_image, window, ds):
    """Phase-correlation shifts ``[N,2]``, zero where the response is
    below ``_MIN_RESPONSE`` or the estimate is not finite."""
    t, resp = phase_correlate_batched(templates, input_image, window=window,
                                      downscale=ds)
    good = (resp >= _MIN_RESPONSE) & torch.isfinite(t).all(dim=1)
    return torch.where(good[:, None], t, torch.zeros_like(t))


def phase_init_warps(
    templates: torch.Tensor,  # [N,H,W] float32
    input_image: torch.Tensor,  # [H,W] float32
    motion_type: MotionType = MotionType.Affine,
    window: bool = True,
    rotation: bool = False,
) -> torch.Tensor:
    """Identity warps with the phase-correlation translation filled in,
    shaped for ``ops/ecc.find_transform_ecc_batched``'s ``warp_init``
    ([N,2,3], or [N,3,3] for Homography).  Low-response lanes keep the
    identity.

    ``rotation=True`` first recovers each frame's rotation (and, for
    Affine and Homography, its uniform scale) by
    :func:`phase_correlate_rotscale`, measures the translation on the
    de-rotated template, and composes ``W = T(t) @ A_c`` (``A_c`` = scale
    * R(theta) about the image centre).  Translation ignores it, as the
    JAX package does."""
    n, h, w = templates.shape
    dev = templates.device
    ds = _auto_downscale(h, w)
    rows = 3 if motion_type == MotionType.Homography else 2
    init = torch.eye(3, dtype=torch.float32, device=dev)[:rows]
    init = init.repeat(n, 1, 1)
    if not rotation or motion_type == MotionType.Translation:
        t = _translation_start(templates, input_image, window, ds)
        init[:, 0, 2] = t[:, 0]
        init[:, 1, 2] = t[:, 1]
        return init

    theta, scale, resp_rs = phase_correlate_rotscale(
        templates, input_image, downscale=ds,
    )
    if motion_type == MotionType.Euclidean:
        scale = torch.ones_like(scale)  # rigid motion cannot scale
    good_rs = (
        (resp_rs >= _MIN_RS_RESPONSE)
        & torch.isfinite(theta)
        & torch.isfinite(scale)
        & (torch.log(torch.clamp(scale, min=1e-6)).abs() <= _MAX_LOG_SCALE)
    )
    theta = torch.where(good_rs, theta, torch.zeros_like(theta))
    scale = torch.where(good_rs, scale, torch.ones_like(scale))

    # A_c = scale * R(theta) about the image centre, in W's inverse-map
    # convention (template grid -> input coordinates)
    c, s = torch.cos(theta), torch.sin(theta)
    a00 = scale * c
    a01 = -scale * s
    a10 = scale * s
    a11 = scale * c
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    atx = cx - (a00 * cx + a01 * cy)
    aty = cy - (a10 * cx + a11 * cy)

    # translation pass on the de-rotated templates, on the pooled grid:
    # tp_d(x) = tp(A_c^-1 x) = input(x + t), a pure shift
    tp = _pool(templates.to(torch.float32), ds)
    ip = _pool(input_image.to(torch.float32), ds)
    ph, pw = tp.shape[-2], tp.shape[-1]
    pcx, pcy = (pw - 1) / 2.0, (ph - 1) / 2.0
    yy = (torch.arange(ph, dtype=torch.float32, device=dev)[:, None]
          * torch.ones((1, pw), device=dev))
    xx = (torch.arange(pw, dtype=torch.float32, device=dev)[None, :]
          * torch.ones((ph, 1), device=dev))
    det = a00 * a11 - a01 * a10
    i00, i01 = a11 / det, -a01 / det
    i10, i11 = -a10 / det, a00 / det
    lane = (slice(None), None, None)
    tp_d = _bilinear_sample(
        tp,
        i10[lane] * (xx - pcx) + i11[lane] * (yy - pcy) + pcy,
        i00[lane] * (xx - pcx) + i01[lane] * (yy - pcy) + pcx,
    )
    t = _translation_start(tp_d, ip, window, 1) * ds

    # W = T(t) @ A_c: template(x) = tp_d_full(A_c x) ≈ input(A_c x + t)
    init[:, 0, 0] = a00
    init[:, 0, 1] = a01
    init[:, 1, 0] = a10
    init[:, 1, 1] = a11
    init[:, 0, 2] = atx + t[:, 0]
    init[:, 1, 2] = aty + t[:, 1]
    return init
