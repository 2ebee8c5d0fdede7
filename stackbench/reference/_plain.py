"""Plain PyTorch building blocks of the references: grey, INTER_AREA,
filters, a patch phase-correlation start, OpenCV's forward-additive ECC
for homographies, the warp-and-sum stack and the four sharpness
metrics.

Written from the published algorithms (OpenCV ``findTransformECC``,
``warpPerspective``, ``resize(INTER_AREA)``, ``cvtColor``, the
upstream crate's sharpness functions), not from the port: nothing here
imports ``libstacker_tpu_torch``, ``libstacker_tpu`` or ``jax``.  Every
pixel-valued array is computed in ``dtype`` (float32 for a reference,
bfloat16 for the lower-precision control, which also holds the warps
and the sums in it); the pixel grid's coordinates and the 8x8 solve
stay in float32 / float64, since a bfloat16 coordinate cannot name a
pixel of a 4K frame and the solver has no bfloat16 form.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# OpenCV getGaussianKernel(5, 0): the fixed binomial table
_GAUSS5 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
_GAUSS3 = (0.25, 0.5, 0.25)


def no_tf32():
    """float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def grey(frames_u8: torch.Tensor) -> torch.Tensor:
    """``cvtColor(RGB2GRAY)`` of ``[N,H,W,3]`` u8: Rec.601 luma rounded
    to u8 (float64 weights, half to even)."""
    out = []
    for s in range(0, frames_u8.shape[0], 8):
        x = frames_u8[s : s + 8].to(torch.float64)
        y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        out.append(torch.clamp(torch.round(y), 0, 255).to(torch.uint8))
    return torch.cat(out)


def area_matrix(src: int, dst: int, device) -> torch.Tensor:
    """``[dst, src]`` float64 INTER_AREA weights: each output cell
    averages the source cells it overlaps, by overlap."""
    scale = src / dst
    w = np.zeros((dst, src))
    for i in range(dst):
        f0, f1 = i * scale, min((i + 1) * scale, float(src))
        for j in range(int(math.floor(f0)), min(int(math.ceil(f1)), src)):
            ov = min(j + 1.0, f1) - max(float(j), f0)
            if ov > 0:
                w[i, j] = ov / scale
    return torch.from_numpy(w).to(device)


def scaled_size(h: int, w: int, scale_down: float):
    """The upstream's ``scale_image`` size: the smaller side becomes
    ``scale_down`` (truncating casts, src/utils.rs:192-199)."""
    f = float(scale_down) / float(min(h, w))
    return int(h * f), int(w * f)


def area_resize_u8(g: torch.Tensor, hw) -> torch.Tensor:
    """INTER_AREA of ``[N,H,W]`` u8 to ``hw``, rounded back to u8."""
    ay = area_matrix(g.shape[-2], hw[0], g.device)
    ax = area_matrix(g.shape[-1], hw[1], g.device)
    out = torch.einsum("yh,nhw,xw->nyx", ay, g.to(torch.float64), ax)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def sep_filter(x: torch.Tensor, kx, ky, border: str = "reflect101"):
    """Correlate ``[N,H,W]`` with ``kx`` along W and ``ky`` along H
    (``reflect101``: OpenCV's default border, or ``replicate``)."""
    rx, ry = len(kx) // 2, len(ky) // 2
    mode = "reflect" if border == "reflect101" else "replicate"
    p = F.pad(x[:, None], (rx, rx, ry, ry), mode=mode)[:, 0]
    h, w = x.shape[-2:]
    rows = sum(p[:, :, j : j + w] * c for j, c in enumerate(kx) if c != 0)
    return sum(rows[:, i : i + h] * c for i, c in enumerate(ky) if c != 0)


def blur5(x: torch.Tensor) -> torch.Tensor:
    return sep_filter(x, _GAUSS5, _GAUSS5)


def gradients(x: torch.Tensor):
    """ECC's input gradients: [-0.5, 0, 0.5] along each axis."""
    d = (-0.5, 0.0, 0.5)
    return sep_filter(x, d, (1.0,)), sep_filter(x, (1.0,), d)


# --- the start: phase correlation of a 3x3 grid of patches ------------


def _patch_starts(n: int, p: int):
    return [int(round(c)) for c in np.linspace(0, n - p, 3)]


def phase_start(templates: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """``[B,3,3]`` float64 affine starts with ``template(x) ~ image(A x)``:
    the shift of each of 9 patches by phase correlation (parabolic
    sub-pixel peak), then the least-squares affine through them."""
    b, h, w = templates.shape
    p = 1 << int(math.floor(math.log2(min(h, w) / 3)))
    p = min(p, 256)
    win = torch.hann_window(p, periodic=False, dtype=torch.float32,
                            device=image.device)
    win = win[:, None] * win[None, :]
    ys, xs = _patch_starts(h, p), _patch_starts(w, p)
    src, dst = [], []
    t_patches, i_patches = [], []
    for y0 in ys:
        for x0 in xs:
            t_patches.append(templates[:, y0 : y0 + p, x0 : x0 + p])
            i_patches.append(image[y0 : y0 + p, x0 : x0 + p])
            src.append((x0 + (p - 1) / 2.0, y0 + (p - 1) / 2.0))
    tp = torch.stack(t_patches, 1).to(torch.float32)  # [B,9,p,p]
    ip = torch.stack(i_patches, 0).to(torch.float32)[None]  # [1,9,p,p]
    tp = (tp - tp.mean((-2, -1), keepdim=True)) * win
    ip = (ip - ip.mean((-2, -1), keepdim=True)) * win
    cross = torch.fft.fft2(ip) * torch.conj(torch.fft.fft2(tp))
    cross = cross / torch.clamp(cross.abs(), min=1e-12)
    corr = torch.fft.ifft2(cross).real  # peak at image - template shift
    flat = corr.reshape(b, 9, -1)
    k = flat.argmax(-1)
    py, px = k // p, k % p

    def sub(c0, cm, cp):
        den = cm - 2 * c0 + cp
        return torch.where(den.abs() > 1e-12, 0.5 * (cm - cp) / den,
                           torch.zeros_like(den))

    def at(dy, dx):
        idx = ((py + dy) % p) * p + (px + dx) % p
        return torch.gather(flat, 2, idx[..., None])[..., 0]

    c0 = at(0, 0)
    sx = px.double() + sub(c0, at(0, -1), at(0, 1)).double()
    sy = py.double() + sub(c0, at(-1, 0), at(1, 0)).double()
    sx = torch.where(sx > p / 2, sx - p, sx)
    sy = torch.where(sy > p / 2, sy - p, sy)
    s = torch.tensor(src, dtype=torch.float64, device=image.device)  # [9,2]
    a = torch.cat([s, torch.ones(9, 1, dtype=torch.float64,
                                 device=image.device)], 1)  # [9,3]
    d = s[None] + torch.stack([sx, sy], -1)  # [B,9,2]
    sol = torch.linalg.lstsq(a[None].expand(b, -1, -1), d).solution  # [B,3,2]
    out = torch.zeros(b, 3, 3, dtype=torch.float64, device=image.device)
    out[:, :2, :] = sol.transpose(1, 2)
    out[:, 2, 2] = 1.0
    return out


# --- ECC (OpenCV findTransformECC, MOTION_HOMOGRAPHY) -----------------


def _sample3(fields: torch.Tensor, xw: torch.Tensor, yw: torch.Tensor):
    """Bilinear samples of ``fields`` [3,H,W] at ``(xw, yw)`` [B,H,W]
    (zero outside: BORDER_CONSTANT 0) -> [B,3,H,W]."""
    _, h, w = fields.shape
    grid = torch.stack([xw * (2.0 / (w - 1)) - 1.0,
                        yw * (2.0 / (h - 1)) - 1.0], -1)
    # the taps' values are ``fields``' own; the coordinates and weights
    # stay float32
    src = fields.to(torch.float32)[None].expand(xw.shape[0], -1, -1, -1)
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.to(fields.dtype)


def ecc_homography(templates: torch.Tensor, image: torch.Tensor,
                   init: torch.Tensor, dtype=torch.float32,
                   max_iters: int = 30, tol_px: float = 2e-3,
                   block: int = 16):
    """Solve ``template_b(x) ~ image(W_b x)`` for every template to
    convergence: a lane stops when an update moves no corner of the
    frame by ``tol_px`` or more, or after ``max_iters``.  Both images
    are Gaussian-prefiltered (5x5) as ``findTransformECC(...,
    gaussFiltSize=5)`` does.  Up to ``block`` unfinished lanes step
    together.

    Returns ``(warps [B,3,3] float64, ok [B] bool, iters [B])``; a lane
    fails as OpenCV's does (NaN correlation, non-positive lambda
    denominator)."""
    dev = image.device
    h, w = image.shape
    img = blur5(image[None].to(dtype))[0]
    gx, gy = gradients(img[None])
    fields = torch.stack([img, gx[0], gy[0]])
    del img, gx, gy
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    corners = torch.tensor([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                            [w - 1, h - 1, 1]], dtype=torch.float64,
                           device=dev)
    nb = templates.shape[0]
    tmpl_all = torch.cat([blur5(templates[s : s + block].to(dtype))
                          for s in range(0, nb, block)])
    m = _held(init.to(torch.float64), dtype)
    ok = torch.ones(nb, dtype=torch.bool, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    it = torch.zeros(nb, dtype=torch.int64, device=dev)
    while True:
        idx = torch.nonzero(~done).flatten()[:block]
        if idx.numel() == 0:
            break
        dp, bad = _ecc_step(tmpl_all[idx], fields, m[idx], xs, ys, dtype)
        upd = torch.zeros_like(m[idx])
        upd[:, 0, 0], upd[:, 1, 0], upd[:, 2, 0] = dp[:, 0], dp[:, 1], dp[:, 2]
        upd[:, 0, 1], upd[:, 1, 1], upd[:, 2, 1] = dp[:, 3], dp[:, 4], dp[:, 5]
        upd[:, 0, 2], upd[:, 1, 2] = dp[:, 6], dp[:, 7]
        upd = torch.where(bad[:, None, None], torch.zeros_like(upd), upd)
        new = _held(m[idx] + upd, dtype)
        move = corner_gap(new, m[idx], corners)
        m[idx] = new
        it[idx] += (~bad).to(torch.int64)
        ok[idx] = ok[idx] & ~bad
        done[idx] = bad | (move < tol_px) | (it[idx] >= max_iters)
    return m, ok, it


def _ecc_step(tmpl, fields, m, xs, ys, dtype):
    """One forward-additive ECC update of lanes ``m`` ([B,3,3] float64):
    ``(dp [B,8] float64 in OpenCV's parameter order, bad [B])``."""
    bsz = tmpl.shape[0]
    h, w = tmpl.shape[-2:]
    m32 = m.to(torch.float32)

    def row(r):
        return (m32[:, r, 0, None, None] * xs + m32[:, r, 1, None, None] * ys
                + m32[:, r, 2, None, None])

    den = row(2)
    xw, yw = row(0) / den, row(1) / den
    smp = _sample3(fields, xw, yw)
    iw, gxw, gyw = smp[:, 0], smp[:, 1], smp[:, 2]
    xr, yr = torch.round(xw), torch.round(yw)
    mask = (xr >= 0) & (xr <= w - 1) & (yr >= 0) & (yr <= h - 1)
    cnt = mask.sum((-2, -1)).to(torch.float64)
    mk = mask.to(dtype)
    tmean = (tmpl * mk).sum((-2, -1)).double() / cnt
    imean = (iw * mk).sum((-2, -1)).double() / cnt
    tz = (tmpl - tmean.to(dtype)[:, None, None]) * mk
    iz = (iw - imean.to(dtype)[:, None, None]) * mk
    inv_den = (1.0 / den).to(dtype)
    xw_d, yw_d = xw.to(dtype), yw.to(dtype)
    gxd, gyd = gxw * inv_den, gyw * inv_den
    tmp = -(gxd * xw_d + gyd * yw_d)
    xd, yd = xs.to(dtype), ys.to(dtype)
    jac = torch.stack([gxd * xd, gyd * xd, tmp * xd, gxd * yd,
                       gyd * yd, tmp * yd, gxd, gyd], 1).reshape(bsz, 8, -1)
    del smp, gxw, gyw, gxd, gyd, tmp, xw, yw, den
    # float32 sums in float64; the control's in its own type
    acc = torch.float64 if dtype == torch.float32 else dtype
    ja = jac.to(acc)
    del jac
    hess = (ja @ ja.transpose(1, 2)).double()
    tzf = tz.reshape(bsz, -1, 1).to(acc)
    izf = iz.reshape(bsz, -1, 1).to(acc)
    tproj = (ja @ tzf)[..., 0].double()
    iproj = (ja @ izf)[..., 0].double()
    del ja
    corr = (tzf * izf).sum((1, 2)).double()
    inorm2 = (izf * izf).sum((1, 2)).double()
    tnorm2 = (tzf * tzf).sum((1, 2)).double()
    rho = corr / torch.sqrt(inorm2 * tnorm2)
    hinv = torch.linalg.inv(hess)
    ih = (hinv @ iproj[..., None])[..., 0]
    lam_n = inorm2 - (iproj * ih).sum(-1)
    lam_d = corr - (tproj * ih).sum(-1)
    bad = torch.isnan(rho) | (lam_d <= 0)
    lam = lam_n / lam_d
    eproj = lam[:, None] * tproj - iproj
    dp = (hinv @ eproj[..., None])[..., 0]
    return dp, bad


def _held(m: torch.Tensor, dtype) -> torch.Tensor:
    """The warp as the solve stores it: float64 for a float32 solve,
    rounded to ``dtype`` for a lower one."""
    return m.clone() if dtype == torch.float32 else m.to(dtype).to(torch.float64)


def corner_gap(a: torch.Tensor, b: torch.Tensor, pts: torch.Tensor):
    """Largest distance in px between where ``a`` and ``b`` ([B,3,3])
    send the points ``pts`` ([K,3] homogeneous)."""
    pa = torch.einsum("bij,kj->bki", a.to(torch.float64), pts)
    pb = torch.einsum("bij,kj->bki", b.to(torch.float64), pts)
    pa = pa[..., :2] / pa[..., 2:]
    pb = pb[..., :2] / pb[..., 2:]
    return (pa - pb).norm(dim=-1).amax(-1)


def grid_points(h: int, w: int, n: int = 9, device="cpu") -> torch.Tensor:
    """``[n*n, 3]`` homogeneous points on an even grid over the frame."""
    gy = torch.linspace(0, h - 1, n, dtype=torch.float64, device=device)
    gx = torch.linspace(0, w - 1, n, dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(gy, gx, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1),
                        torch.ones(n * n, dtype=torch.float64,
                                   device=device)], 1)


def rescale_warps(warps: torch.Tensor, small_hw, full_hw) -> torch.Tensor:
    """The upstream's rescale of a warp solved on scaled frames
    (src/lib.rs:941-958): the translation column times full/small, the
    perspective row divided by it."""
    sx = full_hw[1] / small_hw[1]
    sy = full_hw[0] / small_hw[0]
    out = warps.clone()
    out[:, 0, 2] *= sx
    out[:, 1, 2] *= sy
    out[:, 2, 0] /= sx
    out[:, 2, 1] /= sy
    return out


# --- the stack --------------------------------------------------------


def warp_sum(frames_u8: torch.Tensor, warps: torch.Tensor, keep: torch.Tensor,
             dtype=torch.float32, block: int = 4) -> torch.Tensor:
    """``sum_i warpPerspective(frame_i / 255, W_i)`` over the kept frames
    (``[N,H,W,3]`` u8, ``W_i`` [N,3,3] forward maps onto frame 0's grid):
    INTER_LINEAR with OpenCV's 1/32-px weights, BORDER_CONSTANT 0,
    summed in ``dtype``."""
    n, h, w, _ = frames_u8.shape
    dev = frames_u8.device
    ys = torch.arange(h, dtype=torch.float64, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
    total = torch.zeros((h, w, 3), dtype=dtype, device=dev)
    minv = torch.linalg.inv(warps.to(torch.float64))
    idx = [i for i in range(n) if bool(keep[i])]
    for s in range(0, len(idx), block):
        for i in idx[s : s + block]:
            mi = minv[i]
            den = mi[2, 0] * xs + mi[2, 1] * ys + mi[2, 2]
            sx = (mi[0, 0] * xs + mi[0, 1] * ys + mi[0, 2]) / den
            sy = (mi[1, 0] * xs + mi[1, 1] * ys + mi[1, 2]) / den
            xq = torch.round(sx * 32.0)
            yq = torch.round(sy * 32.0)
            x0 = torch.floor(xq / 32.0)
            y0 = torch.floor(yq / 32.0)
            fx = ((xq - x0 * 32.0) / 32.0).to(dtype)[..., None]
            fy = ((yq - y0 * 32.0) / 32.0).to(dtype)[..., None]
            x0 = x0.clamp(-2, w + 1).to(torch.int64)
            y0 = y0.clamp(-2, h + 1).to(torch.int64)
            img = frames_u8[i].to(dtype) / 255.0
            zero = torch.zeros((), dtype=dtype, device=dev)

            def tap(yi, xi):
                inside = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
                v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
                return torch.where(inside, v, zero)

            top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
            bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
            total += top * (1 - fy) + bot * fy
    return total


# --- sharpness (the upstream's four metrics, src/lib.rs:1032-1166) ------


def sharpness(grey_u8: torch.Tensor, dtype=torch.float64) -> dict:
    """LAPM, LAPV, TENG and GLVN of each ``[N,H,W]`` u8 frame."""
    out = {"lapm": [], "lapv": [], "teng": [], "glvn": []}
    for i in range(grey_u8.shape[0]):
        x = grey_u8[i : i + 1].to(dtype)
        d2 = (-1.0, 2.0, -1.0)
        lapm = (sep_filter(x, d2, _GAUSS3).abs()
                + sep_filter(x, _GAUSS3, d2).abs()).mean((-2, -1))
        lap = (sep_filter(x, (1.0, -2.0, 1.0), (1.0, 2.0, 1.0), "replicate")
               + sep_filter(x, (1.0, 2.0, 1.0), (1.0, -2.0, 1.0), "replicate"))
        lapv = ((lap - lap.mean((-2, -1), keepdim=True)) ** 2).mean((-2, -1))
        sx = sep_filter(x, (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0))
        sy = sep_filter(x, (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0))
        teng = (sx * sx + sy * sy).mean((-2, -1))
        mu = x.mean((-2, -1))
        glvn = ((x - mu[:, None, None]) ** 2).mean((-2, -1)) / torch.clamp(
            mu, min=2.220446049250313e-16)
        for k, v in (("lapm", lapm), ("lapv", lapv), ("teng", teng),
                     ("glvn", glvn)):
            out[k].append(v.double())
    return {k: torch.cat(v) for k, v in out.items()}
