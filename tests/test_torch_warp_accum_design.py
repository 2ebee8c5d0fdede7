"""What the design of kernels B2 and B4 (``libstacker_tpu_torch/csrc/
warp_accum.cu``) relies on, checked on the CPU in float32 numpy.

- (a) The reciprocal.  A design that computes the homography's
  coordinate with the approximate reciprocal (MUFU.RCP, within 1 ulp of
  ``1/sw``) and takes the correctly rounded one only where a
  certificate fails: the certificate (``s*32`` farther than a relative
  margin from a rounding tie, ``sx``/``sy`` farther than it from
  ``W-1``/``H-1``) is sound against any reciprocal within 2 ulps of
  ``RN(1/sw)``, on near-identity, 30-degree, strongly perspective and
  tie-built maps.  But at 4K the margin (a few ulps of ``s*32``, ~1/64 of
  a bin at ``x`` ~ 3000) fails on ~13 % of pixel-frames, so nearly every
  warp of 128 pixel-frames would run both paths: the kernels keep the
  correctly rounded ``1.0f / sw``.
- (b) The bins off the conversion pipe: ``rint`` by the ``2^23`` add,
  the tap origin by an arithmetic shift, the weight by ORing the low 5
  bits into the mantissa of 2^18, bitwise ``np.rint`` / ``np.floor``
  and the plain version's weight over the range the kernel takes them
  on, ties included, for both quantisations; for negative coordinates
  and outside that range the tap origin is negative (or 0 where the bin
  is 0) or too large for the fast paths' range tests.
- (c) The widening by the exponent OR equals ``float(v)`` for every u8
  and u16 value (measured no faster than ``I2F`` on the card, so the
  kernels convert).
- (d) Several pixels a thread with shared row products give
  ``ops/warp._dst_coords`` bitwise.
- The kernel source itself, compiled for the host with ``g++`` through a
  small CUDA shim (each block's lanes as coroutines that switch at
  ``__syncthreads``), bitwise against the plain versions on small
  frames: ties, coverage edges, ``sw == 0`` rows, widths that are not a
  multiple of a thread's pixels, u8 / u16 / f32, both quantisations.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import rotation_inverse_map  # noqa: E402
from libstacker_tpu_torch.ops import color, warp, warp_accum_cuda  # noqa: E402

f32 = np.float32
MAGIC = f32(8388608.0)  # 2^23
MAGIC_BITS = 0x4B000000
# MUFU.RCP's documented worst error (1 ulp) plus one
RCP_ULPS = 2
# relative bound on the change of s = sx_lin * inv when inv moves by
# RCP_ULPS ulps, with the product's rounding on each side
REL = (2 * RCP_ULPS + 2) * 2.0 ** -23
H4K, W4K = 2160, 3840


def _quant(s: np.ndarray, perspective: bool) -> np.ndarray:
    """The kernel's bin coordinate q (csrc/warp_accum.cu quant): the
    bits of s*32 + 2^23 (s*1024 for the affine form) less those of 2^23,
    then for affine (q + 16) >> 5, in wrapping 32-bit arithmetic.  s*32
    is exact, so the fused add equals this one."""
    with np.errstate(over="ignore", invalid="ignore"):
        u = (s.astype(f32) * f32(32.0 if perspective else 1024.0)) + MAGIC
    q = u.astype(f32).view(np.uint32) - np.uint32(MAGIC_BITS)
    if not perspective:
        q = q + np.uint32(16)
    q = q.view(np.int32)
    return q if perspective else q >> 5


def _frac32(q: np.ndarray) -> np.ndarray:
    """(q & 31) / 32 by the mantissa of 2^18 (csrc/warp_accum.cu frac32)."""
    bits = ((q & 31) | 0x48800000).astype(np.int32)
    return bits.view(f32) - f32(262144.0)


def _plain_bins(s: np.ndarray, perspective: bool):
    """ops/warp.py _sample_bilinear's float bins: (x0f, fx)."""
    s = s.astype(f32)
    if perspective:
        xq = np.rint(s * f32(32.0))
    else:
        xq = np.floor((np.rint(s * f32(1024.0)) + f32(16.0)) / f32(32.0))
    x0f = np.floor(xq * f32(1.0 / 32.0))
    return x0f, (xq - x0f * f32(32.0)) * f32(1.0 / 32.0)


def _ulps(x: np.ndarray, j: int) -> np.ndarray:
    """``x`` moved ``j`` float32 steps."""
    to = f32(np.inf) if j > 0 else f32(-np.inf)
    for _ in range(abs(j)):
        x = np.nextafter(x, to).astype(f32)
    return x


def _coords(m: np.ndarray, ys: np.ndarray, xs: np.ndarray, inv=None):
    """(sx, sy, sw, inv) as the kernel forms them: (m0*x + m1*y) + m2
    left to right in float32, the reciprocal ``inv`` (default
    ``RN(1/sw)``, 0 where sw == 0)."""
    m = m.astype(f32)
    sx = (m[0, 0] * xs + m[0, 1] * ys) + m[0, 2]
    sy = (m[1, 0] * xs + m[1, 1] * ys) + m[1, 2]
    sw = (m[2, 0] * xs + m[2, 1] * ys) + m[2, 2]
    if inv is None:
        with np.errstate(divide="ignore"):
            inv = np.where(sw != 0, f32(1.0) / sw, f32(0.0)).astype(f32)
    return (sx * inv).astype(f32), (sy * inv).astype(f32), sw, inv


def _burst_maps(rng, n=4, h=H4K, w=W4K):
    """Inverse maps like make_burst's truth at 4K (+-0.6 degrees,
    +-6 px) with a small perspective row."""
    out = []
    for _ in range(n):
        deg = rng.uniform(-0.6, 0.6)
        dx, dy = rng.uniform(-6, 6, 2)
        p = tuple(1e-6 * rng.uniform(-1, 1, 2))
        out.append(np.linalg.inv(rotation_inverse_map(h, w, deg, 1.0, dx, dy,
                                                      persp=p)))
    return [m.astype(f32) for m in out]


def _tie_maps(h, w):
    """Maps whose coordinates land on, and a few ulps off, the rint ties
    of s*32 (k + 1/2) and near the coverage edges."""
    maps = []
    for e in (1.0 / 64.0, 3.0 / 64.0):
        for j in (-2, -1, 0, 1, 2):
            t = float(_ulps(np.array([e], f32), j)[0])
            maps.append(np.array([[1, 0, t], [0, 1, -t], [0, 0, 1]], f32))
    maps.append(np.array([[1, 0, 0], [0, 1, 0], [1e-7, -1e-7, 1]], f32))
    scale = (w - 1) / (w - 1 + 1e-3)
    maps.append(np.array([[scale, 0, 0], [0, 1, 0], [0, 0, 1]], f32))
    return maps


def _certified(sx, sy, w, h):
    """The certificate: s*32 farther than REL * |s*32| from a tie, and
    sx / sy farther than REL * |s| from W-1 / H-1 (0 needs none: the sign
    of sx is that of sx_lin * sw whatever the reciprocal's last bits)."""
    ok = np.ones(sx.shape, bool)
    for s, edge in ((sx, w - 1), (sy, h - 1)):
        t = s * f32(32.0)
        with np.errstate(invalid="ignore"):
            tie = np.abs(np.abs(t - np.floor(t)) - 0.5)
            ok &= (tie > np.abs(t) * REL) & (np.abs(s - edge) > np.abs(s) * REL)
        ok &= np.isfinite(t)
    return ok


def _cover(sx, sy, sw, w, h):
    return (sw > f32(1e-6)) & (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)


def _certificate_case(m, h, w, rows):
    """Soundness of the certificate for one map over ``rows``: for every
    reciprocal within RCP_ULPS ulps of RN(1/sw), where the certificate
    passes, the bins and the coverage equal the exact ones.  Returns the
    share of pixel-frames that fail it at the exact reciprocal."""
    ys = rows.astype(f32)[:, None]
    xs = np.arange(w, dtype=f32)[None, :]
    sx, sy, sw, inv = _coords(m, ys, xs)
    want = [_plain_bins(s, True) for s in (sx, sy)]
    want_cov = _cover(sx, sy, sw, w, h)
    fail = None
    for j in range(-RCP_ULPS, RCP_ULPS + 1):
        ax, ay, _, _ = _coords(m, ys, xs, np.where(inv != 0, _ulps(inv, j), inv))
        ok = _certified(ax, ay, w, h)
        for s, (x0f, fx) in zip((ax, ay), want):
            got0, gotf = _plain_bins(s, True)
            assert np.array_equal(got0[ok], x0f[ok])
            assert np.array_equal(gotf[ok], fx[ok])
        assert np.array_equal(_cover(ax, ay, sw, w, h)[ok], want_cov[ok])
        if j == 0:
            fail = float((~ok).mean())
    return fail


@pytest.mark.parametrize("kind", ["burst", "rot30", "strong", "ties"])
def test_reciprocal_certificate_is_sound(kind):
    rng = np.random.default_rng(7)
    h, w = H4K, W4K
    rows = np.arange(0, h, 37)
    maps = {
        "burst": lambda: _burst_maps(rng, 2),
        "rot30": lambda: [rotation_inverse_map(h, w, 30.0, 1.0, 2.5, -1.5)],
        "strong": lambda: [rotation_inverse_map(h, w, 4.0, 1.0, 0, 0,
                                                persp=(2e-5, 1e-5))],
        "ties": lambda: _tie_maps(h, w),
    }[kind]()
    for m in maps:
        share = _certificate_case(m, h, w, rows)
        # the certificate passes somewhere (the check is not vacuous),
        # and fails on the ties
        assert share > 0.0 if kind == "ties" else share < 1.0


def certificate_share(frames: int = 4, row_step: int = 8, seed: int = 3):
    """(share of pixel-frames failing the certificate, share of warps of
    128 pixel-frames -- 32 lanes x 4 pixels -- with none failing) on
    burst-like 4K maps."""
    rng = np.random.default_rng(seed)
    xs = np.arange(W4K, dtype=f32)[None, :]
    ys = np.arange(0, H4K, row_step, dtype=f32)[:, None]
    fails, clean = [], []
    for m in _burst_maps(rng, frames):
        sx, sy, _, _ = _coords(m, ys, xs)
        bad = ~_certified(sx, sy, W4K, H4K)
        fails.append(bad.mean())
        clean.append((~bad.reshape(len(ys), -1, 128).any(axis=2)).mean())
    return float(np.mean(fails)), float(np.mean(clean))


def test_certificate_fails_too_often_at_4k():
    """Why the kernels keep the correctly rounded reciprocal: on burst
    maps at 4K the certificate fails on more than 1 % of pixel-frames,
    and fewer than half the warps would see no failure."""
    fail, clean = certificate_share(frames=2, row_step=16)
    assert fail > 1e-2, fail
    assert clean < 0.5, clean


def _domain_values():
    """s*32 (or s*1024) values over the kernel's range and its negative:
    every multiple of 1/64 in [-2^12, 2^12], ties and their neighbours at
    every power of two and at random integers up to 2^23, and random
    floats."""
    rng = np.random.default_rng(11)
    vals = [np.arange(-(1 << 18), (1 << 18) + 1, dtype=np.int64) / 64.0]
    ks = np.concatenate([
        2.0 ** np.arange(0, 23), 2.0 ** np.arange(0, 24) - 1,
        rng.integers(0, 1 << 23, 20000).astype(np.float64),
    ])
    ks = np.concatenate([ks, -ks - 1])
    for off in (0.0, 0.5, -0.5):
        base = (ks + off).astype(f32)
        for j in (-2, -1, 0, 1, 2):
            vals.append(_ulps(base, j).astype(np.float64))
    vals.append(rng.uniform(-(1 << 23), 1 << 23, 200000))
    t = np.concatenate(vals).astype(f32)
    # (no subnormals: t / 1024 would round them)
    return t[(np.abs(t) < f32(1 << 23)) & ((t == 0) | (np.abs(t) > 1e-30))]


# the fast paths' largest extent (csrc/warp_accum.cu fast_extents)
LIMIT = {True: 1 << 18, False: 1 << 13}


@pytest.mark.parametrize("perspective", [True, False])
def test_magic_bins_equal_rint_and_floor(perspective):
    """On 0 <= s*32 < 2^23 (s*1024 for affine) the integer bins are the
    plain version's; below 0 the range tests reject every bin that is
    not (a tap origin of 0 is the plain version's there)."""
    scale = f32(32.0 if perspective else 1024.0)
    t = _domain_values()
    s = t / scale  # exact: a power of two
    assert np.array_equal(s * scale, t)
    q = _quant(s, perspective)
    x0f, fx = _plain_bins(s, perspective)
    exact = ((q >> 5).astype(f32) == x0f) & (_frac32(q) == fx)
    assert exact[t >= 0].all()
    taken = ((q >> 5) >= 0) & ((q >> 5) < LIMIT[perspective])
    assert exact[taken].all()
    # not vacuous: negative coordinates reach both outcomes
    assert (taken & (t < 0)).any() and (~taken & (t < 0)).any()
    # and the weights are the bins' exact 1/32 steps
    assert np.array_equal(_frac32(np.arange(32)), np.arange(32) / f32(32))


@pytest.mark.parametrize("perspective", [True, False])
def test_far_coordinates_leave_the_fast_range(perspective):
    """Outside the exact range (|s*32| >= 2^23, or |s*1024| for affine),
    infinities and NaNs included, the tap origin q >> 5 is negative or
    at least the fast paths' largest extent (2^18, 2^13 for affine), so
    the range tests send the pixel to the plain expressions."""
    rng = np.random.default_rng(5)
    limit = LIMIT[perspective]
    scale = 32.0 if perspective else 1024.0
    mags = np.concatenate([
        (1 << 23) / scale * (1 + rng.uniform(0, 1, 100000)),
        10.0 ** rng.uniform(0, 38, 100000),
        [(1 << 23) / scale, np.inf, 3.4e38],
    ]).astype(f32)
    with np.errstate(over="ignore"):
        mags = mags[np.abs(mags * f32(scale)) >= f32(1 << 23)]
    s = np.concatenate([mags, -mags, [f32(np.nan), -f32(np.nan)]]).astype(f32)
    x0 = _quant(s, perspective) >> 5
    assert np.all((x0 < 0) | (x0 >= limit))


def test_widening_by_the_exponent():
    for dtype, scale in ((np.uint8, color.U8_SCALE),
                         (np.uint16, color.U16_SCALE)):
        v = np.arange(np.iinfo(dtype).max + 1, dtype=np.uint32)
        wide = (v | np.uint32(0x4B000000)).view(f32) - f32(8388608.0)
        assert np.array_equal(wide, v.astype(f32))
        assert np.array_equal(wide * f32(scale), v.astype(f32) * f32(scale))


@pytest.mark.parametrize("persp", [(0.0, 0.0), (2e-5, -3e-5)])
def test_row_products_equal_dst_coords(persp):
    """Four pixels a thread, x = x0 + 32k, with m1*y, m4*y, m7*y formed
    once per row: bitwise ops/warp._dst_coords (and its reciprocal)."""
    h, w = 45, 301
    m = rotation_inverse_map(h, w, 7.0, 1.01, 3.25, -2.5, persp=persp)
    perspective = persp != (0.0, 0.0)
    wsx, wsy = warp._dst_coords(torch.from_numpy(m), (h, w), perspective)
    mf = m.astype(f32)
    got_x = np.empty((h, w), f32)
    got_y = np.empty((h, w), f32)
    for y in range(h):
        ys = f32(y)
        r1, r4, r7 = mf[0, 1] * ys, mf[1, 1] * ys, mf[2, 1] * ys
        for x0 in range(0, w, 128):
            xs = (x0 + np.arange(0, 128, 32)).clip(max=w - 1).astype(f32)
            for lane in range(32):
                x = (xs + f32(lane)).clip(max=w - 1)
                sx = (mf[0, 0] * x + r1) + mf[0, 2]
                sy = (mf[1, 0] * x + r4) + mf[1, 2]
                if perspective:
                    sw = (mf[2, 0] * x + r7) + mf[2, 2]
                    inv = np.where(sw != 0, f32(1.0) / sw, f32(0.0)).astype(f32)
                    sx, sy = sx * inv, sy * inv
                got_x[y, x.astype(int)] = sx
                got_y[y, x.astype(int)] = sy
    assert np.array_equal(got_x, wsx.numpy())
    assert np.array_equal(got_y, wsy.numpy())


# --- the kernel source on the host --------------------------------------

_SHIM = Path(__file__).with_name("_cuda_host_shim.h")
_SOURCE = (Path(warp_accum_cuda.__file__).parents[1] / "csrc"
           / "warp_accum.cu")


def _build_host(tmp_path_factory):
    """csrc/warp_accum.cu built for the host with g++ and the shim
    (launches rewritten as shim calls; -ffp-contract=off as nvcc's
    --fmad=false)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("warp_accum_host")
    src = re.sub(
        r"(\w+(?:<[^;]*?>)?)<<<([^,]+),\s*([^,]+),[^>]*>>>\((.*?)\);",
        lambda m: (f"host_grid({m.group(2)}, {m.group(3)}, [&] "
                   f"{{ {m.group(1)}({m.group(4)}); }});"),
        _SOURCE.read_text(), flags=re.S)
    (d / "cuda_runtime.h").write_text(_SHIM.read_text())
    (d / "warp_accum.cpp").write_text(src)
    lib = d / "libwarp_accum_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-fPIC", "-shared", "-I", str(d),
                    "-I", str(_SOURCE.parent),
                    "-o", str(lib), str(d / "warp_accum.cpp")],
                   check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.warp_accum_rgb.argtypes = [vp] * 4 + [ci] * 5 + [cf] * 4 + [vp]
    h.warp_moments_rgb.argtypes = [vp] * 8 + [ci] * 5 + [cf, vp]
    return h


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return _build_host(tmp_path_factory)


def _host_maps(kind, n, h, w):
    out = []
    for i in range(n):
        sign = 1 - 2 * (i % 2)
        if kind == "ties":  # s*32 on k + 1/2, both signs
            e = (2 * i + 1) / 64.0
            m = np.array([[1, 0, e - 3], [0, 1, -e], [0, 0, 1]], f32)
        elif kind == "near_ties":
            e = _ulps(np.array([1 / 64.0], f32), sign * (i + 1))[0]
            m = np.array([[1, 0, e], [0, 1, -e], [0, 0, 1]], f32)
        elif kind == "horizon":  # sw == 0 on row 8, tiny and < 0 beyond
            m = np.array([[1, 0.01, 0.5], [0.02, 1, -0.25],
                          [1e-7 * i, -0.125, 1.0]], f32)
        elif kind == "edges":  # coordinates on 0 and W-1 / H-1
            m = np.array([[1, 0, 0], [0, (h - 1) / max(h - 1.0, 1.0), 0],
                          [0, 0, 1]], f32)
        elif kind == "far":  # every tap off the frame
            m = np.array([[1, 0, 3e5 * sign], [0, 1, -2e5], [0, 0, 1]], f32)
        else:
            deg, persp = {"rot30": (30.0, (0, 0)),
                          "strong": (4.0, (2e-2, 1e-2))}[kind]
            m = rotation_inverse_map(h, w, deg * sign, 1.0 + 0.01 * i, 0.5,
                                     -0.25, persp=persp)
        out.append(m)
    return torch.from_numpy(np.stack(out or [np.eye(3, dtype=f32)])[:n]
                            ).contiguous()


_CODE = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("kind", ["ties", "near_ties", "horizon", "edges",
                                  "far", "rot30", "strong"])
@pytest.mark.parametrize("shape", [(3, 17, 133), (2, 1, 5), (1, 3, 2),
                                   (1, 9, 1), (0, 4, 6), (258, 3, 5),
                                   (513, 2, 33), (2, 3, 6001), (1, 2, 8200)])
def test_kernel_source_on_host(host_kernel, dtype, kind, shape):
    """Also past a block's CHUNK = 256 staged maps (258 and 513 frames)
    and wider than the affine bins' range before 2^13 (6001) and after
    it (8200)."""
    _host_case(host_kernel, dtype, kind, shape)


def _host_case(host_kernel, dtype, kind, shape):
    n, h, w = shape
    rng = np.random.default_rng(n * 1000 + h * 10 + w)
    frames = torch.from_numpy(rng.integers(0, 256, (n, h, w, 3), np.uint8))
    if dtype == torch.uint16:
        frames = frames.to(torch.int32).mul(257).to(torch.uint16)
    elif dtype == torch.float32:
        frames = color.to_unit_f32(frames)
    frames = frames.contiguous()
    minv = _host_maps(kind, n, h, w)
    valid = torch.tensor([1.0, 0.0, 0.5] * n, dtype=torch.float32)[:n]
    scale = {torch.uint8: color.U8_SCALE, torch.uint16: color.U16_SCALE,
             torch.float32: 1.0}[dtype]

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    for qa in (False, True):
        bv = [0.1, -0.2, 0.3]
        out = torch.empty((h, w, 3))
        assert host_kernel.warp_accum_rgb(
            ptr(frames), ptr(minv), ptr(valid), ptr(out), n, h, w,
            _CODE[dtype], int(not qa), scale, *bv, None) == 0
        assert torch.equal(out, warp_accum_cuda.warp_accum_rgb_reference(
            frames, minv, valid, bv, qa))
        want = warp_accum_cuda.warp_moments_rgb_reference(frames, minv, valid,
                                                          quant_affine=qa)
        mu = (want[1] / want[0].clamp(min=1.0)).contiguous()
        tol = torch.full_like(mu, 0.03)
        for clip in (False, True):
            s = [torch.empty((h, w, 3)) for _ in range(3)]
            assert host_kernel.warp_moments_rgb(
                ptr(frames), ptr(minv), ptr(valid),
                ptr(mu if clip else None), ptr(tol if clip else None),
                *map(ptr, s), n, h, w, _CODE[dtype], int(not qa), scale,
                None) == 0
            ref = warp_accum_cuda.warp_moments_rgb_reference(
                frames, minv, valid, mu if clip else None,
                tol if clip else None, qa)
            for a, b in zip(s, ref):
                assert torch.equal(a, b)


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_warp_accum_design.py
    fail, clean = certificate_share()
    print(f"certificate fails on {fail:.4f} of burst-like 4K pixel-frames; "
          f"{clean:.4f} of warps of 128 pixel-frames see no failure")
