"""PyTorch port vs libstacker_tpu: kernel B1's plain version and the ECC solve.

The plain version ``ecc_cuda.ecc_iteration_moments_reference`` (what the
port runs on the CPU, and what the CUDA kernel is held to on the card) is
compared with the Pallas kernel in interpret mode and with moments built
from the JAX package's XLA warp / mask / Jacobian fields.  Bars are those
of tests/test_ecc_pallas.py:124-125: rtol 1e-5, atol 1e-2 on the six
statistics, rtol 5e-3, atol 5e-2 on every moment (a coordinate on an
exact 1/32 rounding boundary may flip one bin between frameworks).

The batched solve is compared with ``libstacker_tpu``'s on the same
numpy ``warp_init`` (so FFT differences stay out): equal ``ok`` flags,
warps within 0.03 (tests/test_ecc_pallas.py:176-178), truth shifts
recovered within 0.05 px (a homography's map within 0.1 px of the truth
16 px inside the corners).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("scipy")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import burst, n, rotation_inverse_map, smooth, t  # noqa: E402
from libstacker_tpu.ops import ecc as jecc  # noqa: E402
from libstacker_tpu.ops import ecc_pallas as jpallas  # noqa: E402
from libstacker_tpu.ops import phasecorr as jphase  # noqa: E402
from libstacker_tpu.ops import warp as jwarp  # noqa: E402
from libstacker_tpu.params import MotionType as JMotion  # noqa: E402
from libstacker_tpu_torch.ops import ecc, ecc_cuda  # noqa: E402
from libstacker_tpu_torch.params import MotionType  # noqa: E402

torch.set_num_threads(2)

MOTIONS = [MotionType.Translation, MotionType.Euclidean, MotionType.Affine,
           MotionType.Homography]


@pytest.fixture(scope="module")
def fields():
    """image / gx / gy (the JAX package's prep) and a template, 192x512."""
    rng = np.random.default_rng(31)
    h, w = 192, 512
    img = smooth(rng, (h, w))
    image_f, gx, gy = (np.asarray(a) for a in
                       jecc._input_fields(jnp.asarray(img), 5))
    tmpl = smooth(rng, (h, w))
    return np.stack([image_f, gx, gy]), tmpl


def _m3(motion, h, w):
    if motion == MotionType.Translation:
        m = np.eye(3, dtype=np.float32)
        m[0, 2], m[1, 2] = 3.25, -2.5
        return m
    if motion == MotionType.Euclidean:
        return rotation_inverse_map(h, w, 0.8, 1.0, 2.25, -1.5)
    return rotation_inverse_map(h, w, 0.8, 1.003, 2.25, -1.5)


def _xla_field_moments(srcs, tmpl, m3, motion):
    """Moments from the JAX package's XLA fields (the quantities its
    XLA solve branch builds, tests/test_ecc_pallas.py:35-84)."""
    image_f, gx, gy = (jnp.asarray(a) for a in srcs)
    h, w = tmpl.shape
    jm = JMotion(int(motion))

    def wt(img):
        if jm == JMotion.Homography:
            return jwarp.warp_perspective(img, m3, (h, w), inverse_map=True)
        return jwarp.warp_affine(img, m3[:2], (h, w), inverse_map=True)

    imw, gxw, gyw = (np.asarray(wt(a), np.float64) for a in (image_f, gx, gy))
    mask = np.asarray(jwarp.warp_valid_mask(m3, (h, w), (h, w)), np.float64)
    xg = np.arange(w, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    yg = np.arange(h, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    jac = np.asarray(jecc._jacobian_fields_batched(
        jm, jnp.asarray(gxw, jnp.float32)[None],
        jnp.asarray(gyw, jnp.float32)[None], jnp.asarray(xg),
        jnp.asarray(yg), jnp.asarray(m3)[None]), np.float64)[0]
    tm = tmpl.astype(np.float64)
    out = [mask.sum(), (mask * imw).sum(), (mask * imw * imw).sum(),
           (mask * tm).sum(), (mask * tm * tm).sum(), (mask * tm * imw).sum()]
    p = jac.shape[0]
    out += [(jac[a] * imw).sum() for a in range(p)]
    out += [(jac[a] * mask).sum() for a in range(p)]
    out += [(jac[a] * mask * tm).sum() for a in range(p)]
    out += [(jac[a] * jac[b]).sum() for a in range(p) for b in range(a, p)]
    return np.asarray(out)


def _assert_moments_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:6], want[:6], rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-2)


def _plain(srcs, tmpl, m3, motion, **kw):
    return n(ecc_cuda.ecc_iteration_moments(
        t(srcs), t(tmpl)[None], t(m3)[None], motion,
        quant_affine=motion != MotionType.Homography, **kw))[0]


@pytest.mark.parametrize("motion", MOTIONS)
def test_moments_match_xla_fields(fields, motion):
    srcs, tmpl = fields
    m3 = _m3(motion, *tmpl.shape)
    _assert_moments_close(
        _plain(srcs, tmpl, m3, motion).astype(np.float64),
        _xla_field_moments(srcs, tmpl, m3, motion),
    )


@pytest.mark.parametrize("motion", [MotionType.Translation,
                                    MotionType.Homography])
def test_moments_match_pallas_interpret(fields, motion):
    srcs, tmpl = fields
    m3 = _m3(motion, *tmpl.shape)
    want = np.asarray(jpallas.ecc_iteration_moments(
        jnp.asarray(srcs), jnp.asarray(tmpl)[None], jnp.asarray(m3)[None],
        motion_type=JMotion(int(motion)),
        quant_affine=motion != MotionType.Homography, interpret=True,
    ))[0]
    _assert_moments_close(_plain(srcs, tmpl, m3, motion), want)


def test_moments_layout_lanes_and_unpack(fields):
    srcs, tmpl = fields
    motion = MotionType.Homography
    m3 = np.stack([_m3(motion, *tmpl.shape), np.eye(3, dtype=np.float32)])
    tm = np.stack([tmpl, tmpl])
    for mt in MOTIONS:
        jm = JMotion(int(mt))
        assert ecc_cuda.moments_layout(mt) == jpallas.moments_layout(jm)
        assert ecc_cuda.moments_layout(mt, False) == \
            jpallas.moments_layout(jm, False)
    full = n(ecc_cuda.ecc_iteration_moments(t(srcs), t(tm), t(m3), motion))
    lite = n(ecc_cuda.ecc_iteration_moments(t(srcs), t(tm), t(m3), motion,
                                            with_hessian=False))
    np.testing.assert_array_equal(lite, full[:, : lite.shape[1]])
    act = n(ecc_cuda.ecc_iteration_moments(
        t(srcs), t(tm), t(m3), motion, active=torch.tensor([False, True])))
    np.testing.assert_array_equal(act[0], 0.0)
    np.testing.assert_array_equal(act[1], full[1])
    got = ecc_cuda.unpack_moments(t(full), motion)
    want = jpallas.unpack_moments(jnp.asarray(full), JMotion.Homography)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    with pytest.raises(ValueError, match="templates"):
        ecc_cuda.ecc_iteration_moments(t(srcs), t(tm)[:, :8], t(m3), motion)
    with pytest.raises(ValueError, match="4,H,W"):
        ecc_cuda.ecc_iteration_moments(
            torch.cat([t(srcs), t(srcs)[:2]]), t(tm), t(m3), motion)


@pytest.mark.parametrize("planes", [3, 4])
def test_texel_packing_round_trip(planes):
    """B1's texels: pixel (y, x) holds (image, gx, gy, inputMask or 0) as
    one contiguous [H,W,4] float32 row, bit for bit."""
    rng = np.random.default_rng(41)
    srcs = rng.standard_normal((planes, 13, 29)).astype(np.float32)
    tex = ecc_cuda.pack_texels(t(srcs))
    assert tex.dtype == torch.float32 and tex.is_contiguous()
    assert tuple(tex.shape) == (13, 29, 4)
    np.testing.assert_array_equal(np.moveaxis(n(tex)[..., :planes], -1, 0),
                                  srcs)
    if planes == 3:
        np.testing.assert_array_equal(n(tex)[..., 3], 0.0)


@pytest.mark.parametrize("motion", MOTIONS)
def test_update_and_rescale_match(motion):
    rng = np.random.default_rng(5)
    jm = JMotion(int(motion))
    p = motion.num_params
    rows = 3 if motion == MotionType.Homography else 2
    m = np.eye(3, dtype=np.float32)[:rows] + \
        rng.normal(0, 1e-3, (rows, 3)).astype(np.float32)
    if rows == 3:
        m[2, 2] = 1.0
    if motion == MotionType.Euclidean:
        m[:2, :2] = rotation_inverse_map(8, 8, 0.7)[:2, :2]
    dp = rng.normal(0, 1e-2, (p,)).astype(np.float32)
    got = n(ecc._update_warp(motion, t(m)[None], t(dp)[None]))[0]
    want = np.asarray(jecc._update_warp(jm, jnp.asarray(m), jnp.asarray(dp)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for s in (0.5, 2.0):
        np.testing.assert_array_equal(
            n(ecc._rescale_warp_batch(t(m)[None], motion, s))[0],
            np.asarray(jecc._rescale_warp_batch(jnp.asarray(m)[None], jm, s))[0],
        )
    np.testing.assert_array_equal(
        n(ecc.identity_warp(motion)), np.asarray(jecc.identity_warp(jm)))


@pytest.fixture(scope="module")
def solve_burst():
    """3 lanes of 192x256 against frame 0 (greys and truth warps): one
    burst with shifts up to 4 px and rotations up to 0.3 deg, one with
    shifts only."""
    out = {}
    for name, angle in (("rot", 0.3), ("shift", 0.0)):
        frames, truth = burst(11, 4, 192, 256, max_shift=4.0,
                              max_angle=angle)
        out[name] = (frames[..., 0].astype(np.float32), truth)
    return out


@pytest.mark.parametrize("motion,coarse", [
    (MotionType.Homography, 0), (MotionType.Homography, 1),
    (MotionType.Affine, 0), (MotionType.Euclidean, 1),
    (MotionType.Translation, 1),
])
def test_solve_matches_jax(solve_burst, motion, coarse):
    grey, truth = solve_burst[
        "shift" if motion == MotionType.Translation else "rot"]
    jm = JMotion(int(motion))
    init = np.asarray(jphase.phase_init_warps(
        jnp.asarray(grey[1:]), jnp.asarray(grey[0]), motion_type=jm))
    kw = dict(num_iters=50, eps=1e-4, gauss_filt_size=5,
              coarse_levels=coarse)
    want = jecc.find_transform_ecc_batched(
        jnp.asarray(grey[1:]), jnp.asarray(grey[0]), jm,
        warp_init=jnp.asarray(init), **kw)
    got = ecc.find_transform_ecc_batched(
        t(grey[1:]), t(grey[0]), motion, warp_init=t(init), **kw)
    np.testing.assert_array_equal(n(got.ok), np.asarray(want.ok))
    assert n(got.ok).all()
    wm = n(got.warp_matrix)
    np.testing.assert_allclose(wm, np.asarray(want.warp_matrix), atol=0.03)
    np.testing.assert_allclose(n(got.rho), np.asarray(want.rho), atol=1e-3)
    if motion == MotionType.Translation:
        np.testing.assert_allclose(wm[:, :2, 2], truth[1:, :2, 2], atol=0.05)
    else:
        # up to 8 dof on 192x256 of smooth noise: the map lands within
        # 0.1 px of the truth at points 16 px inside the corners
        h, w = grey.shape[1:]
        pts = np.array([[x, y, 1.0] for x in (16, w / 2, w - 16)
                        for y in (16, h / 2, h - 16)]).T
        for m, tr in zip(wm.astype(np.float64), truth[1:]):
            if m.shape[0] == 2:
                m = np.vstack([m, [0.0, 0.0, 1.0]])
            a, b = m @ pts, tr @ pts
            np.testing.assert_allclose(a[:2] / a[2], b[:2] / b[2], atol=0.1)


def test_translation_truth_and_single_frame():
    frames, truth = burst(12, 3, 160, 224, max_angle=0.0)
    grey = frames[..., 0].astype(np.float32)
    res = ecc.find_transform_ecc_batched(
        t(grey[1:]), t(grey[0]), MotionType.Translation, 50, 1e-5, 5)
    assert n(res.ok).all()
    np.testing.assert_allclose(n(res.warp_matrix)[:, :2, 2],
                               truth[1:, :2, 2], atol=0.05)
    one = ecc.find_transform_ecc(t(grey[1]), t(grey[0]),
                                 MotionType.Translation, 50, 1e-5, 5)
    np.testing.assert_array_equal(n(one.warp_matrix), n(res.warp_matrix)[0])
    assert int(one.num_iters) == int(n(res.num_iters)[0])


def test_rho_seed_matches_jax(solve_burst):
    """Lanes seeded with a converged rho (the coarse-to-fine hand-off)
    stop where the JAX solver stops: same iteration counts."""
    grey, _ = solve_burst["rot"]
    kw = dict(num_iters=50, eps=1e-4, gauss_filt_size=5)
    first = ecc.find_transform_ecc_batched(
        t(grey[1:]), t(grey[0]), MotionType.Homography, **kw)
    seed = n(first.rho).copy()
    seed[0] = -1.0  # one cold lane
    wi = n(first.warp_matrix)
    got = ecc.find_transform_ecc_batched(
        t(grey[1:]), t(grey[0]), MotionType.Homography, warp_init=t(wi),
        rho_init=t(seed), **kw)
    want = jecc.find_transform_ecc_batched(
        jnp.asarray(grey[1:]), jnp.asarray(grey[0]), JMotion.Homography,
        warp_init=jnp.asarray(wi), rho_init=jnp.asarray(seed), **kw)
    np.testing.assert_array_equal(n(got.num_iters), np.asarray(want.num_iters))
    np.testing.assert_allclose(n(got.rho), np.asarray(want.rho), atol=1e-4)


def test_solver_edges():
    z = torch.zeros((0, 96, 128))
    res = ecc.find_transform_ecc_batched(z, torch.zeros(96, 128),
                                         MotionType.Homography, 5, 1e-4)
    assert tuple(res.warp_matrix.shape) == (0, 3, 3)
    assert res.ok.dtype == torch.bool and res.num_iters.dtype == torch.int32
    img = torch.zeros(96, 128)
    for mode in ("lazy", "ic"):  # empty lane sets under every mode
        res = ecc.find_transform_ecc_batched(z, img, MotionType.Affine, 5,
                                             1e-4, mode=mode)
        assert tuple(res.warp_matrix.shape) == (0, 2, 3)
    with pytest.raises(ValueError, match="mode"):
        ecc.find_transform_ecc_batched(img[None], img, mode="gauss-newton")
    with pytest.raises(ValueError, match="input_mask"):
        ecc.find_transform_ecc_batched(img[None], img, input_mask=img[:8])
    # a flat template has no correlation: the lane fails like OpenCV's
    res = ecc.find_transform_ecc_batched(
        torch.full((1, 96, 128), 7.0), t(smooth(np.random.default_rng(1),
                                               (96, 128))),
        MotionType.Translation, 20, 1e-4)
    assert not bool(res.ok[0]) and float(res.rho[0]) == -1.0
