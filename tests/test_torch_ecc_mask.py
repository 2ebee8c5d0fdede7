"""PyTorch port vs libstacker_tpu: masked ECC (cv2's inputMask).

Bars:

- the masked input preparation (``ops/ecc._prepare_masked_input``):
  bitwise equal to the JAX package's steps run eagerly; against its
  jitted ``_ecc_prepare_input_masked_jit`` the mask plane is bitwise
  equal and the fields within 1e-4 on the 0..255 scale (XLA fuses the
  jitted blur into another float order, a few ulps);
- the 4-plane moments' plain version: group-norm relative < 1e-4 (B1's
  bar) against moments from the JAX package's XLA fields, and against
  the Pallas kernel with 4 sources in interpret mode on the statistics
  and the Gram (the signed Jacobian sums at 2e-3: see the test); an
  all-ones mask plane gives the 3-plane moments bitwise;
- ``find_transform_ecc_batched(input_mask=)`` and
  ``ecc_match_arrays(mask=)``, full and scaled: the tolerances of
  tests/test_torch_pipeline_ecc.py (equal ``ok``, warps within 0.03,
  rho within 1e-3, stacked interior within 0.02).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("scipy")

import jax.numpy as jnp  # noqa: E402

import libstacker_tpu as J  # noqa: E402
import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import burst, n, rotation_inverse_map, smooth, t  # noqa: E402
from libstacker_tpu.ops import ecc as jecc  # noqa: E402
from libstacker_tpu.ops import ecc_pallas as jpallas  # noqa: E402
from libstacker_tpu.ops import warp as jwarp  # noqa: E402
from libstacker_tpu.params import MotionType as JMotion  # noqa: E402
from libstacker_tpu_torch import MotionType, errors  # noqa: E402
from libstacker_tpu_torch.ops import ecc, ecc_cuda  # noqa: E402

torch.set_num_threads(2)


def _mask(h, w):
    m = np.ones((h, w), np.uint8)
    m[: h // 2, : w // 4] = 0
    m[h - 40 : h - 30, w // 2 : w // 2 + 60] = 0
    return m


@pytest.mark.parametrize("gauss", [3, 5])
def test_masked_input_preparation(gauss):
    rng = np.random.default_rng(3)
    h, w = 97, 131
    img = smooth(rng, (h, w))
    mask = _mask(h, w) * 7  # any nonzero value is valid
    got = n(ecc._prepare_masked_input(t(img), t(mask), gauss))
    fields = [np.asarray(a) for a in jecc._input_fields(jnp.asarray(img), gauss)]
    pre = (jnp.asarray(mask) > 0).astype(jnp.float32)
    pre_bin = np.asarray(jnp.round(
        jecc.filters.gaussian_blur(pre, gauss) * (0.5 / 0.95)))
    eager = [fields[0], fields[1] * pre_bin, fields[2] * pre_bin, pre_bin]
    for g, e in zip(got, eager):
        np.testing.assert_array_equal(g, e)
    jitted = [np.asarray(a) for a in jecc._ecc_prepare_input_masked_jit(
        jnp.asarray(img), jnp.asarray(mask), gauss)]
    np.testing.assert_array_equal(got[3], jitted[3])
    for g, e in zip(got[:3], jitted[:3]):
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-4)
    assert set(np.unique(got[3])) == {0.0, 1.0}
    assert got[3].sum() < (mask > 0).sum()  # the blur erodes the mask


def _group_rels(got, want, p):
    """Norm-relative error of each moment group: the six statistics one
    by one, S(j*i), S(j*m), S(j*m*t), then the Gram."""
    bounds = [(k, k + 1) for k in range(6)]
    bounds += [(6, 6 + p), (6 + p, 6 + 2 * p), (6 + 2 * p, 6 + 3 * p),
               (6 + 3 * p, got.shape[-1])]
    return [float(np.abs(got[..., lo:hi] - want[..., lo:hi]).max()
                  / (np.abs(want[..., lo:hi]).max() + 1e-6))
            for lo, hi in bounds]


def _xla_masked_moments(srcs, tmpl, m3):
    """Homography moments in float64 from the JAX package's XLA fields:
    bilinear image / gx / gy, and the validity mask times the mask
    plane's INTER_NEAREST warp (libstacker_tpu/ops/ecc.py:796-814)."""
    h, w = tmpl.shape
    jm = jnp.asarray(m3)
    imw, gxw, gyw = (np.asarray(jwarp.warp_perspective(
        jnp.asarray(a), jm, (h, w), inverse_map=True), np.float64)
        for a in srcs[:3])
    mask = np.asarray(jwarp.warp_valid_mask(jm, (h, w), (h, w)), np.float64)
    mask = mask * np.asarray(jwarp.warp_perspective(
        jnp.asarray(srcs[3]), jm, (h, w), inverse_map=True,
        interpolation=J.constants.INTER_NEAREST), np.float64)
    xg = np.broadcast_to(np.arange(w, dtype=np.float32)[None], (h, w))
    yg = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    jac = np.asarray(jecc._jacobian_fields_batched(
        JMotion.Homography, jnp.asarray(gxw, jnp.float32)[None],
        jnp.asarray(gyw, jnp.float32)[None], jnp.asarray(xg),
        jnp.asarray(yg), jm[None]), np.float64)[0]
    tm = tmpl.astype(np.float64)
    out = [mask.sum(), (mask * imw).sum(), (mask * imw * imw).sum(),
           (mask * tm).sum(), (mask * tm * tm).sum(), (mask * tm * imw).sum()]
    p = jac.shape[0]
    out += [(jac[a] * imw).sum() for a in range(p)]
    out += [(jac[a] * mask).sum() for a in range(p)]
    out += [(jac[a] * mask * tm).sum() for a in range(p)]
    out += [(jac[a] * jac[b]).sum() for a in range(p) for b in range(a, p)]
    return np.asarray(out)[None]


def test_masked_moments_match_pallas_interpret():
    """Against the JAX package's XLA fields (both summed in float64):
    group-norm rel < 1e-4.  Against the Pallas kernel in interpret mode:
    < 1e-4 on the statistics and the Gram; the signed Jacobian sums
    S(j*i), S(j*m), S(j*m*t) cancel to ~1e-3 of their terms, and there
    the TPU kernel's float32 tile partials carry up to ~1e-3 of the
    group's norm with or without a mask (measured 8.7e-4 with 3 planes,
    9.1e-4 with 4 on this input), so those groups are held to 2e-3."""
    rng = np.random.default_rng(4)
    h, w = 160, 384
    img = smooth(rng, (h, w))
    tmpl = smooth(rng, (h, w))
    srcs = ecc._prepare_masked_input(t(img), t(_mask(h, w)), 5).contiguous()
    m3 = rotation_inverse_map(h, w, 0.6, 1.0, 2.25, -1.5, persp=(1e-5, 0.0))
    got = n(ecc_cuda.ecc_iteration_moments(srcs, t(tmpl)[None], t(m3)[None],
                                           MotionType.Homography))
    assert max(_group_rels(got, _xla_masked_moments(n(srcs), tmpl, m3),
                           8)) < 1e-4
    want = np.asarray(jpallas.ecc_iteration_moments(
        jnp.asarray(n(srcs)), jnp.asarray(tmpl)[None], jnp.asarray(m3)[None],
        motion_type=JMotion.Homography, interpret=True))
    rels = _group_rels(got, want, 8)
    assert max(rels[:6] + rels[9:]) < 1e-4, rels
    assert max(rels[6:9]) < 2e-3, rels
    # the mask removes samples: fewer than the unmasked sweep counts
    full = n(ecc_cuda.ecc_iteration_moments(srcs[:3].contiguous(),
                                            t(tmpl)[None], t(m3)[None],
                                            MotionType.Homography))
    assert got[0, 0] < full[0, 0]


def test_all_ones_mask_plane_equals_three_planes():
    rng = np.random.default_rng(5)
    h, w = 48, 64
    img = smooth(rng, (h, w))
    srcs = torch.stack(ecc._input_fields(t(img), 5))
    srcs4 = torch.cat([srcs, torch.ones((1, h, w))]).contiguous()
    tm = t(np.stack([smooth(rng, (h, w))] * 2))
    m3 = t(np.stack([rotation_inverse_map(h, w, a, 1.0, 1.5, -0.5)
                     for a in (0.4, -0.9)]))
    for motion in (MotionType.Affine, MotionType.Homography):
        kw = dict(quant_affine=motion != MotionType.Homography,
                  active=torch.tensor([True, False]))
        a = ecc_cuda.ecc_iteration_moments(srcs4, tm, m3, motion, **kw)
        b = ecc_cuda.ecc_iteration_moments(srcs.contiguous(), tm, m3,
                                           motion, **kw)
        np.testing.assert_array_equal(n(a), n(b))
    with pytest.raises(ValueError, match="4,H,W"):
        ecc_cuda.ecc_iteration_moments(torch.cat([srcs4, srcs[:1]]), tm, m3,
                                       MotionType.Affine)


@pytest.fixture(scope="module")
def masked_burst():
    frames, truth = burst(21, 4, 192, 256, max_shift=4.0, max_angle=0.4)
    return frames, truth, _mask(192, 256)


@pytest.mark.parametrize("coarse", [0, 1])
def test_find_transform_masked_matches_jax(masked_burst, coarse):
    frames, _, mask = masked_burst
    grey = frames[..., 0].astype(np.float32)
    kw = dict(num_iters=50, eps=1e-4, gauss_filt_size=5,
              coarse_levels=coarse)
    want = jecc.find_transform_ecc_batched(
        jnp.asarray(grey[1:]), jnp.asarray(grey[0]), JMotion.Homography,
        input_mask=jnp.asarray(mask), **kw)
    got = ecc.find_transform_ecc_batched(
        t(grey[1:]), t(grey[0]), MotionType.Homography, input_mask=t(mask),
        **kw)
    np.testing.assert_array_equal(n(got.ok), np.asarray(want.ok))
    assert n(got.ok).all()
    np.testing.assert_allclose(n(got.warp_matrix),
                               np.asarray(want.warp_matrix), atol=0.03)
    np.testing.assert_allclose(n(got.rho), np.asarray(want.rho), atol=1e-3)
    with pytest.raises(ValueError, match="input_mask shape"):
        ecc.find_transform_ecc_batched(t(grey[1:]), t(grey[0]),
                                       input_mask=t(mask[:8]))


def _params(mod, **kw):
    base = dict(motion_type=mod.MotionType.Homography, max_count=50,
                epsilon=1e-4, gauss_filt_size=5, coarse_levels=1)
    base.update(kw)
    return mod.EccMatchParameters(**base)


@pytest.mark.parametrize("sdw", [None, 150.0])
def test_ecc_match_arrays_mask_matches_jax(masked_burst, sdw):
    frames, _, mask = masked_burst
    kw = {} if sdw is None else dict(scale_down_width=sdw)
    pk = {} if sdw is None else dict(coarse_levels=0)
    got, st = P.ecc_match_arrays(frames, _params(P, **pk), mask=mask,
                                 return_stats=True, device="cpu", **kw)
    want, jst = J.ecc_match_arrays(frames, _params(J, **pk), mask=mask,
                                   return_stats=True, **kw)
    assert st.frames_kept == jst.frames_kept == 4
    np.testing.assert_allclose(st.ecc_rho, jst.ecc_rho, atol=1e-3)
    assert "phase init" not in st.phase_ms  # the masked solve starts cold
    d = np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8])
    assert d.max() < 0.02, d.max()
    with pytest.raises(errors.InvalidParamsError, match="mask must be"):
        P.ecc_match_arrays(frames, _params(P), mask=mask[:, :10],
                           device="cpu")
    # a [H,W,1] mask is taken too
    got1 = P.ecc_match_arrays(frames, _params(P, **pk), mask=mask[..., None],
                              device="cpu", **kw)
    np.testing.assert_array_equal(got1, got)
