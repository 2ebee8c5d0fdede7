"""PyTorch port vs libstacker_tpu: kappa-sigma stacking (ops/stack.py) and
the plain version of kernel B4 (ops/warp_accum_cuda.warp_moments_rgb).

Bars:

- ``clip_iterate`` on random moments (and resumed from a recorded
  state): within 1e-6 of the JAX package's;
- ``_coverage``: equal to the JAX package's except where a coordinate
  sits on an exact boundary (the two float32 inverses may differ by an
  ulp): under 1e-3 of pixels;
- B4's plain version against ``warp_moments_rgb_pallas`` in interpret
  mode, with and without ``mu`` / ``tol``: S0 bitwise (coverage reads
  the unquantised coordinate), the rest at the JAX package's
  fused-vs-unfused bar (under 1e-3 of values off by more than 1e-5, max
  < 0.02): the TPU kernel's coordinate order moves a few 1/32 bins; in
  the clip pass a moved sample can cross the clip test and move a whole
  sample, so there only the fraction bar holds;
- ``kappa_sigma_stack`` on tests/test_stack.py's 5x192x512 glitch burst
  against the JAX package at that file's bar (under 1e-3 of values off
  by more than 1e-4, clipped fraction within 5e-3), and against the
  pixelwise numpy oracle under identity warps (2e-6);
- both pipelines' sigma-clip on tests/test_stack.py's streak bursts: the
  streak suppressed (error on its core under a quarter of the mean
  stack's) and the port within 0.02 of the JAX package's stack (ECC:
  everywhere inside an 8-px margin; keypoint: at the 99th percentile,
  RANSAC's draws differing);
- sigma-clip with a non-constant border raises ``InvalidParamsError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

import libstacker_tpu as J  # noqa: E402
import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import n, rotation_inverse_map, smooth, t  # noqa: E402
from libstacker_tpu.ops import stack as jstack  # noqa: E402
from libstacker_tpu.ops import warp_accum_pallas as jaccum  # noqa: E402
from libstacker_tpu_torch import constants, errors  # noqa: E402
from libstacker_tpu_torch.ops import color, stack, warp, warp_accum_cuda  # noqa: E402
from test_stack import _numpy_kappa_sigma, streak_burst  # noqa: E402,F401

torch.set_num_threads(2)


def test_clip_iterate_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.random((9, 6, 7, 3)).astype(np.float32)
    v[4, 2, 3] = 5.0  # an outlier

    def moments(xp, samples, mu, tol):
        m = (xp.abs(samples - mu) <= tol).astype(samples.dtype) \
            if xp is jnp else (torch.abs(samples - mu) <= tol).float()
        return m.sum(0), (m * samples).sum(0), (m * samples * samples).sum(0)

    s0 = np.full((6, 7), 9.0, np.float32)
    s1, s2 = v.sum(0), (v * v).sum(0)
    states = []
    got, kept = stack.clip_iterate(
        t(s0), t(s1), t(s2), 1.5, 3,
        lambda mu, tol: moments(torch, t(v), mu, tol),
        pass_hook=lambda i, *s: states.append((i, s)))
    want, wkept = jstack.clip_iterate(
        jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(s2), 1.5, 3,
        lambda mu, tol: moments(jnp, jnp.asarray(v), mu, tol))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(n(kept), np.asarray(wkept), atol=1e-6)
    assert [i for i, _ in states] == [2, 3]
    resumed, _ = stack.clip_iterate(
        None, None, None, 1.5, 3,
        lambda mu, tol: moments(torch, t(v), mu, tol),
        start_pass=3, entry_state=states[1][1])
    np.testing.assert_array_equal(n(resumed), n(got))
    with pytest.raises(ValueError, match="iters"):
        stack.clip_iterate(t(s0), t(s1), t(s2), 1.5, 0, None)
    with pytest.raises(ValueError, match="kappa"):
        stack.clip_iterate(t(s0), t(s1), t(s2), 0.0, 1, None)


@pytest.mark.parametrize("perspective", [True, False])
def test_coverage_matches_jax(perspective):
    h, w = 50, 70
    mats = np.stack([rotation_inverse_map(h, w, a, 1.0, dx, dy,
                                          persp=(2e-4 * a if perspective
                                                 else 0.0, 0.0))
                     for a, dx, dy in ((0.0, 0.0, 0.0), (3.0, 4.5, -2.25),
                                       (-2.0, -6.0, 3.5))])
    got = n(stack._coverage(t(mats), h, w, perspective))
    want = np.asarray(jstack._coverage(jnp.asarray(mats), h, w, perspective))
    assert got.shape == (3, h, w) and got.dtype == bool
    assert got[0].all() and not got[1].all()
    assert (got != want).mean() < 1e-3


def _u8_burst(seed, nf, h, w):
    rng = np.random.default_rng(seed)
    return np.clip(np.round(np.stack([smooth(rng, (h, w, 3))
                                      for _ in range(nf)])),
                   0, 255).astype(np.uint8)


@pytest.mark.parametrize("quant_affine", [False, True])
def test_moments_match_pallas_interpret(quant_affine):
    h, w = 192, 384
    frames = _u8_burst(11, 3, h, w)
    minv = np.stack([rotation_inverse_map(
        h, w, a, 1.0, dx, dy, persp=(0.0 if quant_affine else 1e-5 * a, 0.0))
        for a, dx, dy in ((0.5, 1.25, -2.5), (-0.8, 3.1, 0.7),
                          (0.2, -2.2, 1.9))])
    valid = np.array([True, False, True])
    got = warp_accum_cuda.warp_moments_rgb(t(frames), t(minv), t(valid),
                                           quant_affine=quant_affine)
    want = jaccum.warp_moments_rgb_pallas(
        jnp.asarray(frames), jnp.asarray(minv), jnp.asarray(valid),
        quant_affine=quant_affine, interpret=True)
    mu = got[1] / torch.clamp(got[0], min=1.0)
    tol = torch.full_like(mu, 0.02)
    got_c = warp_accum_cuda.warp_moments_rgb(t(frames), t(minv), t(valid),
                                             mu, tol, quant_affine)
    want_c = jaccum.warp_moments_rgb_pallas(
        jnp.asarray(frames), jnp.asarray(minv), jnp.asarray(valid),
        mu=jnp.asarray(n(mu)), tol=jnp.asarray(n(tol)),
        quant_affine=quant_affine, interpret=True)
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    for g, wn, clip in ((got, want, False), (got_c, want_c, True)):
        for a, b in zip(g, wn):
            d = np.abs(n(a) - np.asarray(b))
            assert (d > 1e-5).mean() <= 1e-3, (d > 1e-5).mean()
            assert clip or d.max() < 0.02, d.max()
    assert float((got_c[0] - got[0]).min()) < 0.0  # the clip removed some


def test_moments_sources_and_checks():
    """u8, u16 and f32 sources agree (bitwise for u8 vs f32); a dropped
    lane adds nothing; S0's channels agree without a clip."""
    h, w = 40, 56
    frames = _u8_burst(12, 3, h, w)
    minv = torch.from_numpy(np.stack([rotation_inverse_map(
        h, w, a, 1.0, 1.5 * a, -a, persp=(1e-4 * a, 0.0))
        for a in (0.0, 1.0, -2.0)]))
    valid = torch.tensor([True, True, False])
    u8 = warp_accum_cuda.warp_moments_rgb(t(frames), minv, valid)
    f32 = warp_accum_cuda.warp_moments_rgb(color.to_unit_f32(t(frames)),
                                           minv, valid)
    u16 = warp_accum_cuda.warp_moments_rgb(
        t(frames.astype(np.uint16) * np.uint16(257)), minv, valid)
    two = warp_accum_cuda.warp_moments_rgb(t(frames[:2]), minv[:2], valid[:2])
    for a, b, c, d in zip(u8, f32, u16, two):
        np.testing.assert_array_equal(n(a), n(b))
        np.testing.assert_allclose(n(c), n(a), atol=1e-5)
        np.testing.assert_array_equal(n(a), n(d))
    np.testing.assert_array_equal(n(u8[0])[..., 0], n(u8[0])[..., 2])
    with pytest.raises(ValueError, match="together"):
        warp_accum_cuda.warp_moments_rgb(t(frames), minv, valid, mu=u8[1])
    with pytest.raises(ValueError, match="mu must be"):
        warp_accum_cuda.warp_moments_rgb(t(frames), minv, valid,
                                         u8[1][:4], u8[1][:4])


def test_kappa_sigma_matches_jax():
    """tests/test_stack.py's fused-kernel burst: 5x192x512, a one-frame
    glitch, sub-pixel shifts, two clip passes."""
    rng = np.random.default_rng(23)
    nf, h, w = 5, 192, 512
    base = cv2.GaussianBlur(
        rng.integers(0, 256, (h, w, 3), np.uint8).astype(np.uint8),
        (0, 0), 2.0)
    frames = np.stack([
        np.roll(base, (int(rng.integers(-3, 4)), int(rng.integers(-3, 4))),
                (0, 1))
        for _ in range(nf)])
    frames[2, 60:64, 100:300] = 255
    mats = np.stack([np.eye(3, dtype=np.float32)] * (nf - 1))
    for i in range(nf - 1):
        mats[i, 0, 2] = 1.25 * i - 2.0
        mats[i, 1, 2] = -0.75 * i + 1.0
    oks = np.ones(nf - 1, bool)
    want, frac_w = jstack.kappa_sigma_stack(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
        kappa=2.0, iters=2, chunk=3, allow_pallas=False)
    got, frac_g = stack.kappa_sigma_stack(t(frames), t(mats), t(oks),
                                          kappa=2.0, iters=2, chunk=3)
    d = np.abs(n(got) - np.asarray(want))
    assert (d > 1e-4).mean() <= 1e-3, (d > 1e-4).mean()
    assert abs(frac_g - frac_w) < 5e-3, (frac_g, frac_w)
    # one sweep of all frames gives the same image as chunks of 3
    whole, _ = stack.kappa_sigma_stack(t(frames), t(mats), t(oks),
                                       kappa=2.0, iters=2, chunk=nf)
    assert np.abs(n(whole) - n(got)).max() < 1e-5


def test_identity_warps_and_dropped_nan_lanes():
    """tests/test_stack.py's pixelwise oracle: identity warps make the
    re-warping formulation the plain per-pixel clip; a dropped lane with
    a NaN matrix adds nothing; 2x3 affine matrices are taken."""
    rng = np.random.default_rng(11)
    nf, h, w = 7, 24, 32
    frames = rng.integers(0, 256, (nf, h, w, 3), np.uint8)
    mats = np.stack([np.eye(3, dtype=np.float32)] * (nf - 1))
    for kappa, iters in ((1.0, 2), (2.5, 1)):
        out, frac = stack.kappa_sigma_stack(
            t(frames), t(mats), torch.ones(nf - 1, dtype=torch.bool),
            kappa=kappa, iters=iters, chunk=3)
        want = _numpy_kappa_sigma(frames.astype(np.float32) / 255.0,
                                  kappa, iters)
        np.testing.assert_allclose(n(out), want, atol=2e-6)
        assert 0.0 <= frac <= 1.0
    aff = mats[:, :2].copy()
    aff[2] = np.nan
    oks = np.ones(nf - 1, bool)
    oks[2] = False
    out, _ = stack.kappa_sigma_stack(t(frames), t(aff), t(oks),
                                     perspective=False, kappa=3.0, iters=1)
    keep = np.ones(nf, bool)
    keep[3] = False
    want = _numpy_kappa_sigma(frames[keep].astype(np.float32) / 255.0, 3.0, 1)
    np.testing.assert_allclose(n(out), want, atol=2e-6)


def _ecc_params(mod, **kw):
    return mod.EccMatchParameters(motion_type=mod.MotionType.Translation,
                                  max_count=80, epsilon=1e-4, **kw)


def test_ecc_sigma_clip_matches_jax(streak_burst):
    clean, dirty, streak = streak_burst
    sig = dict(stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=2)
    mean_clean = J.ecc_match_arrays(clean, _ecc_params(J))
    mean_dirty = P.ecc_match_arrays(dirty, _ecc_params(P), device="cpu")
    got, st = P.ecc_match_arrays(dirty, _ecc_params(P, **sig),
                                 return_stats=True, device="cpu")
    want, jst = J.ecc_match_arrays(dirty, _ecc_params(J, **sig),
                                   return_stats=True)
    core = streak & ~np.roll(streak, 3, 0)
    err_mean = np.abs(mean_dirty - mean_clean)[core].mean()
    err_sig = np.abs(got - mean_clean)[core].mean()
    assert err_mean > 0.02, err_mean
    assert err_sig < 0.25 * err_mean, (err_sig, err_mean)
    far = ~cv2.dilate(streak.astype(np.uint8), np.ones((9, 9))).astype(bool)
    far[:8] = far[-8:] = False
    far[:, :8] = far[:, -8:] = False
    assert np.abs(got - mean_clean)[far].mean() < 0.01
    assert np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02
    assert st.frames_kept == jst.frames_kept == 8
    assert abs(st.clipped_sample_frac - jst.clipped_sample_frac) < 5e-3
    assert 0.0 < st.clipped_sample_frac < 0.2


def test_ecc_sigma_clip_scaled_drop(streak_burst):
    """The scaled path rescales the warps before the robust stack, and
    with on_failure="drop" the image is final as returned."""
    _, dirty, _ = streak_burst
    bad = dirty.copy()
    bad[5] = 128  # a flat frame fails its lane
    kw = dict(scale_down_width=96.0, on_failure="drop")
    sig = dict(stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=2)
    got, st = P.ecc_match_arrays(bad, _ecc_params(P, **sig), device="cpu",
                                 return_stats=True, **kw)
    want, jst = J.ecc_match_arrays(bad, _ecc_params(J, **sig),
                                   return_stats=True, **kw)
    assert st.frames_kept == jst.frames_kept == 7
    assert np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02
    with pytest.raises(errors.ProcessingError):
        P.ecc_match_arrays(bad, _ecc_params(P, **sig), device="cpu")


def _streak_keypoint_burst():
    """tests/test_stack.py's keypoint streak burst (6 shifted copies of
    a block texture, a bright 3-px line through frame 2)."""
    rng = np.random.default_rng(19)
    h, w = 192, 256
    base = cv2.resize(
        rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8).astype(np.uint8),
        (w, h), interpolation=cv2.INTER_NEAREST)
    frames = np.stack([
        np.roll(base, (int(rng.integers(-4, 5)), int(rng.integers(-4, 5))),
                (0, 1))
        for _ in range(6)])
    dirty = frames.copy()
    streaked = dirty[2].copy()
    cv2.line(streaked, (30, 40), (220, 150), (255, 255, 255), 3)
    dirty[2] = streaked
    streak = np.zeros((h, w), np.uint8)
    cv2.line(streak, (30, 40), (220, 150), 1, 3)
    return frames, dirty, streak.astype(bool)


def test_keypoint_sigma_clip_matches_jax():
    frames, dirty, streak = _streak_keypoint_burst()
    sig = dict(stacking="sigma_clip", sigma_kappa=2.0, sigma_iters=2)
    d0, mean_out = P.keypoint_match_arrays(dirty, device="cpu")
    d1, got, st = P.keypoint_match_arrays(
        dirty, P.KeyPointMatchParameters(**sig), return_stats=True,
        device="cpu")
    jd, want = J.keypoint_match_arrays(dirty, J.KeyPointMatchParameters(**sig))
    assert d0 == d1 == jd == 0
    clean_ref = frames[0].astype(np.float32) / 255.0
    interior = np.zeros(streak.shape, bool)
    interior[16:-16, 16:-16] = True
    core = streak & interior
    err_mean = np.abs(mean_out - clean_ref)[core].mean()
    err_sig = np.abs(got - clean_ref)[core].mean()
    assert err_mean > 0.02, err_mean
    assert err_sig < 0.25 * err_mean, (err_sig, err_mean)
    # RANSAC draws differ (torch.Generator vs jax.random): the stacks are
    # held statistically, as tests/test_torch_pipeline_keypoint.py holds
    # them (99th percentile of the interior within 0.02)
    d = np.abs(got[16:-16, 16:-16] - want[16:-16, 16:-16])
    assert np.quantile(d, 0.99) < 0.02, np.quantile(d, 0.99)
    assert st.clipped_sample_frac is not None and st.clipped_sample_frac > 0


@pytest.mark.parametrize("mode", [constants.BORDER_REPLICATE,
                                  constants.BORDER_WRAP])
def test_sigma_clip_needs_a_coverage_border(mode):
    frames = np.zeros((2, 32, 32, 3), np.uint8)
    p = dict(stacking="sigma_clip", border_mode=mode)
    with pytest.raises(errors.InvalidParamsError, match="sigma_clip") as pe:
        P.keypoint_match_arrays(frames, P.KeyPointMatchParameters(**p),
                                device="cpu")
    with pytest.raises(J.errors.InvalidParamsError) as je:
        J.keypoint_match_arrays(frames, J.KeyPointMatchParameters(**p))
    assert str(pe.value) == str(je.value)
    # BORDER_TRANSPARENT has coverage: no error
    d, out = P.keypoint_match_arrays(
        frames, P.KeyPointMatchParameters(
            stacking="sigma_clip", border_mode=constants.BORDER_TRANSPARENT),
        device="cpu")
    assert out.shape == (32, 32, 3) and np.isfinite(out).all()
    assert tuple(warp.invert_3x3(torch.eye(3)).shape) == (3, 3)
