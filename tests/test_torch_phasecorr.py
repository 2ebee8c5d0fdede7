"""PyTorch port vs libstacker_tpu: the rotation/scale phase start
(``ops/phasecorr.phase_correlate_rotscale`` and
``phase_init_warps(rotation=True)``, ``phase_init_rotation=True``).

Bars (tests/test_phasecorr.py:107-217, tests/test_pipeline_ecc.py:114-141):

- ``phase_correlate_rotscale``: |d theta| < 1e-3 rad and |d scale| <
  1e-3 against the JAX package, the response within 1e-3, and that
  file's truth bars (response > 0.2, theta within 0.005 rad, scale within
  0.01);
- ``phase_init_warps(rotation=True)``: within 0.05 of the JAX package's
  start and 0.6 of the ground-truth warp; the response gate, Euclidean's
  unit scale;
- ``ecc_match_arrays(phase_init_rotation=True)`` on a rotating burst:
  within 0.02 of the default start's stack and of the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

import libstacker_tpu as J  # noqa: E402
import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import n, t  # noqa: E402
from libstacker_tpu.ops import phasecorr as jphase  # noqa: E402
from libstacker_tpu.params import MotionType as JMotion  # noqa: E402
from libstacker_tpu_torch import MotionType  # noqa: E402
from libstacker_tpu_torch.ops import phasecorr  # noqa: E402

torch.set_num_threads(2)


def _rotated_pair(ang_deg, scale, dx, dy, h=256, w=320, seed=3):
    """tests/test_phasecorr.py:107-127: (ref, template, true W[:2]) with
    template(x) = ref(W x)."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.float32), (0, 0), 2.0)
    ref = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
    m = cv2.getRotationMatrix2D((w, h), ang_deg, scale)
    m[0, 2] += dx
    m[1, 2] += dy
    m3 = np.vstack([m, [0, 0, 1]]).astype(np.float32)
    cur = cv2.warpPerspective(base, m3, (w * 2, h * 2),
                              flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    tm = cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
    off = np.array([[1, 0, w // 2], [0, 1, h // 2], [0, 0, 1]], np.float32)
    mc = np.linalg.inv(off) @ m3 @ off
    return ref, tm, mc[:2]


def _cases(cases):
    tms, truths, ref = [], [], None
    for ang, sc in cases:
        ref, tm, w_true = _rotated_pair(ang, sc, 3.0, -2.0)
        tms.append(tm)
        truths.append(w_true)
    return np.stack(tms).astype(np.float32), ref.astype(np.float32), truths


def test_rotscale_matches_jax_and_truth():
    tms, ref, truths = _cases([(2.0, 1.0), (-2.5, 1.0), (1.0, 1.04),
                               (0.0, 0.96)])
    theta, scale, resp = (n(x) for x in phasecorr.phase_correlate_rotscale(
        t(tms), t(ref)))
    jt, js, jr = (np.asarray(x) for x in jphase.phase_correlate_rotscale(
        jnp.asarray(tms), jnp.asarray(ref)))
    np.testing.assert_allclose(theta, jt, atol=1e-3)
    np.testing.assert_allclose(scale, js, atol=1e-3)
    np.testing.assert_allclose(resp, jr, atol=1e-3)
    for i, tr in enumerate(truths):
        th_true = np.arctan2(tr[1, 0], tr[0, 0])
        sc_true = float(np.sqrt(np.linalg.det(tr[:2, :2])))
        assert resp[i] > 0.2
        assert abs(theta[i] - th_true) < 0.005, (i, theta[i], th_true)
        assert abs(scale[i] - sc_true) < 0.01, (i, scale[i], sc_true)
    # the pooled path (downscale 2) agrees too
    got2 = n(phasecorr.phase_correlate_rotscale(t(tms), t(ref), 2)[0])
    want2 = np.asarray(jphase.phase_correlate_rotscale(
        jnp.asarray(tms), jnp.asarray(ref), downscale=2)[0])
    np.testing.assert_allclose(got2, want2, atol=1e-3)


@pytest.mark.parametrize("motion", ["Affine", "Homography"])
def test_rotation_init_matches_jax_and_truth(motion):
    tms, ref, truths = _cases([(2.0, 1.0), (-2.5, 1.0), (1.0, 1.04)])
    got = n(phasecorr.phase_init_warps(t(tms), t(ref), MotionType[motion],
                                       rotation=True))
    want = np.asarray(jphase.phase_init_warps(
        jnp.asarray(tms), jnp.asarray(ref), JMotion[motion], rotation=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.05)
    for i, tr in enumerate(truths):
        assert np.abs(got[i, :2] - tr).max() < 0.6, (i, got[i], tr)


def test_rotation_init_gate_matches_jax():
    """Heavy per-frame noise on isotropic content (tests/test_phasecorr.py
    :173-205): a low log-polar response keeps the rotation-free start."""
    rng = np.random.default_rng(9)
    h, w = 192, 512
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.float32), (0, 0), 2.5)

    def frame(ang):
        m = cv2.getRotationMatrix2D((w, h), ang, 1.0)
        cur = cv2.warpAffine(base, m, (w * 2, h * 2), flags=cv2.INTER_LINEAR)
        c = cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        return c + rng.normal(0, 12, c.shape).astype(np.float32)

    tm, im = frame(1.2), frame(-1.1)
    theta, _, resp = phasecorr.phase_correlate_rotscale(t(tm[None]), t(im))
    _, _, jresp = jphase.phase_correlate_rotscale(jnp.asarray(tm)[None],
                                                  jnp.asarray(im))
    np.testing.assert_allclose(n(resp), np.asarray(jresp), atol=1e-3)
    got = n(phasecorr.phase_init_warps(t(tm[None]), t(im),
                                       MotionType.Euclidean, rotation=True))
    want = np.asarray(jphase.phase_init_warps(
        jnp.asarray(tm)[None], jnp.asarray(im), JMotion.Euclidean,
        rotation=True))
    np.testing.assert_allclose(got, want, atol=0.05)
    if float(resp[0]) < phasecorr._MIN_RS_RESPONSE:
        np.testing.assert_array_equal(got[0, :2, :2],
                                      np.eye(2, dtype=np.float32))
    else:
        assert abs(float(theta[0]) - (-0.0401)) < 0.02
    assert (phasecorr._MIN_RS_RESPONSE, phasecorr._MAX_LOG_SCALE) == (
        jphase._MIN_RS_RESPONSE, jphase._MAX_LOG_SCALE)


def test_rotation_init_euclidean_unit_scale():
    ref, tm, _ = _rotated_pair(1.5, 1.0, 2.0, 1.0)
    got = n(phasecorr.phase_init_warps(t(tm[None]), t(ref),
                                       MotionType.Euclidean, rotation=True))
    r = got[0, :2, :2]
    np.testing.assert_allclose(r @ r.T, np.eye(2), atol=1e-5)
    want = np.asarray(jphase.phase_init_warps(
        jnp.asarray(tm)[None], jnp.asarray(ref), JMotion.Euclidean,
        rotation=True))
    np.testing.assert_allclose(got, want, atol=0.05)


def test_pipeline_rotation_start_matches():
    rng = np.random.default_rng(97)
    h, w = 192, 256
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.float32), (0, 0), 2.0)
    frames = []
    for ang in (0.0, 0.5, -0.4):
        m = cv2.getRotationMatrix2D((w, h), ang, 1.0)
        cur = cv2.warpAffine(base, m, (w * 2, h * 2),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        c = np.clip(cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w], 0,
                    255).astype(np.uint8)
        frames.append(np.stack([c] * 3, -1))
    frames = np.stack(frames)
    kw = dict(max_count=60, epsilon=1e-4)
    out_rot, st = P.ecc_match_arrays(
        frames, P.EccMatchParameters(P.MotionType.Euclidean,
                                     phase_init_rotation=True, **kw),
        return_stats=True, device="cpu")
    out_def = P.ecc_match_arrays(
        frames, P.EccMatchParameters(P.MotionType.Euclidean, **kw),
        device="cpu")
    want = J.ecc_match_arrays(frames, J.EccMatchParameters(
        J.MotionType.Euclidean, phase_init_rotation=True, **kw))
    assert st.frames_kept == 3
    assert np.abs(out_rot[8:-8, 8:-8] - out_def[8:-8, 8:-8]).max() < 0.02
    assert np.abs(out_rot[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02
