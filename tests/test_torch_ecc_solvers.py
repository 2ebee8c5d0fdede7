"""PyTorch port vs libstacker_tpu: the lazy-Gram ECC solver
(``mode='lazy'``, ``EccMatchParameters.solver="lazy"``), the solver-mode
rules shared with ``mode='ic'``, and the opt-in solvers through the
octaves.

Bars:

- 'lazy' on tests/test_ecc_pallas.py:504-565's content: within 0.5 of
  the forward warp and of the JAX package's lazy solve
  (``LIBSTACKER_FORCE_PALLAS`` plus ``LIBSTACKER_ECC_INTERPRET``), rho at
  least forward's minus 3e-2, and no rescue;
- on that content 'ic' fails both lanes and its rescue returns
  forward's result exactly;
- 'lazy' recovers the truth within 0.05 px for Translation, Euclidean and
  Affine (:568-597);
- the Gram is computed on the first sweep only and carried;
- a masked 'ic' solve is the forward solve; unknown modes raise;
- ``coarse_levels=1`` with 'ic' and 'lazy': rho within 1e-3 of the JAX
  package's forward solve, warps within 0.06 (the headline-parameter
  tolerances of tests/test_torch_pipeline_ecc.py), and a failed 'lazy'
  octave lane hands the full-resolution solve its pre-solve init;
- ``ecc_match_arrays(solver="lazy")`` against the JAX package's stack
  within 0.02.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("scipy")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

import libstacker_tpu as J  # noqa: E402
import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import burst, n, t  # noqa: E402
from libstacker_tpu.ops import ecc as jecc  # noqa: E402
from libstacker_tpu.params import MotionType as JMotion  # noqa: E402
from libstacker_tpu_torch import MotionType  # noqa: E402
from libstacker_tpu_torch.models import ecc as ecc_models  # noqa: E402
from libstacker_tpu_torch.ops import ecc, ecc_cuda  # noqa: E402

torch.set_num_threads(2)


def _bench_style_pair():
    """tests/test_ecc_pallas.py:504-527: rotated and shifted crops of
    sigma-6 smoothed noise."""
    rng = np.random.default_rng(83)
    h, w = 192, 512
    pad = 32
    base = rng.integers(0, 256, size=(h + 2 * pad, w + 2 * pad),
                        dtype=np.uint8)
    base = cv2.GaussianBlur(base.astype(np.float32), (0, 0), 6.0)
    ref = base[pad : pad + h, pad : pad + w]
    tmpls = []
    for ang, dx, dy in [(0.3, 2.0, -3.0), (-0.4, -1.5, 1.0)]:
        m = cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0)
        m[0, 2] += dx
        m[1, 2] += dy
        cur = cv2.warpAffine(base, m, (w + 2 * pad, h + 2 * pad),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        tmpls.append(cur[pad : pad + h, pad : pad + w])
    return np.stack(tmpls).astype(np.float32), ref.astype(np.float32)


def test_lazy_matches_forward_and_jax(monkeypatch):
    tm, ref = _bench_style_pair()
    kw = dict(num_iters=50, eps=1e-4)
    fwd = ecc.find_transform_ecc_batched(t(tm), t(ref), MotionType.Homography,
                                         **kw)
    ecc.rescued_lane_count = 0
    lazy = ecc.find_transform_ecc_batched(t(tm), t(ref),
                                          MotionType.Homography, mode="lazy",
                                          **kw)
    assert n(lazy.ok).all()
    assert ecc.rescued_lane_count == 0  # no lane needed the forward rescue
    np.testing.assert_allclose(n(lazy.warp_matrix), n(fwd.warp_matrix),
                               atol=0.5)
    assert (n(lazy.rho) >= n(fwd.rho) - 3e-2).all()
    monkeypatch.setenv("LIBSTACKER_FORCE_PALLAS", "1")
    monkeypatch.setenv("LIBSTACKER_ECC_INTERPRET", "1")
    want = jecc.find_transform_ecc_batched(
        jnp.asarray(tm), jnp.asarray(ref), JMotion.Homography, mode="lazy",
        **kw)
    assert np.asarray(want.ok).all()
    np.testing.assert_allclose(n(lazy.warp_matrix),
                               np.asarray(want.warp_matrix), atol=0.5)
    assert (n(lazy.rho) >= np.asarray(want.rho) - 3e-2).all()


def test_ic_pays_the_rescue_on_bench_style_content():
    """Where 'lazy' needs no rescue, 'ic''s rho guard fails both lanes
    (tests/test_ecc_pallas.py:504-508's remark) and the rescue re-solves them in forward
    mode from their original init: forward's result exactly."""
    tm, ref = _bench_style_pair()
    kw = dict(num_iters=50, eps=1e-4)
    fwd = ecc.find_transform_ecc_batched(t(tm), t(ref), MotionType.Homography,
                                         **kw)
    ecc.rescued_lane_count = 0
    ic = ecc.find_transform_ecc_batched(t(tm), t(ref), MotionType.Homography,
                                        mode="ic", **kw)
    assert ecc.rescued_lane_count == 2
    for a, b in zip(ic, fwd):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("motion", ["Translation", "Euclidean", "Affine"])
def test_lazy_recovers_truth(motion):
    rng = np.random.default_rng(89)
    h, w = 192, 512
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.float32), (0, 0), 1.5
    ).astype(np.uint8)
    m = np.array([[1, 0, 2.0], [0, 1, -1.0]], np.float32)
    cur = cv2.warpAffine(base, m, (w * 2, h * 2),
                         flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    tmpl = cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w].astype(np.float32)
    ref = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w].astype(np.float32)
    kw = dict(num_iters=50, eps=1e-5)
    res = ecc.find_transform_ecc_batched(t(tmpl[None]), t(ref),
                                         MotionType[motion], mode="lazy",
                                         **kw)
    assert bool(res.ok[0])
    np.testing.assert_allclose(n(res.warp_matrix)[0, :2, 2], [2.0, -1.0],
                               atol=0.05)
    want = jecc.find_transform_ecc_batched(
        jnp.asarray(tmpl)[None], jnp.asarray(ref), JMotion[motion], **kw)
    np.testing.assert_allclose(n(res.warp_matrix),
                               np.asarray(want.warp_matrix), atol=0.05)


@pytest.mark.parametrize("mode", ["lazy", "ic"])
def test_gram_computed_once_and_carried(monkeypatch, mode):
    """The first sweep of a 'lazy' / 'ic' solve carries the Gram, every
    later sweep drops it (ecc.py:747-768)."""
    frames, _ = burst(3, 3, 96, 128, max_shift=2.0, max_angle=0.2)
    grey = frames[..., 1].astype(np.float32)
    fn = ("ecc_ic_iteration_moments" if mode == "ic"
          else "ecc_iteration_moments")
    orig = getattr(ecc_cuda, fn)
    calls = []

    def spy(*a, **kw):
        calls.append(kw["with_hessian"])
        return orig(*a, **kw)

    monkeypatch.setattr(ecc_cuda, fn, spy)
    res = ecc.find_transform_ecc_batched(
        t(grey[1:]), t(grey[0]), MotionType.Homography, 30, 1e-4, mode=mode)
    assert n(res.ok).all()
    assert calls[0] is True and not any(calls[1:]) and len(calls) >= 2


def test_mode_rules():
    frames, _ = burst(4, 2, 96, 128, max_shift=2.0, max_angle=0.0)
    grey = t(frames[..., 0].astype(np.float32))
    mask = np.ones((96, 128), np.uint8)
    mask[:30, :40] = 0
    kw = dict(motion_type=MotionType.Affine, num_iters=20, eps=1e-4,
              input_mask=mask)
    ic = ecc.find_transform_ecc_batched(grey[1:], grey[0], mode="ic", **kw)
    fwd = ecc.find_transform_ecc_batched(grey[1:], grey[0], mode=None, **kw)
    for a, b in zip(ic, fwd):
        np.testing.assert_array_equal(n(a), n(b))
    with pytest.raises(ValueError, match="mode must be one of"):
        ecc.find_transform_ecc_batched(grey[1:], grey[0], mode="newton")
    assert ecc._resolve_mode(None, None) == "forward"
    assert ecc._resolve_mode("lazy", mask) == "lazy"  # a mask keeps 'lazy'


@pytest.fixture(scope="module")
def octave_burst():
    frames, _ = burst(21, 4, 192, 256, max_shift=4.0, max_angle=0.4)
    grey = frames[..., 1].astype(np.float32)
    kw = dict(num_iters=50, eps=1e-4, gauss_filt_size=5, coarse_levels=1)
    want = jecc.find_transform_ecc_batched(
        jnp.asarray(grey[1:]), jnp.asarray(grey[0]), JMotion.Homography, **kw)
    return grey, kw, want


@pytest.mark.parametrize("mode", ["ic", "lazy"])
def test_coarse_levels_with_opt_in_solvers(octave_burst, mode):
    grey, kw, want = octave_burst
    got = ecc.find_transform_ecc_batched(
        t(grey[1:]), t(grey[0]), MotionType.Homography, mode=mode, **kw)
    assert n(got.ok).all() and np.asarray(want.ok).all()
    np.testing.assert_allclose(n(got.rho), np.asarray(want.rho), atol=1e-3)
    np.testing.assert_allclose(n(got.warp_matrix),
                               np.asarray(want.warp_matrix), atol=0.06)


def test_lazy_octave_failure_hands_on_its_init(monkeypatch):
    """A 'lazy' octave lane that fails gives the full-resolution solve its
    pre-solve init, not its frozen iterate (ecc.py:1130-1139)."""
    frames, _ = burst(5, 3, 192, 256, max_shift=3.0, max_angle=0.2)
    grey = frames[..., 1].astype(np.float32)
    grey[2] = 77.0  # a flat frame has no correlation: its lane fails
    init = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
    init[:, 0, 2] = [1.5, -2.0]
    seen = []
    orig = ecc._solve_lanes

    def spy(*a, **kw):
        seen.append(a[6])
        return orig(*a, **kw)

    monkeypatch.setattr(ecc, "_solve_lanes", spy)
    res = ecc.find_transform_ecc_batched(
        t(grey[1:]), t(grey[0]), MotionType.Homography, 30, 1e-4,
        coarse_levels=1, warp_init=t(init), mode="lazy")
    assert not bool(res.ok[1]) and bool(res.ok[0])
    octave_init, full_init = (n(x) for x in seen)
    np.testing.assert_allclose(octave_init[:, 0, 2], init[:, 0, 2] / 2)
    # lane 1 failed on the octave: its full-resolution init is the
    # octave's init rescaled, i.e. the caller's
    np.testing.assert_allclose(full_init[1], init[1], atol=1e-6)


def test_pipeline_lazy_matches_jax():
    frames, _ = burst(21, 4, 192, 256, max_shift=4.0, max_angle=0.4)
    kw = dict(max_count=50, epsilon=1e-4, gauss_filt_size=5, coarse_levels=1)
    want = J.ecc_match_arrays(frames, J.EccMatchParameters(
        J.MotionType.Homography, **kw))
    got, st = P.ecc_match_arrays(
        frames, P.EccMatchParameters(P.MotionType.Homography, solver="lazy",
                                     **kw),
        return_stats=True, device="cpu")
    assert st.frames_kept == 4
    assert np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02
    assert ecc_models.ecc_ops is ecc  # the pipeline drives this module
