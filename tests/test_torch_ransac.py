"""PyTorch port vs libstacker_tpu: homography estimation (ops/ransac.py).

Same numpy correspondences through both packages on the CPU, the JAX
side vmapped over frames as ``_match_and_estimate`` runs it.  Bars:

- the deterministic helpers (normalisation, 4-point DLT, projection,
  least-squares DLT, Gauss-Newton polish, checkSubset) agree within
  float32 rounding (relative 1e-4, the DLT and polish on the
  normalised-H scale within 1e-3: eigh and the 8x8 solves run in
  float32 through two different LAPACKs);
- method 0 (no random draws): H within 1e-3 and the corners it maps
  within 0.05 px of the JAX package's;
- LMEDS scoring of the same hypotheses picks the same hypothesis and
  threshold (the JAX formula, ransac.py:264-274, transcribed in jnp);
- RANSAC and LMEDS draw from different generators, so they are held to
  the JAX package statistically: the image corners mapped within 0.5 px
  of the truth and of the JAX estimate, inlier counts within 5% of the
  JAX package's.

The port's own loop: the adaptive loop reads its active mask once
after each slab and not before the first (``_adaptive_best``); it is
held bitwise (best H, the answer's H, inliers and ``ok``, the
generator's state) to a loop that reads before every slab, the loop the
port ran before, over lanes that stop after 1 to 16 slabs and several
generator seeds; LMEDS and method 0
bitwise to the helpers composed as before; the normalisation's inverse
(``inv_ex``) bitwise ``torch.linalg.inv``'s.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import n, t  # noqa: E402
from libstacker_tpu import constants as jconstants  # noqa: E402
from libstacker_tpu.ops import ransac as jransac  # noqa: E402
from libstacker_tpu_torch import constants  # noqa: E402
from libstacker_tpu_torch.ops import ransac  # noqa: E402

torch.set_num_threads(2)

W, H = 640.0, 480.0
CORNERS = np.array([[0, 0], [W, 0], [0, H], [W, H]], np.float64)


def _truth(k):
    return np.array([
        [1.0 + 0.01 * k, 0.01, 5.0 - 2 * k],
        [-0.015, 0.99, -3.0 + k],
        [1e-5 * k, -2e-5, 1.0],
    ])


def _batch(seed, outlier_fracs=(0.3, 0.5, 0.2), m=200, pad=40, noise=0.4):
    """B frames of m correspondences (+ pad invalid slots) under known
    homographies, with gross outliers."""
    rng = np.random.default_rng(seed)
    src, dst, valid, truths = [], [], [], []
    for k, frac in enumerate(outlier_fracs):
        h = _truth(k)
        s = rng.uniform(0, [W, H], (m, 2))
        p = np.c_[s, np.ones(m)] @ h.T
        d = p[:, :2] / p[:, 2:] + rng.normal(0, noise, (m, 2))
        out = rng.choice(m, int(frac * m), replace=False)
        d[out] += rng.uniform(30, 200, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
        src.append(np.r_[s, np.full((pad, 2), 777.0)])
        dst.append(np.r_[d, np.full((pad, 2), -55.0)])
        valid.append(np.r_[np.ones(m, bool), np.zeros(pad, bool)])
        truths.append(h)
    return (np.asarray(src, np.float32), np.asarray(dst, np.float32),
            np.asarray(valid), truths)


def _corners(h):
    p = np.c_[CORNERS, np.ones(4)] @ np.asarray(h, np.float64).T
    return p[:, :2] / p[:, 2:]


def _jax_find(src, dst, valid, method, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), len(src))
    return jax.vmap(lambda s, d, v, k: jransac.find_homography(
        s, d, v, k, method=method, reproj_threshold=3.0))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), keys)


def test_helpers_match_jax():
    src, dst, valid, _ = _batch(1)
    pn, tt = ransac._normalise_points(t(src), t(valid))
    for i in range(len(src)):
        jpn, jt = jransac._normalise_points(jnp.asarray(src[i]),
                                            jnp.asarray(valid[i]))
        np.testing.assert_allclose(n(pn)[i][valid[i]], np.asarray(jpn)[valid[i]],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(n(tt)[i], np.asarray(jt), rtol=1e-5)
    rng = np.random.default_rng(2)
    samp = rng.integers(0, 200, (3, 16, 4))
    samp[:, 0] = [5, 5, 6, 7]  # repeated index
    s4 = n(pn)[np.arange(3)[:, None, None], samp]
    d4 = np.asarray(dst)[np.arange(3)[:, None, None], samp] / 100.0
    ok = n(ransac._sample_ok(t(samp), t(src), t(dst), t(valid).sum(-1)))
    jok = np.asarray(jax.vmap(jransac._sample_ok, in_axes=(0, 0, 0, 0))(
        jnp.asarray(samp), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(valid.sum(-1))))
    np.testing.assert_array_equal(ok, jok)
    assert not ok[:, 0].any() and ok.mean() > 0.8
    # the solve of every sample checkSubset accepts (a repeated index
    # makes the system singular: non-finite in the port, and rejected
    # before it is used in both packages)
    got = n(ransac._solve_h_4pt(t(s4), t(d4)))
    want = np.asarray(jax.vmap(jax.vmap(jransac._solve_h_4pt))(
        jnp.asarray(s4), jnp.asarray(d4)))
    assert not np.isfinite(got[:, 0]).all()
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-3, atol=1e-3)
    h0 = np.stack([_truth(k) for k in range(3)]).astype(np.float32)
    np.testing.assert_allclose(
        n(ransac._sq_reproj_error(t(h0), t(src), t(dst))),
        np.asarray(jax.vmap(jransac._sq_reproj_error)(
            jnp.asarray(h0), jnp.asarray(src), jnp.asarray(dst))),
        rtol=1e-4, atol=1e-3)
    w = valid.astype(np.float32)
    dlt = n(ransac._dlt_least_squares(pn, ransac._normalise_points(
        t(dst), t(valid))[0], t(w)))
    jdlt = np.asarray(jax.vmap(jransac._dlt_least_squares)(
        jnp.asarray(n(pn)), jnp.asarray(n(ransac._normalise_points(
            t(dst), t(valid))[0])), jnp.asarray(w)))
    np.testing.assert_allclose(dlt, jdlt, atol=1e-3)
    ref = n(ransac._gauss_newton_refine(t(h0), t(src), t(dst), t(w)))
    jref = np.asarray(jax.vmap(jransac._gauss_newton_refine)(
        jnp.asarray(h0), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    for i in range(3):
        np.testing.assert_allclose(_corners(ref[i]), _corners(jref[i]),
                                   atol=0.05)


def test_method0_matches_jax():
    src, dst, valid, truths = _batch(3, outlier_fracs=(0.0, 0.0), noise=0.3)
    got = ransac.find_homography(t(src), t(dst), t(valid),
                                 torch.Generator().manual_seed(0), method=0)
    want = _jax_find(src, dst, valid, 0)
    np.testing.assert_array_equal(n(got.ok), np.asarray(want.ok))
    assert n(got.ok).all()
    np.testing.assert_array_equal(n(got.num_inliers), np.asarray(want.num_inliers))
    np.testing.assert_allclose(n(got.h), np.asarray(want.h), atol=1e-3)
    for i in range(2):
        np.testing.assert_allclose(_corners(n(got.h)[i]),
                                   _corners(np.asarray(want.h)[i]), atol=0.05)


def test_lmeds_selection_matches_jax_formula():
    """Same hypotheses and errors: the same pick and threshold as
    libstacker_tpu/ops/ransac.py:264-274."""
    rng = np.random.default_rng(6)
    b, s, m = 3, 64, 90
    h_px = rng.normal(size=(b, s, 3, 3)).astype(np.float32)
    errs = (rng.random((b, s, m)) * 50).astype(np.float32)
    count = np.array([90, 57, 12])
    for i, c in enumerate(count):
        errs[i, :, c:] = 1e18
    ok = rng.random((b, s)) > 0.2

    def jax_select(h_px, errs, ok_samp, count):
        countf = jnp.maximum(count.astype(jnp.float32), 1.0)
        errs_sorted = jnp.sort(errs, axis=1)
        med_idx = jnp.maximum((count - 1) // 2, 0)
        scores = errs_sorted[:, med_idx]
        scores = jnp.where(ok_samp, scores, np.float32(1e18))
        best = jnp.argmin(scores)
        med = scores[best]
        sigma = 2.5 * 1.4826 * (
            1.0 + 5.0 / jnp.maximum(countf - 4.0, 1.0)) * jnp.sqrt(med)
        return h_px[best], jnp.maximum(sigma * sigma, 1e-12)

    got_h, got_thr = ransac._lmeds_select(t(h_px), t(errs), t(ok), t(count))
    want_h, want_thr = jax.vmap(jax_select)(
        jnp.asarray(h_px), jnp.asarray(errs), jnp.asarray(ok),
        jnp.asarray(count))
    np.testing.assert_array_equal(n(got_h), np.asarray(want_h))
    np.testing.assert_allclose(n(got_thr), np.asarray(want_thr), rtol=1e-6)


@pytest.mark.parametrize("method", [constants.RANSAC, constants.LMEDS])
def test_robust_methods_statistical(method):
    assert method in (jconstants.RANSAC, jconstants.LMEDS)
    src, dst, valid, truths = _batch(11)
    got = ransac.find_homography(t(src), t(dst), t(valid),
                                 torch.Generator().manual_seed(0),
                                 method=method)
    want = _jax_find(src, dst, valid, method)
    assert n(got.ok).all() and np.asarray(want.ok).all()
    for i, h_true in enumerate(truths):
        c_got = _corners(n(got.h)[i])
        assert np.abs(c_got - _corners(h_true)).max() < 0.5
        assert np.abs(c_got - _corners(np.asarray(want.h)[i])).max() < 0.5
    ninl, jninl = n(got.num_inliers), np.asarray(want.num_inliers)
    assert (np.abs(ninl - jninl) <= 0.05 * jninl).all()
    assert not n(got.inliers)[:, -40:].any()  # padding is never an inlier


def test_too_few_and_degenerate_points():
    rng = np.random.default_rng(2)
    src = rng.uniform(0, 100, (2, 8, 2)).astype(np.float32)
    valid = np.zeros((2, 8), bool)
    valid[0, :3] = True  # 3 points: no model
    res = ransac.find_homography(t(src), t(src), t(valid),
                                 torch.Generator().manual_seed(0))
    assert not n(res.ok).any()
    # a collinear cloud carrying 24 off-line points: a sane estimate
    tt = rng.uniform(0, 1000, 120)
    line = np.stack([tt, 0.5 * tt + 20.0], axis=1)
    pts = np.concatenate([line, rng.uniform(0, 1000, (24, 2))]).astype(np.float32)
    h_true = np.array([[1.01, 0.02, 4.0], [-0.01, 0.98, 2.0], [0, 0, 1.0]])
    p = np.c_[pts, np.ones(len(pts))] @ h_true.T
    dst = (p[:, :2] / p[:, 2:]).astype(np.float32)
    res = ransac.find_homography(t(pts[None]), t(dst[None]),
                                 t(np.ones((1, len(pts)), bool)),
                                 torch.Generator().manual_seed(4))
    assert n(res.ok).all()
    proj = np.c_[pts, np.ones(len(pts))] @ n(res.h)[0].astype(np.float64).T
    assert np.abs(proj[:, :2] / proj[:, 2:] - dst).max() < 1.0


def _one_read_loop(p, gen, thresh_sq, max_iters=2000, confidence=0.995):
    """RANSAC's adaptive loop reading the active mask before every slab
    (the port's former loop): ``(best_h, slabs run)``."""
    bsz = p.valid.shape[0]
    countf = torch.clamp(p.count.to(torch.float32), min=1.0)
    log_conf = float(np.float32(
        math.log(max(1.0 - float(np.float32(confidence)), 1e-12))))

    def needed_iters(best_ninl):
        w = best_ninl.to(torch.float32) / countf
        denom = torch.log(torch.clamp(1.0 - w ** 4, min=1e-30))
        need = torch.where(best_ninl >= 4, torch.ceil(log_conf / denom),
                           torch.full_like(w, float(max_iters)))
        return torch.clamp(need, 1.0, float(max_iters)).to(torch.int64)

    best_h = ransac._eye((bsz,), "cpu")
    best_ninl = torch.full((bsz,), -1, dtype=torch.int64)
    done = torch.zeros(bsz, dtype=torch.int64)
    lanes = torch.arange(bsz)
    slabs = 0
    while True:
        active = done < torch.clamp(needed_iters(best_ninl), max=max_iters)
        if not bool(active.any()):
            return best_h, slabs
        h_px, errs, ok_samp = ransac._hypotheses(p, gen, ransac._SLAB)
        n_inl = (errs <= thresh_sq).sum(-1)
        n_inl = torch.where(ok_samp, n_inl, torch.full_like(n_inl, -1))
        sbest = torch.argmax(n_inl, dim=-1)
        top = n_inl[lanes, sbest]
        better = active & (top > best_ninl)
        best_h = torch.where(better[:, None, None], h_px[lanes, sbest],
                             best_h)
        best_ninl = torch.where(active, torch.maximum(best_ninl, top),
                                best_ninl)
        done = done + ransac._SLAB * active.to(torch.int64)
        slabs += 1


def _staggered():
    """Lanes that stop after different numbers of slabs: inlier shares
    of 0.95, 0.45 and 0.27 (1, 2 and 9 slabs of 128 at confidence
    0.995, each lane alone) and a lane of 3 valid points (16 slabs, up
    to 2000 hypotheses)."""
    src, dst, valid, _ = _batch(21, outlier_fracs=(0.05, 0.55, 0.73, 0.0))
    valid[3, 3:] = False
    return t(src), t(dst), t(valid)


@pytest.mark.parametrize("seed", [1, 2, 3, 16])
def test_chunked_loop_equals_one_read_a_slab(monkeypatch, seed):
    """The loop that reads after each slab and not before the first
    against the one that reads before every slab: the same bits, the
    same generator state, one read a slab."""
    src, dst, valid = _staggered()
    p = ransac._points(src, dst, valid)
    thresh_sq = 9.0
    g_old = torch.Generator().manual_seed(seed)
    want_h, want_slabs = _one_read_loop(p, g_old, thresh_sq)
    assert want_slabs == 16  # the 3-point lane runs to max_iters
    reads = []
    real_read = ransac._still_active

    def counted(active):
        reads.append(active.shape)
        return real_read(active)

    monkeypatch.setattr(ransac, "_still_active", counted)
    g_new = torch.Generator().manual_seed(seed)
    got_h, got_slabs = ransac._adaptive_best(p, g_new, thresh_sq, 2000,
                                             0.995)
    assert torch.equal(got_h, want_h)
    assert torch.equal(g_new.get_state(), g_old.get_state())
    assert got_slabs == want_slabs == len(reads)
    assert set(reads) == {(4,)}


@pytest.mark.parametrize("max_iters,bsz", [(0, 4), (2000, 0)])
def test_loop_runs_no_slab_with_nothing_to_draw(max_iters, bsz):
    """No budget or no lane: no slab, no read, no draw, as the loop
    that reads before every slab."""
    src, dst, valid = (x[:bsz] for x in _staggered())
    p = ransac._points(src, dst, valid)
    g_old = torch.Generator().manual_seed(5)
    want_h, want_slabs = _one_read_loop(p, g_old, 9.0, max_iters)
    g_new = torch.Generator().manual_seed(5)
    got_h, got_slabs = ransac._adaptive_best(p, g_new, 9.0, max_iters,
                                             0.995)
    assert got_slabs == want_slabs == 0
    assert torch.equal(got_h, want_h)
    assert torch.equal(g_new.get_state(), g_old.get_state())


@pytest.mark.parametrize("fracs,seed", [
    ((0.05, 0.55, 0.73, 0.0), 1), ((0.05, 0.55, 0.73, 0.0), 4),
    ((0.3, 0.5, 0.2), 1), ((0.0, 0.0), 2)])
def test_chunked_answer_equals_one_read_a_slab(monkeypatch, fracs, seed):
    """The whole estimate, loop and refit, with the former loop swapped
    in: the same bits, and the same generator state after it."""
    src, dst, valid, _ = _batch(31, outlier_fracs=fracs)
    g_new = torch.Generator().manual_seed(seed)
    got = ransac.find_homography(t(src), t(dst), t(valid), g_new)
    monkeypatch.setattr(
        ransac, "_adaptive_best",
        lambda p, g, th, mi, conf, timer=None: _one_read_loop(p, g, th, mi,
                                                              conf))
    g_old = torch.Generator().manual_seed(seed)
    want = ransac.find_homography(t(src), t(dst), t(valid), g_old)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(g_new.get_state(), g_old.get_state())


@pytest.mark.parametrize("method", [constants.LMEDS, 0])
def test_lmeds_and_least_squares_unchanged(method):
    """LMEDS and method 0 compose the helpers as they did."""
    src, dst, valid, _ = _batch(41, outlier_fracs=(0.2, 0.0))
    s, d, v = t(src), t(dst), t(valid)
    got = ransac.find_homography(s, d, v, torch.Generator().manual_seed(2),
                                 method=method)
    p = ransac._points(s, d, v)
    g = torch.Generator().manual_seed(2)
    if method == 0:
        wts = v.to(torch.float32)
        h = ransac._normalise_h22(ransac._gauss_newton_refine(
            ransac._normalise_h22(p.t_dst_inv @ ransac._dlt_least_squares(
                p.src_n, p.dst_n, wts) @ p.t_src), s, d, wts))
        assert torch.equal(got.h, h) and torch.equal(got.inliers, v)
        return
    best_h, thr = ransac._lmeds_select(*ransac._hypotheses(p, g, 1024),
                                       p.count)
    err = ransac._sq_reproj_error(best_h, s, d)
    inl = (err <= thr[:, None]) & v
    wts = inl.to(torch.float32)
    h_ls = ransac._normalise_h22(p.t_dst_inv @ ransac._dlt_least_squares(
        p.src_n, p.dst_n, wts) @ p.t_src)
    h = ransac._normalise_h22(ransac._gauss_newton_refine(h_ls, s, d, wts))
    assert torch.equal(got.h, h)
    assert torch.equal(got.inliers,
                       (ransac._sq_reproj_error(h, s, d) <= thr[:, None]) & v)


def test_normalisation_inverse_is_linalg_inv():
    """``inv_ex`` in place of ``linalg.inv`` (which synchronises on a
    card): the same bits, here and in ``warp.invert_3x3``."""
    from libstacker_tpu_torch.ops import warp

    src, dst, valid, _ = _batch(5)
    p = ransac._points(t(src), t(dst), t(valid))
    t_dst = ransac._normalise_points(t(dst), t(valid))[1]
    assert torch.equal(p.t_dst_inv, torch.linalg.inv(t_dst))
    m = torch.from_numpy(np.stack([_truth(k) for k in range(4)])).float()
    assert torch.equal(warp.invert_3x3(m), torch.linalg.inv(m))


def _sample_ok_by_loop(samp, src_pts, dst_pts, count):
    """checkSubset a pair and a triple at a time (the port's former
    form)."""
    a, b, c, d = samp.unbind(-1)
    ok = (a != b) & (a != c) & (a != d) & (b != c) & (b != d) & (c != d)
    ok = ok & (count >= 4)[:, None]
    eps = ransac._FLT_EPS
    for pts in (src_pts, dst_pts):
        p = ransac._gather_points(pts, samp)
        for i, j, k in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
            d1 = p[..., j, :] - p[..., i, :]
            d2 = p[..., k, :] - p[..., i, :]
            cross = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
            lim = eps * (d1[..., 0].abs() + d1[..., 1].abs()) * (
                d2[..., 0].abs() + d2[..., 1].abs())
            ok = ok & (cross.abs() > lim)
    return ok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_ok_stacked_equals_loop(seed):
    """The pairs and triples tested in one pass each: the same flags as
    one pass a pair and a triple, on integer grids full of repeats and
    collinear triples."""
    rng = np.random.default_rng(seed)
    grid = t(rng.integers(0, 12, (5, 40, 2)).astype(np.float32))
    cloud = t(rng.uniform(0, 100, (5, 40, 2)).astype(np.float32))
    samp = t(rng.integers(0, 40, (5, 128, 4)))
    count = t(np.array([0, 3, 4, 9, 40]))
    got = ransac._sample_ok(samp, grid, cloud, count)
    want = _sample_ok_by_loop(samp, grid, cloud, count)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < got.numel()
