"""PyTorch port vs libstacker_tpu: kernel B7 and the inverse-compositional
ECC solver (``mode='ic'``, ``EccMatchParameters.solver="ic"``).

Bars:

- B7's plain version (``ecc_cuda.ecc_ic_iteration_moments`` on CPU
  tensors) against the JAX package's ``ecc_ic_iteration_moments`` in
  interpret mode, the five motion / Gram cases of
  tests/test_ecc_pallas.py:373-410 at that test's bars (statistics rtol
  1e-5 / atol 1e-2, every moment rtol 5e-3 / atol 5e-2), and against the
  float64 oracle of tests/test_ecc_pallas.py:310-370 built on the JAX
  package's XLA warp at B1's group-norm bar (1e-4);
- the IC solve on tests/test_ecc_pallas.py:416-462's content: the truth
  within 0.05 px, the JAX package's IC solve (``LIBSTACKER_FORCE_PALLAS``
  plus ``LIBSTACKER_ECC_INTERPRET``) within 0.06 on the warp and 1e-3 on
  rho;
- the divergence case of :465-501: the rho guard fails the lane, the
  forward rescue re-solves it, and it ends ``ok=False``, rho -1, as
  forward (and cv2) end;
- the pipeline's ``solver="ic"`` against the JAX package's stack
  (tests/test_pipeline_ecc.py:89-111, interior within 0.02).
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
from _torch_parity import n, t  # noqa: E402
from libstacker_tpu.ops import ecc as jecc  # noqa: E402
from libstacker_tpu.ops import ecc_pallas as jpallas  # noqa: E402
from libstacker_tpu.ops import filters as jfilters  # noqa: E402
from libstacker_tpu.ops import warp as jwarp  # noqa: E402
from libstacker_tpu.params import MotionType as JMotion  # noqa: E402
from libstacker_tpu_torch import MotionType  # noqa: E402
from libstacker_tpu_torch.ops import ecc, ecc_cuda  # noqa: E402

torch.set_num_threads(2)


def _xla_ic_moments(tmpl, image_f, m3, motion, with_hessian):
    """tests/test_ecc_pallas.py's float64 IC oracle on the JAX package's
    XLA warp and validity mask."""
    h, w = image_f.shape
    jm = jnp.asarray(m3)
    if motion == JMotion.Homography:
        imw = jwarp.warp_perspective(jnp.asarray(image_f), jm, (h, w),
                                     inverse_map=True)
    else:
        imw = jwarp.warp_affine(jnp.asarray(image_f), jm[:2], (h, w),
                                inverse_map=True)
    imw = np.asarray(imw, np.float64)
    mask = np.asarray(jwarp.warp_valid_mask(jm, (h, w), (h, w)), np.float64)
    tt = np.asarray(tmpl, np.float64)
    gtx = np.zeros_like(tt)
    gty = np.zeros_like(tt)
    gtx[:, 1:-1] = 0.5 * (tt[:, 2:] - tt[:, :-2])
    gty[1:-1, :] = 0.5 * (tt[2:, :] - tt[:-2, :])
    xs = np.arange(w, dtype=np.float64)[None, :] * np.ones((h, 1))
    ys = np.arange(h, dtype=np.float64)[:, None] * np.ones((1, w))
    if motion == JMotion.Translation:
        jac = [gtx, gty]
    elif motion == JMotion.Euclidean:
        jac = [gty * xs - gtx * ys, gtx, gty]
    elif motion == JMotion.Affine:
        jac = [gtx * xs, gty * xs, gtx * ys, gty * ys, gtx, gty]
    else:
        s = xs * gtx + ys * gty
        jac = [gtx * xs, gty * xs, -s * xs, gtx * ys, gty * ys, -s * ys,
               gtx, gty]
    p = len(jac)
    jm_ = [j * mask for j in jac]
    out = [mask.sum(), (mask * imw).sum(), (mask * imw * imw).sum(),
           (mask * tt).sum(), (mask * tt * tt).sum(), (mask * tt * imw).sum()]
    out += [(j * imw).sum() for j in jm_]
    out += [j.sum() for j in jm_]
    out += [(j * tt).sum() for j in jm_]
    if with_hessian:
        out += [(jm_[a] * jac[b]).sum() for a in range(p) for b in range(a, p)]
    return np.asarray(out)


def _group_rel(got, want, p):
    bounds = [(k, k + 1) for k in range(6)]
    bounds += [(6, 6 + p), (6 + p, 6 + 2 * p), (6 + 2 * p, 6 + 3 * p),
               (6 + 3 * p, got.shape[-1])]
    return max(float(np.abs(got[lo:hi] - want[lo:hi]).max()
                     / (np.abs(want[lo:hi]).max() + 1e-6))
               for lo, hi in bounds if hi > lo)


@pytest.mark.parametrize("motion,with_hessian", [
    ("Translation", True), ("Euclidean", False), ("Affine", True),
    ("Homography", True), ("Homography", False),
])
def test_ic_moments_match_pallas_interpret(motion, with_hessian):
    rng = np.random.default_rng(57)
    h, w = 160, 384  # the smallest extent the TPU kernel's window takes
    img = cv2.GaussianBlur((rng.random((h, w)) * 255).astype(np.float32),
                           (0, 0), 2.0)
    image_f = np.asarray(jfilters.gaussian_blur(jnp.asarray(img), 5))
    tmpl = cv2.GaussianBlur((rng.random((h, w)) * 255).astype(np.float32),
                            (0, 0), 2.0)
    rot = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), 0.8, 1.003)
    rot[0, 2] += 2.25
    rot[1, 2] -= 1.5
    m3 = np.vstack([rot, [0, 0, 1]]).astype(np.float32)
    if motion == "Translation":
        m3 = np.eye(3, dtype=np.float32)
        m3[0, 2], m3[1, 2] = 3.25, -2.5
    persp = motion == "Homography"
    got = n(ecc_cuda.ecc_ic_iteration_moments(
        t(image_f), t(tmpl[None]), t(m3[None]), MotionType[motion],
        quant_affine=not persp, with_hessian=with_hessian))[0]
    want = np.asarray(jpallas.ecc_ic_iteration_moments(
        jnp.asarray(image_f), jnp.asarray(tmpl)[None], jnp.asarray(m3)[None],
        motion_type=JMotion[motion], quant_affine=not persp, interpret=True,
        with_hessian=with_hessian))[0]
    assert got.shape == want.shape == (
        ecc_cuda.moments_layout(MotionType[motion], with_hessian)[1],)
    np.testing.assert_allclose(got[:6], want[:6], rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-2)
    oracle = _xla_ic_moments(tmpl, image_f, m3, JMotion[motion], with_hessian)
    assert _group_rel(got, oracle, MotionType[motion].num_params) < 1e-4
    # B7 shares B1's layout: unpack_moments reads the entries the JAX
    # package's unpack_ic_moments does (its order puts the Gram last)
    (n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti, hess, j_i, j_m,
     j_mt) = ecc_cuda.unpack_moments(t(got[None]), MotionType[motion],
                                     with_hessian)
    parts = (n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti, j_i, j_m, j_mt)
    if with_hessian:
        parts += (hess,)
    jparts = jpallas.unpack_ic_moments(jnp.asarray(got[None]),
                                       JMotion[motion], with_hessian)
    assert len(parts) == len(jparts)
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_ic_moments_inactive_lane_and_checks():
    rng = np.random.default_rng(5)
    h, w = 40, 56
    src = t(rng.random((h, w)).astype(np.float32) * 255)
    tm = t(rng.random((2, h, w)).astype(np.float32) * 255)
    m3 = torch.eye(3).repeat(2, 1, 1)
    out = ecc_cuda.ecc_ic_iteration_moments(
        src, tm, m3, MotionType.Affine, quant_affine=True,
        active=torch.tensor([True, False]), with_hessian=True)
    assert tuple(out.shape) == (2, 6 + 18 + 21)
    assert bool((out[1] == 0).all()) and float(out[0, 0]) == h * w
    with pytest.raises(ValueError, match="src"):
        ecc_cuda.ecc_ic_iteration_moments(src[None], tm, m3,
                                          MotionType.Affine)
    with pytest.raises(ValueError, match="m3"):
        ecc_cuda.ecc_ic_iteration_moments(src, tm, m3[:1], MotionType.Affine)


def _kernel_sum_order(terms, fma_terms, rows=64, cols=128):
    """B7's summation (``csrc/ecc_ic_moments.cu``) of per-pixel float32
    terms [K, H, W] in float32: each column walks ``rows`` rows of its
    tile (a sum by ``__fmaf_rn`` where ``fma_terms[k]`` holds the two
    factors, else an add), a warp's 32 columns add by a butterfly tree,
    the 4 warps of a block in order, and the blocks' partials in
    float64."""
    k_n, h, w = terms.shape
    out = np.zeros(k_n, np.float64)
    for y0 in range(0, h, rows):
        acc = np.zeros((k_n, w), np.float32)
        for y in range(y0, min(y0 + rows, h)):
            for k in range(k_n):
                if fma_terms[k] is None:
                    acc[k] = acc[k] + terms[k, y]
                else:
                    a, b = fma_terms[k]
                    acc[k] = (a[y].astype(np.float64) * b[y]
                              + acc[k]).astype(np.float32)
        for x0 in range(0, w, cols):
            block = np.zeros((k_n, cols), np.float32)
            block[:, : min(cols, w - x0)] = acc[:, x0 : x0 + cols]
            warps = []
            for wi in range(cols // 32):
                v = block[:, wi * 32 : wi * 32 + 32]
                while v.shape[1] > 1:
                    half = v.shape[1] // 2
                    v = v[:, :half] + v[:, half:]
                warps.append(v[:, 0])
            part = warps[0]
            for v in warps[1:]:
                part = part + v
            out += part.astype(np.float64)
    return out


@pytest.mark.parametrize("with_hessian", [False, True])
def test_ic_kernel_sum_order_within_bar(with_hessian):
    """B7 sums each column's 64 rows with fused multiply-adds in float32,
    then reduces in a fixed tree: emulated on the plain version's float32
    terms, the moments stay within B1's group-norm bar (1e-4) of their
    float64 sums, for a homography lane over three 64-row tiles and three
    128-column tiles."""
    rng = np.random.default_rng(29)
    h, w = 150, 300
    src = t(cv2.GaussianBlur(rng.random((h, w)).astype(np.float32) * 255,
                             (0, 0), 2.0))
    tmpl = t(cv2.GaussianBlur(rng.random((h, w)).astype(np.float32) * 255,
                              (0, 0), 2.0))
    a = np.radians(0.4)
    m = torch.tensor([[np.cos(a), -np.sin(a), 2.5], [np.sin(a), np.cos(a),
                      -1.5], [1e-5, -2e-5, 1.0]], dtype=torch.float32)
    from libstacker_tpu_torch.ops import warp as pwarp

    imw = n(pwarp.warp_inverse(src, m, (h, w)))
    mask = n(pwarp.warp_valid_mask(m, (h, w), (h, w))).astype(np.float32)
    gtx, gty = ecc_cuda._template_gradients(tmpl)
    ys = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    ident = torch.eye(3).reshape(-1)
    jac = [n(j) for j in ecc_cuda._jacobian(MotionType.Homography, gtx, gty,
                                           xs, ys, xs, ys, ident)]
    tm = n(tmpl)
    jm = [j * mask for j in jac]
    mi, mt = mask * imw, mask * tm
    terms = [mask, mi, mi * imw, mt, mt * tm, mt * imw]
    fmas = [None, None, (mi, imw), None, (mt, tm), (mt, imw)]
    terms += [j * imw for j in jm] + jm + [j * tm for j in jm]
    fmas += [(j, imw) for j in jm] + [None] * 8 + [(j, tm) for j in jm]
    if with_hessian:
        for p_ in range(8):
            for q in range(p_, 8):
                terms.append(jm[p_] * jm[q])
                fmas.append((jm[p_], jm[q]))
    terms = np.stack(terms).astype(np.float32)
    got = _kernel_sum_order(terms, fmas)
    want = terms.astype(np.float64).sum(axis=(1, 2))
    np.testing.assert_allclose(
        want, n(ecc_cuda.ecc_ic_iteration_moments_reference(
            src, tmpl[None], m[None], MotionType.Homography,
            with_hessian=with_hessian))[0], rtol=1e-6, atol=1e-3)
    rel = _group_rel(got, want, 8)
    assert rel < 1e-4, rel


def _shift_pair(h=192, w=512):
    rng = np.random.default_rng(61)
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.float32), (0, 0), 1.5
    ).astype(np.uint8)
    shifts = [(2.0, -1.0), (-1.75, 1.25)]
    tmpls = []
    for dx, dy in shifts:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(base, m, (w * 2, h * 2),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        tmpls.append(cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w])
    ref = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
    return (np.stack(tmpls).astype(np.float32), ref.astype(np.float32),
            np.asarray(shifts, np.float32))


@pytest.mark.parametrize("motion", ["Translation", "Homography"])
def test_ic_solve_matches_jax_and_truth(monkeypatch, motion):
    tm, ref, truth = _shift_pair()
    kw = dict(num_iters=50, eps=1e-5, gauss_filt_size=5)
    got = ecc.find_transform_ecc_batched(t(tm), t(ref), MotionType[motion],
                                         mode="ic", **kw)
    fwd = ecc.find_transform_ecc_batched(t(tm), t(ref), MotionType[motion],
                                         **kw)
    monkeypatch.setenv("LIBSTACKER_FORCE_PALLAS", "1")
    monkeypatch.setenv("LIBSTACKER_ECC_INTERPRET", "1")
    want = jecc.find_transform_ecc_batched(
        jnp.asarray(tm), jnp.asarray(ref), JMotion[motion], mode="ic", **kw)
    assert n(got.ok).all() and np.asarray(want.ok).all()
    wm = n(got.warp_matrix)
    np.testing.assert_allclose(wm[:, :2, 2], truth, atol=0.05)
    np.testing.assert_allclose(wm, np.asarray(want.warp_matrix), atol=0.06)
    np.testing.assert_allclose(n(got.rho), np.asarray(want.rho), atol=1e-3)
    # the two linearisation sides reach the same optimum
    np.testing.assert_allclose(n(got.rho), n(fwd.rho), atol=1e-3)
    if motion == "Homography":
        assert abs(float(wm[0, 2, 2]) - 1.0) < 1e-6  # renormalised


def test_ic_divergence_guard_matches_forward_verdict():
    """A pair cv2.findTransformECC aborts on: the IC rho guard fails the
    lane, the rescue re-solves it from its original init in forward
    mode, and the verdict is forward's (tests/test_ecc_pallas.py:465)."""
    rng = np.random.default_rng(9)
    h, w = 480, 640
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.float32), (0, 0), 2.5)

    def frame(ang, dx, dy):
        m = cv2.getRotationMatrix2D((w, h), ang, 1.0)
        m[0, 2] += dx
        m[1, 2] += dy
        cur = cv2.warpAffine(base, m, (w * 2, h * 2), flags=cv2.INTER_LINEAR)
        c = cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w][:192, :512]
        return c + rng.normal(0, 12, c.shape).astype(np.float32)

    f0 = frame(-1.1, 3.0, -2.0)
    f2 = frame(1.2, -4.0, 4.0)
    kw = dict(num_iters=60, eps=1e-4)
    want = jecc.find_transform_ecc_batched(
        jnp.asarray(f2)[None], jnp.asarray(f0), JMotion.Euclidean, **kw)
    assert not bool(np.asarray(want.ok)[0])
    fwd = ecc.find_transform_ecc_batched(t(f2[None]), t(f0),
                                         MotionType.Euclidean, **kw)
    assert not bool(fwd.ok[0])
    ecc.rescued_lane_count = 0
    got = ecc.find_transform_ecc_batched(t(f2[None]), t(f0),
                                         MotionType.Euclidean, mode="ic", **kw)
    assert ecc.rescued_lane_count == 1
    assert not bool(got.ok[0]) and float(got.rho[0]) == -1.0
    # the rescue is forward's solve from the same init: same iterate
    np.testing.assert_array_equal(n(got.warp_matrix), n(fwd.warp_matrix))
    assert int(got.num_iters[0]) == int(fwd.num_iters[0])


def test_compose_warp_ic_matches_jax():
    rng = np.random.default_rng(4)
    for motion in MotionType:
        p = motion.num_params
        rows = 3 if motion == MotionType.Homography else 2
        m = np.eye(3, dtype=np.float32)[:rows][None].repeat(3, 0)
        m[:, 0, 2] = rng.uniform(-3, 3, 3)
        if motion != MotionType.Translation:
            a = rng.uniform(-0.02, 0.02, 3)
            m[:, 0, 0] = m[:, 1, 1] = np.cos(a)
            m[:, 1, 0], m[:, 0, 1] = np.sin(a), -np.sin(a)
        dp = (rng.uniform(-1, 1, (3, p)) * (1e-3 if p > 3 else 0.3)).astype(
            np.float32)
        got = n(ecc._compose_warp_ic(motion, t(m), t(dp)))
        want = np.stack([np.asarray(jecc._compose_warp_ic(
            JMotion[motion.name], jnp.asarray(m[i]), jnp.asarray(dp[i])))
            for i in range(3)])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pipeline_ic_matches_jax():
    """``solver="ic"`` through ecc_match_arrays: the stack of the JAX
    package's default solver (tests/test_pipeline_ecc.py:89-111)."""
    rng = np.random.default_rng(71)
    h, w = 192, 512
    base = cv2.GaussianBlur(rng.random((h * 2, w * 2)).astype(np.float32),
                            (0, 0), 3.0)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(
        np.uint8)
    frames = []
    for dx, dy in [(0.0, 0.0)] + [tuple(rng.uniform(-3, 3, 2)) for _ in range(2)]:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(base, m, (w * 2, h * 2),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        frames.append(np.stack([cur[h // 2 : h // 2 + h,
                                    w // 2 : w // 2 + w]] * 3, -1))
    frames = np.stack(frames)
    kw = dict(motion_type=J.MotionType.Translation, max_count=50,
              epsilon=1e-4, gauss_filt_size=5)
    want = J.ecc_match_arrays(frames, J.EccMatchParameters(**kw))
    got, st = P.ecc_match_arrays(
        frames, P.EccMatchParameters(**{**kw, "motion_type":
                                        P.MotionType.Translation},
                                     solver="ic"),
        return_stats=True, device="cpu")
    assert st.frames_kept == 3
    assert np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02
