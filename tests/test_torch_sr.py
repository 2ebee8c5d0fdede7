"""PyTorch port vs libstacker_tpu: super-resolution stacking (kernel B6's
plain version, ``ops/stack.super_res_stack``, ``output_scale > 1`` on
both pipelines).

Bars (tests/test_stack.py:371-410, tests/test_warp_accum.py:235-260,
tests/test_stack.py:413-442):

- ``super_res_stack`` against the JAX package's XLA formulation and its
  Pallas kernel in interpret mode: values off by more than 1e-4 on at
  most 1e-3 of the image, median difference < 1e-6 (a nearest tap flips
  only where a coordinate sits on a .5 boundary and the two float32
  inverses differ by an ulp);
- the hole-fallback form (sigma 0.1) against the XLA path at the same
  bars;
- on a near-Nyquist target the deposit recovers more contrast than the
  bilinear mean (tests/test_stack.py:305-368's bars);
- ``output_scale=2`` through ``keypoint_match_arrays`` and
  ``ecc_match_arrays``: the shape, the JAX package's image at the bars
  above (interior), and the 2x2 box mean against the mean stack within
  0.02 (the keypoint path's RANSAC draws differ between the packages, so
  there the two SR images are held to a mean abs of 0.01); ``n == 1``
  upsamples frame 0 as the JAX package does (1e-6); the
  SR + BORDER_REPLICATE guard and the SR + sigma-clip ``validate()``
  error carry the JAX package's messages;
- the image form's plain version (``sr_cuda.sr_image_reference``, what
  CUDA's one launch computes) against ``super_res_stack``'s CPU route:
  bitwise where both sum the frames in one chunk, within 4 ulp of 1.0
  where the CPU route adds chunks; against the JAX package at the bars
  above (x2 and the fallback form);
- B6's launch plan (``sr_cuda.launch_plan``) covers every fine pixel once
  and picks 16-byte stores only where aligned.
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
from libstacker_tpu import errors as jerrors  # noqa: E402
from libstacker_tpu.ops import stack as jstack  # noqa: E402
from libstacker_tpu_torch import constants, errors  # noqa: E402
from libstacker_tpu_torch.ops import color, sr_cuda, stack, warp  # noqa: E402

torch.set_num_threads(2)


def _flip_bounded(got, want):
    d = np.abs(n(got) - np.asarray(want))
    assert (d > 1e-4).mean() <= 1e-3, (d > 1e-4).mean()
    assert np.median(d) < 1e-6, np.median(d)


@pytest.fixture(scope="module")
def sr_case():
    """tests/test_stack.py:375-391: 5 rolled 192x512 frames, sub-pixel
    shifts, lane 3 dropped."""
    rng = np.random.default_rng(31)
    n_f, h, w = 5, 192, 512
    base = cv2.GaussianBlur(
        rng.integers(0, 256, (h, w, 3), np.uint8).astype(np.uint8),
        (0, 0), 1.2)
    frames = np.stack([base] + [
        np.roll(base, (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))),
                (0, 1))
        for _ in range(n_f - 1)])
    mats = np.stack([np.eye(3, dtype=np.float32)] * (n_f - 1))
    for i in range(n_f - 1):
        mats[i, 0, 2] = 0.6 * i - 1.2 + 0.37
        mats[i, 1, 2] = -0.45 * i + 0.8 + 0.21
    oks = np.ones(n_f - 1, bool)
    oks[3] = False
    return frames, mats, oks


@pytest.fixture(scope="module")
def jax_sr(sr_case):
    """The JAX package's results: XLA for factors 2 and 3 and sigma 0.1,
    the Pallas kernel in interpret mode for factors 2 and 3."""
    import os

    frames, mats, oks = sr_case
    args = (jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks))
    out = {}
    for factor in (2, 3):
        out["xla", factor] = np.asarray(jstack.super_res_stack(
            *args, factor=factor, perspective=True, chunk=3))
    out["xla-fallback", 2] = np.asarray(jstack.super_res_stack(
        *args, factor=2, kernel_sigma=0.1, perspective=True, chunk=3))
    env = {"LIBSTACKER_FORCE_PALLAS": "1", "LIBSTACKER_WARP_INTERPRET": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for factor in (2, 3):
            out["pallas", factor] = np.asarray(jstack.super_res_stack(
                *args, factor=factor, perspective=True, chunk=3))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return out


@pytest.mark.parametrize("factor", [2, 3])
@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_super_res_matches_jax(sr_case, jax_sr, factor, path):
    frames, mats, oks = sr_case
    got = stack.super_res_stack(t(frames), t(mats), t(oks), factor=factor,
                                perspective=True, chunk=3)
    assert tuple(got.shape) == (factor * 192, factor * 512, 3)
    _flip_bounded(got, jax_sr[path, factor])


def test_super_res_fallback_form_matches_jax(sr_case, jax_sr):
    frames, mats, oks = sr_case
    got = stack.super_res_stack(t(frames), t(mats), t(oks), factor=2,
                                kernel_sigma=0.1, perspective=True, chunk=3)
    _flip_bounded(got, jax_sr["xla-fallback", 2])


def test_super_res_non_aligned_size(monkeypatch):
    """tests/test_warp_accum.py:235-260 at 161x400, against the XLA path
    and the Pallas kernel in interpret mode."""
    h, w = 161, 400
    rng = np.random.default_rng(59)
    base = rng.integers(0, 256, (h, w, 3), np.uint8)
    frames = np.stack([base] + [np.roll(base, (1, -2 + i), (0, 1))
                                for i in range(2)])
    mats = np.stack([np.eye(3, dtype=np.float32)] * 2)
    mats[0, 0, 2] = 0.4
    mats[1, 1, 2] = -0.55
    oks = np.ones(2, bool)
    args = (jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks))
    want = np.asarray(jstack.super_res_stack(*args, factor=2, chunk=3))
    got = stack.super_res_stack(t(frames), t(mats), t(oks), factor=2)
    _flip_bounded(got, want)
    monkeypatch.setenv("LIBSTACKER_FORCE_PALLAS", "1")
    monkeypatch.setenv("LIBSTACKER_WARP_INTERPRET", "1")
    d = np.abs(n(got) - np.asarray(jstack.super_res_stack(
        *args, factor=2, chunk=3)))
    assert (d > 1e-4).mean() <= 1e-3, (d > 1e-4).mean()


def test_sr_deposit_plain_version(sr_case):
    """u8 and float32 sources deposit bitwise alike, frame 0 weighs on
    every fine pixel, a dropped lane deposits nothing, and the guards
    raise."""
    frames, mats, oks = sr_case
    fr = t(frames)
    mats_all, oks_all = stack._prepare_lanes(t(mats), t(oks), fr.device)
    minv = torch.linalg.inv(mats_all)
    a = sr_cuda.sr_deposit(fr, minv, oks_all, 2, 0.3, True, True)
    b = sr_cuda.sr_deposit(color.to_unit_f32(fr), minv, oks_all, 2, 0.3,
                           True, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[1].min()) > 1e-6  # frame 0 covers every fine pixel
    dropped = sr_cuda.sr_deposit(fr[4:], minv[4:], oks_all[4:], 2, 0.3)
    assert float(dropped[1].abs().max()) == 0.0
    with pytest.raises(ValueError, match="kernel_sigma"):
        sr_cuda.sr_deposit(fr, minv, oks_all, 2, 0.0)
    with pytest.raises(ValueError, match="minv"):
        sr_cuda.sr_deposit(fr, minv[:2], oks_all, 2, 0.3)
    with pytest.raises(ValueError, match="factor"):
        stack.super_res_stack(fr, t(mats), t(oks), factor=5)


def _sr_inputs(sr_case, n_frames=None):
    """The burst, inverse maps and flags ``super_res_stack`` hands B6."""
    frames, mats, oks = sr_case
    fr = t(frames[:n_frames])
    k = fr.shape[0] - 1
    mats_all, oks_all = stack._prepare_lanes(t(mats[:k]), t(oks[:k]), fr.device)
    return fr, mats, oks, warp.invert_3x3(mats_all).contiguous(), oks_all


@pytest.mark.parametrize("sigma", [0.3, 0.1])
@pytest.mark.parametrize("n_frames,chunk", [(3, 3), (5, 5), (5, 2)])
def test_sr_image_reference_matches_cpu_route(sr_case, sigma, n_frames,
                                              chunk):
    """The image form's plain version (one sum over the burst, then the
    normalisation) against ``super_res_stack``'s CPU route (sums added
    per chunk of frames, then the same normalisation).  One chunk sums
    the frames in the same order: bitwise.  Several chunks regroup the
    float32 sums of at most 5 weights per fine pixel (each <= 1) and of
    their weighted values: within 4 ulp of 1.0 (4.8e-7)."""
    fr, mats, oks, minv, oks_all = _sr_inputs(sr_case, n_frames)
    k = n_frames - 1
    want = stack.super_res_stack(fr, t(mats[:k]), t(oks[:k]), factor=2,
                                 kernel_sigma=sigma, perspective=True,
                                 chunk=chunk)
    got = sr_cuda.sr_image_reference(fr, minv, oks_all, 2, sigma, True,
                                     sigma < 0.15)
    assert got.shape == want.shape == (2 * 192, 2 * 512, 3)
    if chunk >= n_frames:
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 4 * 2.0 ** -23
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(sr_cuda.sr_image(fr, minv, oks_all, 2, sigma, True,
                                        sigma < 0.15), got)


@pytest.mark.parametrize("path,sigma", [("xla", 0.3), ("pallas", 0.3),
                                        ("xla-fallback", 0.1)])
def test_sr_image_reference_matches_jax(sr_case, jax_sr, path, sigma):
    """The image form's plain version against the JAX package's
    ``super_res_stack`` at x2, at ``_flip_bounded``'s bar."""
    fr, _, _, minv, oks_all = _sr_inputs(sr_case)
    got = sr_cuda.sr_image_reference(fr, minv, oks_all, 2, sigma, True,
                                     sigma < 0.15)
    _flip_bounded(got, jax_sr[path, 2])


@pytest.mark.parametrize("sigma,ok", [(0.3, True), (1e-19, True),
                                      (5e-20, False), (1e19, False)])
def test_sr_sigma_range(sr_case, sigma, ok):
    """Both B6 forms take a sigma whose float32 2 sigma^2 is a normal
    number below 2^126 (the kernel's divide relies on it) and refuse
    others on every device."""
    fr, _, _, minv, oks_all = _sr_inputs(sr_case, 2)
    for fn in (sr_cuda.sr_deposit, sr_cuda.sr_image):
        if ok:
            fn(fr[:, :8, :8], minv, oks_all, 2, sigma)
        else:
            with pytest.raises(ValueError, match="kernel_sigma out of range"):
                fn(fr[:, :8, :8], minv, oks_all, 2, sigma)


def _covered(blocks, rows, cols, px, threads=256):
    """Emulate a thread -> (row, first column, pixels) map of a plan: ->
    (rows, first columns, pixel counts) of the active threads, and how
    often each pixel of the ``rows x cols`` grid is written."""
    qpr = -(-cols // px)
    q = np.arange(blocks * threads)
    q = q[q < rows * qpr]
    y = q // qpr
    x0 = (q - y * qpr) * px
    npx = np.minimum(px, cols - x0)
    hits = np.zeros((rows, cols), np.int64)
    for j in range(px):
        on = npx > j
        np.add.at(hits, (y[on], x0[on] + j), 1)
    return y, x0, npx, hits


@pytest.mark.parametrize("h,w,factor", [(97, 131, 2), (97, 131, 3),
                                        (97, 131, 4), (20, 33, 3),
                                        (24, 64, 2)])
def test_sr_launch_plan(h, w, factor):
    """B6's launch plan: one thread per 4 fine pixels of a row covers
    every fine pixel once; 16-byte stores only where every quad starts
    16-byte aligned in the interleaved image and in ``acc_w``."""
    blocks, vector, wide = sr_cuda.launch_plan(h, w, factor)
    hf, wf = h * factor, w * factor
    y, x0, npx, hits = _covered(blocks, hf, wf, 4)
    assert (hits == 1).all()
    assert blocks == -(-len(y) // 256)  # no block without work
    assert vector == (wf % 4 == 0) and not wide
    if vector:
        p0 = y * wf + x0
        assert (npx == 4).all()
        assert ((p0 * 3 * 4) % 16 == 0).all() and ((p0 * 4) % 16 == 0).all()


def test_sr_launch_plan_at_scale():
    """The plan at the SR paths' shape (4K frames, x2) and where a frame's
    tap offsets need 64 bits."""
    assert sr_cuda.launch_plan(2160, 3840, 2) == (32400, True, False)
    assert sr_cuda.launch_plan(2160, 3843, 3) == (
        -(-(6480 * -(-11529 // 4)) // 256), False, False)
    assert sr_cuda.launch_plan(26800, 26800, 2)[2]  # 2.15e9 values a frame
    assert not sr_cuda.launch_plan(26700, 26700, 2)[2]


def test_super_res_recovers_contrast():
    """tests/test_stack.py:305-368 on the port: clearly more of a
    near-Nyquist target's contrast than the bilinear mean, lower RMSE."""
    rng = np.random.default_rng(3)
    hf = wf = 192
    yy, xx = np.mgrid[0:hf, 0:wf].astype(np.float64)
    truth = 0.5 + 0.25 * np.sin(0.9 * xx) + 0.25 * np.sin(0.9 * yy)

    def sample_lr(dy, dx):
        sh = np.roll(np.roll(truth, -int(round(dy * 2)), 0),
                     -int(round(dx * 2)), 1)
        return sh.reshape(hf // 2, 2, wf // 2, 2).mean((1, 3))

    n_f = 16
    shifts = [(0.0, 0.0)] + [
        (round(rng.uniform(0, 1) * 2) / 2, round(rng.uniform(0, 1) * 2) / 2)
        for _ in range(n_f - 1)]
    frames_f = np.stack([sample_lr(dy, dx) for dy, dx in shifts])
    frames = np.repeat(np.clip(np.round(frames_f * 255), 0, 255).astype(
        np.uint8)[..., None], 3, axis=-1)
    mats = np.stack([np.array([[1, 0, dx], [0, 1, dy], [0, 0, 1]], np.float32)
                     for dy, dx in shifts[1:]])
    sr = n(stack.super_res_stack(t(frames), t(mats),
                                 t(np.ones(n_f - 1, bool)), factor=2,
                                 kernel_sigma=0.3, perspective=False,
                                 chunk=5))[..., 0].astype(np.float64)
    h, w = hf // 2, wf // 2
    oy, ox = np.mgrid[0:hf, 0:wf].astype(np.float64)
    acc = np.zeros((hf, wf))
    for f, (dy, dx) in zip(frames_f, shifts):
        sy = (oy + 0.5) / 2 - 0.5 - dy
        sx = (ox + 0.5) / 2 - 0.5 - dx
        y0 = np.clip(np.floor(sy).astype(int), 0, h - 2)
        fy = np.clip(sy - y0, 0, 1)
        x0 = np.clip(np.floor(sx).astype(int), 0, w - 2)
        fx = np.clip(sx - x0, 0, 1)
        acc += (f[y0, x0] * (1 - fy) * (1 - fx) + f[y0, x0 + 1] * (1 - fy) * fx
                + f[y0 + 1, x0] * fy * (1 - fx)
                + f[y0 + 1, x0 + 1] * fy * fx)
    bl = acc / n_f
    crop = slice(8, -8)

    def rmse_contrast(x):
        r = np.sqrt(((x - truth)[crop, crop] ** 2).mean())
        a = (x - x.mean())[crop, crop]
        tt = (truth - truth.mean())[crop, crop]
        return r, (a * tt).mean() / (tt * tt).mean()

    r_bl, c_bl = rmse_contrast(bl)
    r_sr, c_sr = rmse_contrast(sr)
    assert c_sr > c_bl + 0.08, (c_sr, c_bl)
    assert r_sr < 0.75 * r_bl, (r_sr, r_bl)


@pytest.fixture(scope="module")
def blocky_burst():
    """tests/test_stack.py:417-427: 8 rolled copies of 8-px blocks."""
    rng = np.random.default_rng(29)
    h, w = 192, 256
    base = cv2.resize(
        rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8).astype(np.uint8),
        (w, h), interpolation=cv2.INTER_NEAREST)
    return np.stack([
        np.roll(base, (int(rng.integers(-3, 4)), int(rng.integers(-3, 4))),
                (0, 1))
        for _ in range(8)])


def test_keypoint_output_scale_matches_jax(blocky_burst):
    frames = blocky_burst
    h, w = frames.shape[1:3]
    d_j, want = J.keypoint_match_arrays(
        frames, J.KeyPointMatchParameters(output_scale=2))
    d0, mean_out = P.keypoint_match_arrays(frames, P.KeyPointMatchParameters(),
                                           device="cpu")
    d1, got = P.keypoint_match_arrays(
        frames, P.KeyPointMatchParameters(output_scale=2), device="cpu")
    assert d0 == d1 == d_j == 0
    assert got.shape == want.shape == (2 * h, 2 * w, 3)
    # RANSAC draws differ between the packages (torch.Generator vs
    # jax.random), so their homographies, and even their mean stacks on
    # this block texture, differ a little (mean abs 1.5e-3): the two SR
    # images are held statistically
    assert np.abs(got - want)[16:-16, 16:-16].mean() < 0.01
    down = got.reshape(h, 2, w, 2, 3).mean((1, 3))
    assert np.abs(down - mean_out)[10:-10, 10:-10].mean() < 0.02
    # a single frame upsamples frame 0
    _, one = P.keypoint_match_arrays(
        frames[:1], P.KeyPointMatchParameters(output_scale=2), device="cpu")
    _, jone = J.keypoint_match_arrays(
        frames[:1], J.KeyPointMatchParameters(output_scale=2))
    assert one.shape == (2 * h, 2 * w, 3)
    np.testing.assert_allclose(one, jone, atol=1e-6)


def test_output_scale_guards_match_jax(blocky_burst):
    frames = blocky_burst[:3]
    kw = dict(output_scale=2, border_mode=constants.BORDER_REPLICATE)
    with pytest.raises(jerrors.InvalidParamsError) as je:
        J.keypoint_match_arrays(frames, J.KeyPointMatchParameters(**kw))
    with pytest.raises(errors.InvalidParamsError) as pe:
        P.keypoint_match_arrays(frames, P.KeyPointMatchParameters(**kw),
                                device="cpu")
    assert str(pe.value) == str(je.value)
    for cls in ("KeyPointMatchParameters", "EccMatchParameters"):
        args = () if cls.startswith("Key") else (J.MotionType.Affine,)
        pargs = () if cls.startswith("Key") else (P.MotionType.Affine,)
        bad = dict(output_scale=2, stacking="sigma_clip")
        with pytest.raises(jerrors.InvalidParamsError) as je:
            getattr(J, cls)(*args, **bad).validate()
        with pytest.raises(errors.InvalidParamsError) as pe:
            getattr(P, cls)(*pargs, **bad).validate()
        assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("factor", [2, 3])
def test_ecc_output_scale_matches_jax(factor):
    rng = np.random.default_rng(7)
    h, w = 96, 128
    base = cv2.GaussianBlur(rng.random((h * 2, w * 2)).astype(np.float32),
                            (0, 0), 3.0)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(
        np.uint8)
    frames = []
    for dx, dy in [(0.0, 0.0), (1.3, -0.7), (-2.1, 1.6)]:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(base, m, (w * 2, h * 2),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        frames.append(np.stack([cur[h // 2 : h // 2 + h,
                                    w // 2 : w // 2 + w]] * 3, -1))
    frames = np.stack(frames)
    kw = dict(max_count=50, epsilon=1e-4, gauss_filt_size=5)
    want = J.ecc_match_arrays(frames, J.EccMatchParameters(
        J.MotionType.Translation, output_scale=factor, **kw))
    mean_out = P.ecc_match_arrays(frames, P.EccMatchParameters(
        P.MotionType.Translation, **kw), device="cpu")
    got, st = P.ecc_match_arrays(frames, P.EccMatchParameters(
        P.MotionType.Translation, output_scale=factor, **kw),
        return_stats=True, device="cpu")
    assert st.frames_kept == 3
    assert got.shape == want.shape == (factor * h, factor * w, 3)
    c = 8 * factor
    d = np.abs(got - want)[c:-c, c:-c]
    assert d.max() < 0.02, d.max()
    down = got.reshape(h, factor, w, factor, 3).mean((1, 3))
    assert np.abs(down - mean_out)[8:-8, 8:-8].mean() < 0.02
    one = P.ecc_match_arrays(frames[:1], P.EccMatchParameters(
        P.MotionType.Translation, output_scale=factor, **kw), device="cpu")
    jone = J.ecc_match_arrays(frames[:1], J.EccMatchParameters(
        J.MotionType.Translation, output_scale=factor, **kw))
    np.testing.assert_allclose(one, jone, atol=1e-6)
