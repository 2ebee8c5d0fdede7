"""PyTorch port vs libstacker_tpu: FAST, top-k and Harris (ops/fast.py,
and the plain version of kernel B8 in ops/fast_cuda.py).

Same numpy inputs through both packages on the CPU.  Bars: FAST scores
bitwise equal to the JAX ``fast_detect`` + edge band and to the
interpret-mode Pallas kernel ``fast_scores_batched`` (integer scores,
exact on both sides); ``top_k_keypoints`` returns exactly the JAX
``(ys, xs, score, valid)`` of ``lax.top_k``, ties (the rule for integer
scores) broken by raster order; Harris responses within rtol 1e-5 (the
two frameworks sum the 7x7 block in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import n, t  # noqa: E402
from libstacker_tpu.ops import fast as jfast  # noqa: E402
from libstacker_tpu.ops import fast_pallas as jfast_pallas  # noqa: E402
from libstacker_tpu_torch.ops import fast, fast_cuda  # noqa: E402

torch.set_num_threads(2)


def _blurred(rng, h, w):
    return cv2.GaussianBlur(rng.integers(0, 256, (h, w), np.uint8), (5, 5), 1.5)


def _band(h, w, b):
    ys, xs = np.mgrid[0:h, 0:w]
    return (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_fast_scores_match_jax(dtype):
    """The plain version of B8 against JAX fast_detect + the ORB band."""
    rng = np.random.default_rng(47)
    imgs = np.stack([_blurred(rng, 97, 131), _blurred(rng, 97, 131)])
    if dtype == np.float32:
        imgs = imgs.astype(np.float32) + 0.25 * rng.random(imgs.shape).astype(
            np.float32)
    for b in (0, 31):
        got = n(fast_cuda.fast_scores(t(imgs), 20, b))
        for i in range(2):
            mask, score = jfast.fast_detect(jnp.asarray(imgs[i]), 20)
            want = np.where(np.asarray(mask) & _band(97, 131, b),
                            np.asarray(score), 0.0)
            np.testing.assert_array_equal(got[i], want)
    # and the unbanded mask / score pair itself
    keep, score = fast.fast_detect(t(imgs[0]), 20)
    jkeep, jscore = jfast.fast_detect(jnp.asarray(imgs[0]), 20)
    np.testing.assert_array_equal(n(keep), np.asarray(jkeep))
    np.testing.assert_array_equal(n(score), np.asarray(jscore))
    corner, raw = fast.fast_score(t(imgs[0]), 20)
    jcorner, jraw = jfast.fast_score(jnp.asarray(imgs[0]), 20)
    np.testing.assert_array_equal(n(corner), np.asarray(jcorner))
    np.testing.assert_array_equal(n(raw), np.asarray(jraw))


@pytest.mark.parametrize("hw", [(192, 512), (97, 131)])
def test_fast_scores_match_pallas_interpret(hw):
    """The plain version of B8 against the TPU kernel in interpret
    mode, batched, with and without the edge band (as
    tests/test_fast.py:50-85 runs it)."""
    rng = np.random.default_rng(11)
    imgs = np.stack([_blurred(rng, *hw) for _ in range(2)])
    for b in (0, 31):
        want = np.asarray(jfast_pallas.fast_scores_batched(
            jnp.asarray(imgs), 20, b, interpret=True))
        got = n(fast_cuda.fast_scores(t(imgs), 20, b))
        np.testing.assert_array_equal(got, want)


def test_top_k_keypoints_exact_with_ties():
    """Integer FAST scores tie all the time: the port must pick exactly
    the JAX package's pixels, including the -1 filler slots past the
    last corner."""
    rng = np.random.default_rng(47)
    imgs = rng.integers(0, 256, (2, 96, 128), dtype=np.uint8)
    mask, score = fast.fast_detect(t(imgs), 12)
    n_surv = int(n(mask)[0].sum())
    assert n_surv > 20
    for k in (8, n_surv, n_surv + 17):
        got = fast.top_k_keypoints(mask, score, k)
        for i in range(2):
            jm, js = jfast.fast_detect(jnp.asarray(imgs[i]), 12)
            for approx in (False, True):  # approx_max_k is exact on the CPU
                want = jfast.top_k_keypoints(jm, js, k, approx=approx)
                np.testing.assert_array_equal(n(got.ys)[i], np.asarray(want.ys))
                np.testing.assert_array_equal(n(got.xs)[i], np.asarray(want.xs))
                np.testing.assert_array_equal(n(got.score)[i],
                                              np.asarray(want.score))
                np.testing.assert_array_equal(n(got.valid)[i],
                                              np.asarray(want.valid))


def test_topk_stable_order_matches_lax_top_k():
    """Negative values, -inf, +-0 and repeated values: lax.top_k's
    order, ties by the lower index."""
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, (3, 50)).astype(np.float32) * 0.5
    x[0, :5] = -np.inf
    x[1, 7] = -0.0
    for k in (1, 7, 50):
        vals, idx = fast.topk_stable(t(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(n(idx), np.asarray(ji))
        np.testing.assert_array_equal(n(vals), np.asarray(jv))


def test_harris_matches_jax():
    rng = np.random.default_rng(8)
    patches = rng.integers(0, 256, (2, 30, 9, 9)).astype(np.float32)
    got = n(fast.harris_from_patches(t(patches)))
    want = np.stack([np.asarray(jfast.harris_from_patches(jnp.asarray(p)))
                     for p in patches])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    img = _blurred(rng, 60, 80)
    ys = rng.integers(0, 60, 25).astype(np.int32)
    xs = rng.integers(0, 80, 25).astype(np.int32)
    np.testing.assert_allclose(
        n(fast.harris_response_at(t(img), t(ys), t(xs))),
        np.asarray(jfast.harris_response_at(jnp.asarray(img), jnp.asarray(ys),
                                            jnp.asarray(xs))),
        rtol=1e-5, atol=1e-12,
    )
    assert fast.CIRCLE_OFFSETS == jfast.CIRCLE_OFFSETS
