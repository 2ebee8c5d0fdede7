"""PyTorch port vs libstacker_tpu: resize on the keypoint slice's path.

Same numpy inputs through both packages on the CPU.  The port sums each
output's taps in the order the JAX package's dense and banded forms take
on XLA:CPU as far as it could be measured (ops/resize.py).  XLA:CPU's
order also depends on the array's shape, so a residual remains: uint8
outputs within 1 LSB on under 1e-3 of pixels (measured up to 7e-4 on
the first levels of a 1080x1920 pyramid chain), float outputs
within a few float32 ulps (6.2e-5 on the 0..255 scale), and integer
ratios bit-exact.

- the INTER_AREA case of ROADMAP.md Queue C, 100x140 -> 64x89, where
  both packages take the dense form on both axes, so the band layout
  cannot be the cause.  Measured over seeds 0..19 (``python
  tests/_torch_parity.py resize``): 14 of 227840 uint8 pixels 1 LSB
  apart (6.1e-5; none on this test's seeds 0..2); pinned at 1 LSB on
  under 2e-4;
- a 2.7x INTER_AREA shrink like 2160 -> 800 (the scaled keypoint path);
- the 8-level INTER_LINEAR uint8 chain at scale 1.2 of the ORB pyramid,
  level by level, each level resized from the previous uint8 level;
- INTER_NEAREST, exact;
- the port's own: a resize leaves no reference cycle behind, so each
  tap's full-image product is freed when the call returns (a cycle kept
  the ORB pyramid's products alive until the next garbage collection).
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import n, t  # noqa: E402
from libstacker_tpu.ops import resize as jresize  # noqa: E402
from libstacker_tpu_torch import constants  # noqa: E402
from libstacker_tpu_torch.ops import resize  # noqa: E402

torch.set_num_threads(2)

U8_FRAC_BAR = 1e-3
U8_FRAC_QUEUE_C = 2e-4
F32_ULP_BAR = 6.2e-5


def _u8_residual(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inter_area_100x140_to_64x89(seed):
    """The Queue C case: both packages use the dense form on both axes
    (the band would span the whole source), so any residual is the
    order of the sums inside one dense product, not the band layout."""
    for src, dst in ((100, 64), (140, 89)):
        assert not resize._is_banded(src, dst, constants.INTER_AREA)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(2, 100, 140)).astype(np.uint8)
    got = n(resize.resize(t(x), (64, 89), constants.INTER_AREA))
    want = np.asarray(jresize.resize(jnp.asarray(x), (64, 89),
                                     constants.INTER_AREA))
    assert got.dtype == np.uint8
    dmax, frac = _u8_residual(got, want)
    assert dmax <= 1 and frac < U8_FRAC_QUEUE_C
    xf = x.astype(np.float32)
    gf = n(resize.resize(t(xf), (64, 89), constants.INTER_AREA))
    wf = np.asarray(jresize.resize(jnp.asarray(xf), (64, 89),
                                   constants.INTER_AREA))
    assert np.abs(gf - wf).max() <= F32_ULP_BAR


def test_inter_area_2p7x_like_2160_to_800():
    """540x960 -> 200x355 (2.7x, banded on both axes; scale_image_size
    of the scaled keypoint path) and an integer 3x ratio, bit-exact."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, size=(2, 540, 960)).astype(np.uint8)
    dst = resize.scale_image_size(540, 960, 200.0)
    assert dst == jresize.scale_image_size(540, 960, 200.0) == (200, 355)
    assert resize._is_banded(540, 200, constants.INTER_AREA)
    got = n(resize.resize(t(x), dst, constants.INTER_AREA))
    want = np.asarray(jresize.resize(jnp.asarray(x), dst,
                                     constants.INTER_AREA))
    dmax, frac = _u8_residual(got, want)
    assert dmax <= 1 and frac < U8_FRAC_BAR
    got3 = n(resize.resize(t(x), (180, 320), constants.INTER_AREA))
    want3 = np.asarray(jresize.resize(jnp.asarray(x), (180, 320),
                                      constants.INTER_AREA))
    np.testing.assert_array_equal(got3, want3)


def test_inter_linear_orb_pyramid_chain():
    """The ORB pyramid: 8 uint8 levels at scale 1.2, each resized from
    the previous level (libstacker_tpu/ops/orb.py:215-222), the JAX side
    vmapped over frames as the detector runs it."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, size=(2, 240, 320)).astype(np.uint8)
    h, w = x.shape[1:]
    got, want = t(x), jnp.asarray(x)
    for level in range(1, 8):
        scale = 1.2 ** level
        dsize = (int(round(h / scale)), int(round(w / scale)))
        got = resize.resize(got, dsize, constants.INTER_LINEAR)
        want = jax.vmap(lambda g, d=dsize: jresize.resize(
            g, d, constants.INTER_LINEAR))(want)
        g_np, w_np = n(got), np.asarray(want)
        assert g_np.shape == w_np.shape == (2,) + dsize
        dmax, frac = _u8_residual(g_np, w_np)
        assert dmax <= 1 and frac < U8_FRAC_BAR, (level, dmax, frac)


def test_inter_nearest_and_errors():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(2, 50, 70)).astype(np.uint8)
    for dst in ((20, 33), (77, 101)):
        np.testing.assert_array_equal(
            n(resize.resize(t(x), dst, constants.INTER_NEAREST)),
            np.asarray(jresize.resize(jnp.asarray(x), dst,
                                      constants.INTER_NEAREST)),
        )
    with pytest.raises(Exception, match="invalid dsize"):
        resize.resize(t(x), (0, 5), constants.INTER_LINEAR)


@pytest.mark.parametrize("interp", [constants.INTER_LINEAR,
                                    constants.INTER_AREA])
def test_resize_leaves_no_reference_cycle(interp):
    x = torch.randint(0, 256, (3, 97, 131), dtype=torch.uint8)
    gc.collect()
    gc.disable()
    try:
        resize.resize(x, (61, 87), interp)
        resize.resize(x.to(torch.float32), (50, 200), interp)
        resize.resize_rows(x, 97, 61, 10, 40, 0, interp)
        assert gc.collect() == 0
    finally:
        gc.enable()
