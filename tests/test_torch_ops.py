"""PyTorch port vs libstacker_tpu: color, filters, resize, warp, phasecorr.

Same numpy inputs through both packages on the CPU.  Bars: grey and
INTER_AREA on u8 bit-exact (INTER_AREA at fractional ratios: 1 LSB on
under 1e-3 of pixels, see the test); filters within 1e-4 abs (float32 term
order is the same, XLA may still fuse differently); warps with under
1e-3 of pixels off by more than 1e-4 (a coordinate on an exact 1/32
rounding boundary may flip one bin when the two frameworks round the
product differently); the phase-correlation start within 0.05 px."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("scipy")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import frac_off, n, rotation_inverse_map, smooth, t  # noqa: E402
from libstacker_tpu.ops import color as jcolor  # noqa: E402
from libstacker_tpu.ops import ecc as jecc  # noqa: E402
from libstacker_tpu.ops import filters as jfilters  # noqa: E402
from libstacker_tpu.ops import phasecorr as jphase  # noqa: E402
from libstacker_tpu.ops import resize as jresize  # noqa: E402
from libstacker_tpu.ops import warp as jwarp  # noqa: E402
from libstacker_tpu.params import MotionType as JMotion  # noqa: E402
from libstacker_tpu_torch import constants, errors  # noqa: E402
from libstacker_tpu_torch.ops import (  # noqa: E402
    color, filters, phasecorr, resize, warp,
)
from libstacker_tpu_torch.params import MotionType  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rng_local():
    return np.random.default_rng(2024)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_grey_bit_exact(rng_local, dtype):
    hi = 256 if dtype == np.uint8 else 65536
    rgb = rng_local.integers(0, hi, size=(3, 37, 53, 3)).astype(dtype)
    got = n(color.rgb_to_gray_u8(t(rgb)))
    want = np.asarray(jcolor.rgb_to_gray_u8(jnp.asarray(rgb)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        n(color.depth_reduce_u8(t(rgb))),
        np.asarray(jcolor.depth_reduce_u8(jnp.asarray(rgb))),
    )


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_to_unit_f32_bit_exact(rng_local, dtype):
    if dtype == np.float32:
        x = rng_local.random((17, 23, 3)).astype(np.float32)
    else:
        hi = 256 if dtype == np.uint8 else 65536
        x = rng_local.integers(0, hi, size=(17, 23, 3)).astype(dtype)
    got = n(color.to_unit_f32(t(x)))
    want = np.asarray(jcolor.to_unit_f32(jnp.asarray(x)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("border", ["reflect101", "replicate", "constant",
                                    "reflect", "wrap"])
def test_pad2d_matches(rng_local, border):
    x = smooth(rng_local, (2, 11, 13))
    got = n(filters.pad2d(t(x), 2, 3, border, value=7.0))
    want = np.asarray(jfilters.pad2d(jnp.asarray(x), 2, 3, border, value=7.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.0), (7, 0.0), (5, 1.3)])
def test_gaussian_blur_matches(rng_local, ksize, sigma):
    x = smooth(rng_local, (3, 41, 67), sigma=1.0)
    assert filters.gaussian_kernel(ksize, sigma) == pytest.approx(
        jfilters.gaussian_kernel(ksize, sigma), abs=0.0
    )
    got = n(filters.gaussian_blur(t(x), ksize, sigma))
    want = np.asarray(jfilters.gaussian_blur(jnp.asarray(x), ksize, sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_central_difference_fields_match(rng_local):
    """The ECC input prep (blur + [-0.5, 0, 0.5] gradients, reflect101)."""
    x = smooth(rng_local, (45, 70))
    from libstacker_tpu_torch.ops import ecc

    got = [n(a) for a in ecc._input_fields(t(x), 5)]
    want = [np.asarray(a) for a in jecc._input_fields(jnp.asarray(x), 5)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("src,dst", [((97, 131), (50, 64)), ((96, 128), (48, 64)),
                                     ((100, 140), (64, 89))])
def test_inter_area_u8_bit_exact(rng_local, src, dst):
    x = rng_local.integers(0, 256, size=(2,) + src).astype(np.uint8)
    got = n(resize.resize(t(x), dst, constants.INTER_AREA))
    want = np.asarray(jresize.resize(jnp.asarray(x), dst, constants.INTER_AREA))
    assert got.dtype == np.uint8
    if all(a % b == 0 for a, b in zip(src, dst)):
        np.testing.assert_array_equal(got, want)
    else:
        # fractional ratios: both packages take the dense form here
        # (the band would cover the whole source on both axes), and
        # XLA:CPU's order of the taps' sums inside that one product
        # depends on the array's shape, so a value within a float32 ulp
        # of k + 0.5 may round the other way (ops/resize.py,
        # tests/test_torch_resize.py, ROADMAP.md Queue C)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_inter_area_f32_and_octave(rng_local):
    x = smooth(rng_local, (3, 96, 130))
    got = n(resize.resize(t(x), (41, 57)))
    want = np.asarray(jresize.resize(jnp.asarray(x), (41, 57), constants.INTER_AREA))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the 2x box-mean octave reduction, and its odd-extent fallback
    for dh, dw in ((48, 65), (47, 64)):
        g = n(resize.resize_area_octave(t(x), dh, dw))
        w = np.asarray(jecc._resize_area_jit(jnp.asarray(x), dh, dw))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    assert resize.scale_image_size(1080, 1920, 540) == \
        jresize.scale_image_size(1080, 1920, 540)
    assert resize.scale_image_size(140, 100, 64) == \
        jresize.scale_image_size(140, 100, 64)
    with pytest.raises(errors.InvalidParamsError, match="interpolation"):
        resize.resize(t(x), (10, 10), constants.INTER_CUBIC)


@pytest.mark.parametrize("kind", ["perspective", "affine"])
@pytest.mark.parametrize("inverse_map", [True, False])
def test_warp_matches(rng_local, kind, inverse_map):
    h, w = 97, 131
    img = smooth(rng_local, (h, w))
    m = rotation_inverse_map(h, w, 1.3, 1.01, 2.25, -1.5,
                             persp=(1e-5, -2e-5) if kind == "perspective"
                             else (0.0, 0.0))
    if kind == "perspective":
        got = warp.warp_perspective(t(img), t(m), (h, w), border_value=3.0,
                                    inverse_map=inverse_map)
        want = jwarp.warp_perspective(jnp.asarray(img), jnp.asarray(m), (h, w),
                                      border_value=3.0, inverse_map=inverse_map)
    else:
        got = warp.warp_affine(t(img), t(m[:2]), (h, w), border_value=3.0,
                               inverse_map=inverse_map)
        want = jwarp.warp_affine(jnp.asarray(img), jnp.asarray(m[:2]), (h, w),
                                 border_value=3.0, inverse_map=inverse_map)
    assert frac_off(got, want) < 1e-3
    assert np.abs(n(got) - np.asarray(want)).max() < 0.05 * 255


def test_warp_rgb_per_channel_border_and_mask(rng_local):
    h, w = 60, 80
    img = smooth(rng_local, (h, w, 3))
    m = rotation_inverse_map(h, w, -2.0, 1.0, 5.5, 3.25, persp=(2e-4, 0.0))
    bv = [1.0, 2.0, 3.0]
    got = warp.warp_perspective(t(img), t(m), (h, w), border_value=bv,
                                inverse_map=True)
    want = jwarp.warp_perspective(jnp.asarray(img), jnp.asarray(m), (h, w),
                                  border_value=jnp.asarray(bv), inverse_map=True)
    assert frac_off(got, want) < 1e-3
    np.testing.assert_array_equal(
        n(warp.warp_valid_mask(t(m), (h, w), (h, w))),
        np.asarray(jwarp.warp_valid_mask(jnp.asarray(m), (h, w), (h, w))),
    )
    np.testing.assert_allclose(
        n(warp.invert_3x3(t(m))), np.linalg.inv(m.astype(np.float64)),
        rtol=1e-5, atol=1e-5,
    )
    with pytest.raises(ValueError, match="border mode"):
        warp.warp_perspective(t(img), t(m), border_mode=7)


def test_phase_correlation_matches(rng_local):
    """Translation start, port vs JAX: same shifts within 0.05 px on a
    burst with known shifts (and on the 4x-pooled path of a wide grid)."""
    h, w = 128, 160
    base = smooth(rng_local, (h + 40, w + 40), sigma=3.0)
    tmpls = [base[20 + int(dy):, 20 + int(dx):][:h, :w] for dx, dy in
             [(3, -2), (-5, 1), (0, 0)]]
    ref = base[20:20 + h, 20:20 + w]
    tm = np.stack(tmpls).astype(np.float32)
    got = n(phasecorr.phase_init_warps(t(tm), t(ref), MotionType.Homography))
    want = np.asarray(jphase.phase_init_warps(
        jnp.asarray(tm), jnp.asarray(ref), motion_type=JMotion.Homography))
    assert got.shape == (3, 3, 3)
    np.testing.assert_allclose(got, want, atol=0.05)
    # integer-shifted crops: the start recovers the shifts themselves
    np.testing.assert_allclose(got[:, 0, 2], [3, -5, 0], atol=0.25)
    np.testing.assert_allclose(got[:, 1, 2], [-2, 1, 0], atol=0.25)
    assert phasecorr._auto_downscale(2160, 3840) == jphase._auto_downscale(2160, 3840)
    wide = np.stack([smooth(rng_local, (520, 1300), 3.0)] * 2)
    g2 = n(phasecorr.phase_init_warps(t(wide), t(wide[0]), MotionType.Affine))
    w2 = np.asarray(jphase.phase_init_warps(jnp.asarray(wide), jnp.asarray(wide[0]),
                                            motion_type=JMotion.Affine))
    np.testing.assert_allclose(g2, w2, atol=0.05)
    # rotation=True: Translation ignores it (libstacker_tpu/ops/
    # phasecorr.py:309); Affine runs the log-polar start, which finds no
    # rotation on shifted crops
    tr = n(phasecorr.phase_init_warps(t(tm), t(ref), MotionType.Translation,
                                      rotation=True))
    np.testing.assert_array_equal(tr, n(phasecorr.phase_init_warps(
        t(tm), t(ref), MotionType.Translation)))
    g3 = n(phasecorr.phase_init_warps(t(tm), t(ref), rotation=True))
    w3 = np.asarray(jphase.phase_init_warps(
        jnp.asarray(tm), jnp.asarray(ref), motion_type=JMotion.Affine,
        rotation=True))
    np.testing.assert_allclose(g3, w3, atol=0.05)
