"""PyTorch port vs libstacker_tpu: the sharpness metrics and the filters,
grey and resize helpers they bring (ROADMAP.md Queue A item 11).

Inputs are made with numpy from a seed and fed to both packages; the
port runs on the CPU.  Bars:

- ``deriv_kernel`` tuples equal; ``sobel`` / ``laplacian`` bitwise (the
  port's ``sep_filter2d`` sums the taps in the JAX package's order);
- ``rgb_to_gray_f32`` bitwise; ``scale_image`` u8 within Queue C's C2 bar
  (< 1e-3 of pixels 1 LSB apart);
- each metric rel <= 1e-5 against the JAX package (the filtered planes
  are bitwise; only the float32 means sum in another order), and rel
  1e-4 against the cv2 float64 oracles of ``tests/test_sharpness.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
cv2 = pytest.importorskip("cv2")

import libstacker_tpu as J  # noqa: E402
from libstacker_tpu.ops import color as jcolor  # noqa: E402
from libstacker_tpu.ops import filters as jfilters  # noqa: E402
from libstacker_tpu.ops import resize as jresize  # noqa: E402
from libstacker_tpu.ops import sharpness as jsharp  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import n, t  # noqa: E402
from libstacker_tpu_torch import errors  # noqa: E402
from libstacker_tpu_torch.ops import color, filters, resize, sharpness  # noqa: E402

torch.set_num_threads(2)

METRICS = (
    "sharpness_modified_laplacian",
    "sharpness_variance_of_laplacian",
    "sharpness_tenengrad",
    "sharpness_normalized_gray_level_variance",
)
REL = 1e-5


@pytest.fixture(scope="module")
def batch():
    """[3,97,131] smoothed grey content (u8) with one frame blurred."""
    rng = np.random.default_rng(97)
    raw = rng.integers(0, 256, (3, 97, 131), np.uint8)
    out = np.stack([cv2.GaussianBlur(f, (5, 5), 1.0) for f in raw])
    out[2] = cv2.GaussianBlur(out[2], (0, 0), 2.5)
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(n(got), np.float64), np.asarray(n(want), np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("metric", METRICS)
def test_metric_matches_jax(noise_image, batch, metric, dtype):
    for img in (noise_image.astype(dtype), batch.astype(dtype)):
        want = getattr(jsharp, metric)(jnp.asarray(img))
        got = getattr(sharpness, metric)(img, device="cpu")
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert tuple(got.shape) == img.shape[:-2]
        assert _rel(got, want) <= REL, metric


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_sharpness_all_matches_jax(batch, dtype, monkeypatch):
    img = batch.astype(dtype)
    want = jsharp.sharpness_all(jnp.asarray(img), teng_k_size=5)
    # two frames a pass: the chunked scoring equals the one-pass scores
    monkeypatch.setattr(sharpness, "_SCORE_CHUNK", 2)
    got = P.sharpness_all(t(img), teng_k_size=5)
    assert set(got) == {"lapm", "lapv", "teng", "glvn"}
    for k in got:
        assert _rel(got[k], want[k]) <= REL, k
    assert int(torch.argmin(got["teng"])) == 2  # the blurred frame
    np.testing.assert_array_equal(np.argsort(n(got["teng"]), kind="stable"),
                                  np.argsort(n(want["teng"]), kind="stable"))


def test_tensor_stays_on_its_device_and_numpy_goes_to_device(noise_image,
                                                            monkeypatch):
    got = P.sharpness_tenengrad(t(noise_image))
    assert got.device.type == "cpu" and got.shape == ()
    # a numpy input goes to device="cuda" by default: without a card
    # that raises, it never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (P.sharpness_tenengrad, P.sharpness_all):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(noise_image)


# --- against the cv2 float64 oracles (tests/test_sharpness.py) --------------


def _lapm_oracle(img):
    m = np.array([-1.0, 2.0, -1.0])
    g = cv2.getGaussianKernel(3, -1).ravel()
    lx = cv2.sepFilter2D(img.astype(np.float64), cv2.CV_64F, m, g)
    ly = cv2.sepFilter2D(img.astype(np.float64), cv2.CV_64F, g, m)
    return float(np.mean(np.abs(lx) + np.abs(ly)))


def _lapv_oracle(img):
    lap = cv2.Laplacian(img.astype(np.float64), cv2.CV_64F, ksize=3,
                        borderType=cv2.BORDER_REPLICATE)
    return float(lap.std() ** 2)


def _teng_oracle(img, k):
    gx = cv2.Sobel(img.astype(np.float64), cv2.CV_64F, 1, 0, ksize=k)
    gy = cv2.Sobel(img.astype(np.float64), cv2.CV_64F, 0, 1, ksize=k)
    return float(np.mean(gx * gx + gy * gy))


def _glvn_oracle(img):
    f = img.astype(np.float64)
    return float(f.std() ** 2 / max(f.mean(), np.finfo(np.float64).eps))


@pytest.mark.parametrize("metric,oracle", [
    ("sharpness_modified_laplacian", _lapm_oracle),
    ("sharpness_variance_of_laplacian", _lapv_oracle),
    ("sharpness_normalized_gray_level_variance", _glvn_oracle),
])
def test_metric_matches_cv2(noise_image, metric, oracle):
    got = float(getattr(P, metric)(noise_image, device="cpu"))
    assert got == pytest.approx(oracle(noise_image), rel=1e-4)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_teng_matches_cv2(noise_image, k):
    got = float(P.sharpness_tenengrad(noise_image, k, device="cpu"))
    assert got == pytest.approx(_teng_oracle(noise_image, k), rel=1e-4)


def test_batched_matches_per_frame_cv2(noise_image):
    b = np.stack([noise_image, noise_image[::-1].copy()], axis=0)
    out = P.sharpness_all(b, device="cpu")
    assert tuple(out["teng"].shape) == (2,)
    assert float(out["teng"][0]) == pytest.approx(_teng_oracle(b[0], 3), rel=1e-4)
    assert float(out["lapv"][1]) == pytest.approx(_lapv_oracle(b[1]), rel=1e-4)


@pytest.mark.parametrize("k", [0, 2, 4, 9])
def test_teng_invalid_ksize_message(noise_image, k):
    with pytest.raises(J.InvalidParamsError) as jerr:
        jsharp.sharpness_tenengrad(jnp.asarray(noise_image), k)
    with pytest.raises(errors.InvalidParamsError) as perr:
        P.sharpness_tenengrad(noise_image, k, device="cpu")
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(errors.InvalidParamsError, match="1, 3, 5, or 7"):
        P.sharpness_all(noise_image, teng_k_size=k, device="cpu")


# --- the helpers -------------------------------------------------------------


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_deriv_kernel_matches_jax(order, ksize):
    assert filters.deriv_kernel(order, ksize) == jfilters.deriv_kernel(order, ksize)


@pytest.mark.parametrize("border", ["reflect101", "replicate", "constant"])
@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_sobel_and_laplacian_bitwise(batch, ksize, border):
    """Bitwise: both sum the shifted slices in the same tap order."""
    x = batch.astype(np.float32)
    for dx, dy in ((1, 0), (0, 1), (2, 0), (1, 1)):
        got = filters.sobel(t(x), dx, dy, ksize=ksize, border=border)
        want = jfilters.sobel(jnp.asarray(x), dx, dy, ksize=ksize, border=border)
        np.testing.assert_array_equal(n(got), n(want))
    got = filters.laplacian(t(x), ksize=ksize, border=border)
    want = jfilters.laplacian(jnp.asarray(x), ksize=ksize, border=border)
    np.testing.assert_array_equal(n(got), n(want))
    scaled = filters.sobel(t(x), 1, 0, ksize=ksize, scale=0.25, border=border)
    np.testing.assert_array_equal(
        n(scaled), n(jfilters.sobel(jnp.asarray(x), 1, 0, ksize=ksize,
                                    scale=0.25, border=border)))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_gray_f32_bitwise(dtype):
    rng = np.random.default_rng(40)
    rgb = (rng.random((2, 33, 47, 3)) * 255).astype(dtype)
    np.testing.assert_array_equal(
        n(color.rgb_to_gray_f32(t(rgb))), n(jcolor.rgb_to_gray_f32(jnp.asarray(rgb))))


@pytest.mark.parametrize("shape,scale", [
    ((97, 131, 3), 40.0), ((97, 131), 40.0), ((2, 120, 90, 3), 64.0),
    ((130, 200), 75.5),
])
def test_scale_image_matches_jax(shape, scale):
    x = np.random.default_rng(41).integers(0, 256, shape).astype(np.uint8)
    got = resize.scale_image(t(x), scale)
    want = np.asarray(jresize.scale_image(jnp.asarray(x), scale))
    assert tuple(got.shape) == want.shape and got.dtype == torch.uint8
    off = np.abs(n(got).astype(int) - want.astype(int))
    assert off.max() <= 1 and (off > 0).mean() < 1e-3  # Queue C, C2


def test_prelude_surface():
    from libstacker_tpu_torch import prelude

    assert prelude.RANSAC == 8
    assert callable(prelude.keypoint_match)
    assert callable(prelude.ecc_match)
    assert callable(prelude.ecc_match_stream)
    assert callable(prelude.keypoint_match_stream)
    assert prelude.MotionType.Homography == 3
    from libstacker_tpu import prelude as jprelude

    assert sorted(n for n in dir(prelude) if not n.startswith("_")) == sorted(
        n for n in dir(jprelude) if not n.startswith("_"))
