"""PyTorch port vs libstacker_tpu: image I/O (``utils/io.py``,
``utils/native_loader.py``) and the file entry points.

The same files go to both packages, which must return equal arrays: 8-bit
PNG and JPEG written with cv2, a grey PNG, and 16-bit PNGs written by both
packages' ``save_image``.  ``_write_png16_py`` must give the same bytes.
The error cases must raise the same types with the same messages.
``ecc_match(files, preserve_depth=True)`` and ``keypoint_match(files,
...)`` run on the CPU (``device="cpu"``) against the JAX package's stacked
image under the slice tests' bars (interior max 0.02 for ECC, p99 0.02
for keypoint), and bitwise against the port's own ``_arrays`` form on the
decoded burst.  The native-only cases skip when the port's loader does not
build (``native_loader.available()`` is False), as
``tests/test_io.py:40`` does for the reference's.
"""

import cv2
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("scipy")

import libstacker_tpu as J  # noqa: E402
from libstacker_tpu import errors as jerrors  # noqa: E402
from libstacker_tpu.utils import io as jio  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import burst  # noqa: E402
from libstacker_tpu_torch import errors  # noqa: E402
from libstacker_tpu_torch.utils import io as pio  # noqa: E402
from libstacker_tpu_torch.utils import native_loader  # noqa: E402
from test_pipeline_keypoint import _textured_burst  # noqa: E402

torch.set_num_threads(2)


def _rgb16(rng, h=37, w=53):
    return rng.integers(0, 65536, size=(h, w, 3), dtype=np.uint16)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> path: 8-bit PNG and JPEG (cv2), grey PNG, and the 16-bit PNG
    of one array written by each package's ``save_image``."""
    d = tmp_path_factory.mktemp("io")
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    out = {}
    for name, arr in (("png8", rgb), ("jpeg", rgb),
                      ("grey", rgb[..., 1].copy())):
        path = d / (f"{name}.jpg" if name == "jpeg" else f"{name}.png")
        img = arr if arr.ndim == 2 else arr[..., ::-1]  # cv2 writes BGR
        assert cv2.imwrite(str(path), img)
        out[name] = path
    rgb16 = _rgb16(rng)
    for name, mod in (("png16_port", pio), ("png16_ref", jio)):
        out[name] = d / f"{name}.png"
        mod.save_image(out[name], rgb16, bit_depth=16)
    out["rgb16"] = rgb16
    return out


NAMES = ["png8", "jpeg", "grey", "png16_port", "png16_ref"]


@pytest.mark.parametrize("fn", ["imread_rgb", "imread_gray",
                                "imread_unchanged", "imread"])
@pytest.mark.parametrize("name", NAMES)
def test_imread_matches_reference(files, fn, name):
    got = getattr(pio, fn)(files[name])
    want = getattr(jio, fn)(files[name])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_top_level_exports():
    for name in ("imread", "imread_gray", "imread_unchanged", "save_image",
                 "load_frames"):
        assert callable(getattr(P, name))
    assert P.imread is pio.imread_rgb


@pytest.mark.parametrize("preserve_depth", [False, True])
@pytest.mark.parametrize("name", ["png8", "jpeg", "grey"])
def test_load_frames_pil_matches_reference(files, name, preserve_depth):
    """The PIL path of both packages; ``preserve_depth`` expands 8-bit
    sources x257."""
    kw = dict(use_native=False, preserve_depth=preserve_depth)
    got = pio.load_frames([files[name]] * 2, **kw)
    want = jio.load_frames([files[name]] * 2, **kw)
    assert got.dtype == want.dtype == (np.uint16 if preserve_depth
                                       else np.uint8)
    np.testing.assert_array_equal(got, want)
    if preserve_depth:
        low = pio.load_frames([files[name]], use_native=False)
        np.testing.assert_array_equal(got[:1], low.astype(np.uint16) * 257)


@pytest.mark.parametrize("name", ["png16_port", "png16_ref"])
def test_load_frames_16bit_png(files, name):
    """Without ``preserve_depth`` both keep the high byte; at full depth
    without the native loader both refuse a 48-bit PNG with the same
    message (PIL would reduce it to 8 bits)."""
    got = pio.load_frames([files[name]], use_native=False)
    np.testing.assert_array_equal(
        got, jio.load_frames([files[name]], use_native=False))
    np.testing.assert_array_equal(got[0], (files["rgb16"] >> 8).astype(np.uint8))
    with pytest.raises(errors.StackerIoError) as e_port:
        pio.load_frames([files[name]], use_native=False, preserve_depth=True)
    with pytest.raises(jerrors.StackerIoError) as e_ref:
        jio.load_frames([files[name]], use_native=False, preserve_depth=True)
    assert str(e_port.value) == str(e_ref.value)


def test_write_png16_py_bytes_match_reference(tmp_path):
    rgb16 = _rgb16(np.random.default_rng(5), 19, 23)
    pio._write_png16_py(tmp_path / "a.png", rgb16)
    jio._write_png16_py(tmp_path / "b.png", rgb16)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


@pytest.mark.parametrize("img", ["float", "uint8", "grey16"])
def test_save_image_16bit_matches_reference(tmp_path, img):
    """``save_image(bit_depth=16)`` of both packages decodes to the same
    array (the port's may go through libpng, the reference's here through
    the pure-Python encoder)."""
    rng = np.random.default_rng(8)
    arr = {"float": rng.random((21, 17, 3), dtype=np.float32),
           "uint8": rng.integers(0, 256, (21, 17, 3), dtype=np.uint8),
           "grey16": _rgb16(rng, 21, 17)[..., 0]}[img]
    pio.save_image(tmp_path / "p.png", arr, bit_depth=16)
    jio.save_image(tmp_path / "j.png", arr, bit_depth=16)
    got = cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


def test_save_image_8bit_and_errors_match_reference(tmp_path):
    img = np.random.default_rng(9).random((9, 11, 3), dtype=np.float32)
    pio.save_image(tmp_path / "p.png", img)
    jio.save_image(tmp_path / "j.png", img)
    np.testing.assert_array_equal(pio.imread(tmp_path / "p.png"),
                                  jio.imread(tmp_path / "j.png"))
    for kw, exc, jexc in (
        (dict(bit_depth=12), ValueError, ValueError),
        (dict(bit_depth=16), errors.StackerIoError, jerrors.StackerIoError),
    ):
        path = tmp_path / "x.tif"
        with pytest.raises(exc) as e_port:
            pio.save_image(path, img, **kw)
        with pytest.raises(jexc) as e_ref:
            jio.save_image(path, img, **kw)
        assert str(e_port.value) == str(e_ref.value)


def _raises_same(call_port, call_ref):
    with pytest.raises(errors.StackerError) as e_port:
        call_port()
    with pytest.raises(jerrors.StackerError) as e_ref:
        call_ref()
    assert type(e_port.value).__name__ == type(e_ref.value).__name__
    return str(e_port.value), str(e_ref.value)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("preserve_depth", [False, True])
def test_load_frames_errors_match_reference(files, tmp_path, use_native,
                                            preserve_depth):
    """Empty list, a size mismatch and an empty directory.  The reference's
    native loader is not built here, so its ``use_native=True`` runs PIL;
    where the port's builds, a size mismatch fails in the native decoder
    and falls back to PIL, which raises the reference's message."""
    kw = dict(use_native=use_native, preserve_depth=preserve_depth)
    _raises_same(lambda: pio.load_frames([], **kw),
                 lambda: jio.load_frames([], **kw))
    other = tmp_path / "other.png"
    cv2.imwrite(str(other), np.zeros((5, 7, 3), np.uint8))
    pair = [files["png8"], other]
    got, want = _raises_same(lambda: pio.load_frames(pair, **kw),
                             lambda: jio.load_frames(pair, **kw))
    assert got == want and "frame size mismatch" in got
    empty = tmp_path / "empty"
    empty.mkdir()
    got, want = _raises_same(lambda: pio.load_frames(str(empty), **kw),
                             lambda: jio.load_frames(str(empty), **kw))
    assert got == want


def test_load_frames_directory_matches_reference(files):
    d = files["png8"].parent
    np.testing.assert_array_equal(
        pio.load_frames(str(d), use_native=False),
        jio.load_frames(str(d), use_native=False))


@pytest.fixture
def native():
    if not native_loader.available():
        pytest.skip(f"native loader not built: {native_loader.build_error()}")


@pytest.mark.parametrize("preserve_depth", [False, True])
def test_native_loader_matches_pil(files, native, preserve_depth):
    """The port's native decoder against the PIL path of the reference:
    bitwise on PNG, within 2 on JPEG (two JPEG decoders, as
    ``tests/test_io.py:48`` allows)."""
    for name in ("png8", "grey", "jpeg"):
        got = pio.load_frames([files[name]], preserve_depth=preserve_depth)
        want = jio.load_frames([files[name]], use_native=False,
                               preserve_depth=preserve_depth)
        assert got.dtype == want.dtype
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert diff.max() <= (0 if name != "jpeg" else
                              2 * (257 if preserve_depth else 1))


def test_native_loader_16bit(files, native):
    """Full-depth decode of both packages' 16-bit PNGs, which the PIL path
    refuses."""
    for name in ("png16_port", "png16_ref"):
        got = pio.load_frames([files[name]] * 2, preserve_depth=True)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got[1], files["rgb16"])
    h, w = native_loader.probe(files["png8"])
    assert (h, w) == (37, 53)
    np.testing.assert_array_equal(
        native_loader.rgb_to_gray_native(files["rgb16"] >> 8 & 255),
        pio.rgb_to_gray_u8_host((files["rgb16"] >> 8 & 255).astype(np.uint8)))


def _ecc_params(mod):
    return mod.EccMatchParameters(
        motion_type=mod.MotionType.Homography, max_count=50, epsilon=1e-4,
        gauss_filt_size=5, coarse_levels=1)


def _write_burst(d, frames):
    paths = []
    for i, f in enumerate(frames):
        paths.append(d / f"f{i}.png")
        assert cv2.imwrite(str(paths[-1]), f[..., ::-1])
    return paths


def test_ecc_match_files_preserve_depth_matches_jax(tmp_path):
    frames = burst(21, 4, 192, 256, max_shift=4.0, max_angle=0.4)[0]
    paths = _write_burst(tmp_path, frames)
    got = P.ecc_match(paths, _ecc_params(P), preserve_depth=True,
                      device="cpu")
    want = J.ecc_match(paths, _ecc_params(J), preserve_depth=True)
    u16 = pio.load_frames(paths, preserve_depth=True)
    np.testing.assert_array_equal(u16, frames.astype(np.uint16) * 257)
    np.testing.assert_array_equal(
        got, P.ecc_match_arrays(u16, _ecc_params(P), device="cpu"))
    assert got.shape == want.shape == frames.shape[1:]
    assert np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02


@pytest.mark.parametrize("preserve_depth", [False, True])
def test_keypoint_match_files_matches_jax(tmp_path, preserve_depth):
    frames, _ = _textured_burst(np.random.default_rng(2026))
    paths = _write_burst(tmp_path, frames)
    kw = dict(ransac_reproj_threshold=5.0, match_ratio=0.9,
              match_keep_ratio=0.8)
    d_got, got = P.keypoint_match(paths, P.KeyPointMatchParameters(**kw),
                                  preserve_depth=preserve_depth, device="cpu")
    d_want, want = J.keypoint_match(paths, J.KeyPointMatchParameters(**kw),
                                    preserve_depth=preserve_depth)
    decoded = pio.load_frames(paths, preserve_depth=preserve_depth)
    d_arr, arr = P.keypoint_match_arrays(
        decoded, P.KeyPointMatchParameters(**kw), device="cpu")
    assert d_got == d_arr == d_want == 0
    np.testing.assert_array_equal(got, arr)
    m = 16
    assert np.quantile(np.abs(got[m:-m, m:-m] - want[m:-m, m:-m]), 0.99) < 0.02
