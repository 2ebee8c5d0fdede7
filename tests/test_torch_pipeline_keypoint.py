"""PyTorch port vs libstacker_tpu: the ORB-keypoint align+stack slice end
to end.

``libstacker_tpu_torch.keypoint_match_arrays`` (plain CPU path,
``device="cpu"``) against ``libstacker_tpu.keypoint_match_arrays`` on
tests/test_pipeline_keypoint.py's burst (block texture, rotations up to
1 degree, shifts up to 4 px).  RANSAC draws differ between the two
(torch.Generator vs jax.random), so, as that file holds the JAX package
to OpenCV, the port is held statistically: the same ``dropped``, both
stacks within that file's p99 bars of the ground-truth-warp stack (0.04;
0.08 on the scaled path; 0.05 for LMEDS), and the two stacks within
0.02 of each other at the 99th percentile.  Also the featureless frame,
``n == 1``, the stats, BORDER_TRANSPARENT, the tiny scale width that
drops every frame, the guards, ``keypoint_match`` on files, uint16
bursts, ``output_scale=2`` and ``mesh="auto"`` (once refused).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

import libstacker_tpu as J  # noqa: E402
import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import n  # noqa: E402
from libstacker_tpu_torch import constants, errors  # noqa: E402
from test_pipeline_keypoint import _textured_burst, _truth_stack  # noqa: E402

torch.set_num_threads(2)

M = 16  # interior margin of the stack comparisons


def _params(mod, **kw):
    base = dict(ransac_reproj_threshold=5.0, match_ratio=0.9,
                match_keep_ratio=0.8)
    base.update(kw)
    return mod.KeyPointMatchParameters(**base)


def _p99(a, b):
    return float(np.quantile(np.abs(a[M:-M, M:-M] - b[M:-M, M:-M]), 0.99))


@pytest.fixture(scope="module")
def burst():
    return _textured_burst(np.random.default_rng(2026))


@pytest.fixture(scope="module")
def truth(burst):
    frames, true_h = burst
    return _truth_stack(frames, true_h, *frames.shape[1:3])


@pytest.fixture(scope="module")
def jax_full(burst):
    return J.keypoint_match_arrays(burst[0], _params(J), return_stats=True)


@pytest.mark.parametrize("scaled", [False, True])
def test_slice_matches_jax(burst, truth, jax_full, scaled):
    frames = burst[0]
    kw = dict(scale_down_width=200.0) if scaled else {}
    bar = 0.08 if scaled else 0.04
    d_got, got = P.keypoint_match_arrays(frames, _params(P), device="cpu", **kw)
    if scaled:
        d_want, want = J.keypoint_match_arrays(frames, _params(J), **kw)
    else:
        d_want, want, _ = jax_full
    assert d_got == d_want == 0
    assert got.shape == want.shape == frames.shape[1:] and got.dtype == np.float32
    assert _p99(got, truth) < bar and _p99(want, truth) < bar
    assert _p99(got, want) < 0.02


def test_stats_match_jax(burst, jax_full):
    frames = burst[0]
    d, _, st = P.keypoint_match_arrays(frames, _params(P), return_stats=True,
                                       device="cpu")
    jst = jax_full[2]
    assert (st.frames_total, st.frames_kept, st.frames_dropped) == (
        jst.frames_total, jst.frames_kept, jst.frames_dropped) == (4, 4, 0)
    assert len(st.match_counts) == len(st.inlier_counts) == 3
    assert all(c >= 5 for c in st.match_counts)
    assert all(i >= 4 for i in st.inlier_counts)
    np.testing.assert_allclose(st.match_counts, jst.match_counts, rtol=0.1)
    np.testing.assert_allclose(st.inlier_counts, jst.inlier_counts, rtol=0.1)
    assert list(st.phase_ms) == ["grey", "detect", "match+ransac", "stack"]


def test_featureless_frame_dropped(burst):
    frames = burst[0].copy()
    frames[2] = 128  # no FAST corners -> no matches -> dropped
    d_got, got = P.keypoint_match_arrays(frames, _params(P), device="cpu")
    d_want, want = J.keypoint_match_arrays(frames, _params(J))
    assert d_got == d_want == 1
    assert np.isfinite(got).all()
    assert _p99(got, want) < 0.02


def test_lmeds_matches_jax(burst, truth):
    frames = burst[0]
    kw = dict(method=constants.LMEDS)
    d_got, got = P.keypoint_match_arrays(frames, _params(P, **kw), device="cpu")
    d_want, want = J.keypoint_match_arrays(
        frames, _params(J, method=J.constants.LMEDS))
    assert d_got == d_want == 0
    assert _p99(got, truth) < 0.05 and _p99(want, truth) < 0.05


def test_border_transparent_and_device_output(burst):
    frames = burst[0]
    d0, const = P.keypoint_match_arrays(frames, _params(P), seed=3,
                                        device="cpu")
    d1, transp = P.keypoint_match_arrays(
        frames, _params(P, border_mode=constants.BORDER_TRANSPARENT,
                        border_value=(0.5, 0.5, 0.5, 0.0)),
        seed=3, device="cpu", device_output=True)
    assert isinstance(transp, torch.Tensor) and d0 == d1
    # over the zero base TRANSPARENT is tap-wise CONSTANT 0
    np.testing.assert_array_equal(n(transp), const)
    d2, jt = J.keypoint_match_arrays(
        frames, _params(J, border_mode=J.constants.BORDER_TRANSPARENT), seed=3)
    assert d2 == d1 and _p99(const, jt) < 0.02


def test_single_frame_and_tiny_scale(burst):
    frames = burst[0]
    d, got = P.keypoint_match_arrays(frames[:1], device="cpu")
    assert d == 0
    np.testing.assert_allclose(got, frames[0].astype(np.float32) / 255.0)
    d, got, st = P.keypoint_match_arrays(frames[:1], return_stats=True,
                                         device="cpu")
    assert (d, st.frames_total, st.frames_kept, st.frames_dropped) == (0, 1, 1, 0)
    # no pyramid level survives the edge check: every frame dropped, the
    # stack is frame 0 (the keypoint path has no <= 10 guard)
    d, got = P.keypoint_match_arrays(frames[:3], scale_down_width=12,
                                     device="cpu")
    jd, jgot = J.keypoint_match_arrays(frames[:3], scale_down_width=12)
    assert d == jd == 2
    np.testing.assert_allclose(got, frames[0].astype(np.float32) / 255.0)
    d, _ = P.keypoint_match_arrays(frames[:2], scale_down_width=8,
                                   device="cpu")
    assert d == 1


def test_guards_match_jax(burst):
    frames = burst[0]
    for mod, errs, kw in ((P, errors, dict(device="cpu")), (J, J.errors, {})):
        with pytest.raises(errs.InvalidParamsError) as e:
            mod.keypoint_match_arrays(frames, scale_down_width=320, **kw)
        assert "scale_down_to was larger (or equal)" in str(e.value)
        with pytest.raises(errs.NotEnoughFilesError):
            mod.keypoint_match_arrays(frames[:0], **kw)
        with pytest.raises(errs.InvalidParamsError, match="uint8 or uint16"):
            mod.keypoint_match_arrays(frames.astype(np.float32), **kw)
        with pytest.raises(errs.InvalidParamsError, match=r"\[N,H,W,3\]"):
            mod.keypoint_match_arrays(frames[..., :2], **kw)
        with pytest.raises(errs.InvalidParamsError, match="method"):
            mod.keypoint_match_arrays(
                frames, mod.KeyPointMatchParameters(method=5), **kw)


def test_files_and_uint16(burst, tmp_path):
    frames = burst[0][:3]
    files = []
    for i, f in enumerate(frames):
        p = tmp_path / f"frame{i}.png"
        Image.fromarray(f).save(p)
        files.append(p)
    d_f, from_files = P.keypoint_match(files, _params(P), seed=1, device="cpu")
    d_a, from_arrays = P.keypoint_match_arrays(frames, _params(P), seed=1,
                                               device="cpu")
    assert d_f == d_a == 0
    np.testing.assert_array_equal(from_files, from_arrays)
    # uint16: detection on the high byte (the same grey), stack at depth
    d16, out16 = P.keypoint_match_arrays(frames.astype(np.uint16) * 257,
                                         _params(P), seed=1, device="cpu")
    assert d16 == 0
    np.testing.assert_allclose(out16, from_arrays, atol=1e-6)


@pytest.mark.parametrize("kw,item", [
    (dict(mesh="auto"), "item 16"),
])
def test_unported_options_raise(burst, kw, item):
    """The option this package once refused (ROADMAP.md ``item``), now
    ported: ``mesh="auto"`` with ``device="cpu"`` is a one-shard CPU
    mesh; its RANSAC draws from the shard's generator, so it is held to
    the dense path at the slice's p99 bar with equal drops."""
    d_want, want = P.keypoint_match_arrays(burst[0], device="cpu")
    d_got, got = P.keypoint_match_arrays(burst[0], device="cpu", **kw)
    assert d_got == d_want, item
    assert _p99(got, want) < 0.02


def test_output_scale_matches_jax(burst, truth):
    """``output_scale=2`` (no longer refused): the 2x grid, the 2x2 box
    mean within the slice's p99 bar of the truth stack, and the JAX
    package's SR image within 0.02 at the 99th percentile."""
    frames = burst[0]
    h, w = frames.shape[1:3]
    d_got, got = P.keypoint_match_arrays(frames, _params(P, output_scale=2),
                                         device="cpu")
    d_want, want = J.keypoint_match_arrays(frames, _params(J, output_scale=2))
    assert d_got == d_want == 0
    assert got.shape == want.shape == (2 * h, 2 * w, 3)
    down = got.reshape(h, 2, w, 2, 3).mean((1, 3))
    assert _p99(down, truth) < 0.04
    assert _p99(got, want) < 0.02


def test_unported_entry_points_raise(burst):
    """The entry points once refused: ``mesh=`` (item 16), the stream
    included, ``preserve_depth`` (item 14a) and the stream (item 14b) are
    ported and raise the reference's error for a file that does not
    exist."""
    with pytest.raises(errors.StackerIoError):
        P.keypoint_match_stream(["a.png", "b.png"], mesh="auto",
                                device="cpu")
    with pytest.raises(errors.StackerIoError):
        P.keypoint_match_stream(["a.png", "b.png"], device="cpu")
    with pytest.raises(errors.StackerIoError):
        P.keypoint_match(["a.png"], preserve_depth=True, device="cpu")
