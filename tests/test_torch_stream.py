"""PyTorch port vs libstacker_tpu: the chunked streams (ROADMAP.md Queue
A item 14b) on the CPU.

The same PNG files go through ``libstacker_tpu``'s streams and the
port's (``device="cpu"``), and the port's stream is also held against
its own whole-burst path on the decoded frames.  Bars:

- ECC mean: atol 1e-5, the JAX package's own stream-vs-batch bar
  (``tests/test_pipeline_ecc.py:231-247``);
- ECC sigma-clip against the port's whole-burst path: ``(diff <= 1e-4)
  .mean() > 0.999`` and max < 0.05, the JAX package's stream-vs-batch bar
  (``tests/test_stack.py:475-530``); against the JAX package's stream:
  the port's whole-burst sigma-clip bar (``tests/test_torch_stack.py``:
  max < 0.02 inside an 8-px margin, clipped fraction within 5e-3).  The
  port's whole-burst sigma stack already differs from the JAX package's
  on ~1.5 % of this burst's interior values (up to 3e-3, the solved
  warps' ulps moving 1/32-px bins), and the streams reproduce that;
- keypoint mean: interior p99 < 0.02 and max < 0.2; keypoint sigma-clip:
  mean abs < 5e-3 (``tests/test_pipeline_keypoint.py:150-156``,
  ``tests/test_stack.py:535-570``): RANSAC draws per chunk, so the
  streams agree statistically, not bitwise.

Also the guards (``output_scale``, the sigma border), ``mesh="auto"``
against the stream on one device, the failure modes and ``pad_chunk`` / ``prefetched_chunks`` against the
JAX package's.  The resume scenarios are in
``tests/test_torch_stream_resume.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("jax")

import libstacker_tpu as J  # noqa: E402
from libstacker_tpu.utils import io as jio  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from libstacker_tpu_torch import constants, errors  # noqa: E402
from libstacker_tpu_torch.utils import io as pio  # noqa: E402
from libstacker_tpu_torch.utils.device import ChunkUploader  # noqa: E402

torch.set_num_threads(2)


def _write(frames, d, tag):
    d.mkdir(parents=True, exist_ok=True)
    files = []
    for i, f in enumerate(frames):
        p = d / f"{tag}{i:02d}.png"
        cv2.imwrite(str(p), np.ascontiguousarray(f[..., ::-1]))
        files.append(str(p))
    return files


def _ecc_params(mod, **kw):
    base = dict(motion_type=mod.MotionType.Translation, max_count=50,
                epsilon=1e-4, gauss_filt_size=5)
    base.update(kw)
    return mod.EccMatchParameters(**base)


@pytest.fixture(scope="module")
def ecc_burst(tmp_path_factory):
    """5 frames of 80x100 shifted by up to 3 px
    (``tests/test_pipeline_ecc.py:_make_burst``)."""
    rng = np.random.default_rng(12345)
    h, w = 80, 100
    base = cv2.GaussianBlur(rng.random((h * 2, w * 2)).astype(np.float32),
                            (0, 0), 3.0)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.uint8)
    frames = []
    for i in range(5):
        dx, dy = rng.uniform(-3, 3, 2) if i else (0.0, 0.0)
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(base, m, (w * 2, h * 2),
                             flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        crop = cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([crop] * 3, axis=-1))
    frames = np.stack(frames)
    return frames, _write(frames, tmp_path_factory.mktemp("ecc"), "f")


@pytest.fixture(scope="module")
def sigma_burst(tmp_path_factory):
    """16 frames of 96x128 with a streak in frame 5
    (``tests/test_stack.py:475-530``)."""
    rng = np.random.default_rng(31)
    h, w = 96, 128
    base = cv2.GaussianBlur(
        rng.integers(40, 200, (h, w, 3), np.uint8).astype(np.uint8),
        (0, 0), 3.0,
    )
    frames = []
    for _ in range(16):
        dx, dy = int(rng.integers(-3, 4)), int(rng.integers(-3, 4))
        f = np.roll(base, (dy, dx), (0, 1))
        noise = rng.normal(0, 2.0, f.shape)
        frames.append(np.clip(f.astype(np.float32) + noise, 0, 255)
                      .astype(np.uint8))
    frames = np.stack(frames)
    streaked = frames[5].copy()
    cv2.line(streaked, (10, 20), (110, 70), (255, 255, 255), 2)
    frames[5] = streaked
    return frames, _write(frames, tmp_path_factory.mktemp("sigma"), "f")


@pytest.fixture(scope="module")
def kp_burst(tmp_path_factory):
    """9 textured frames of 192x256 rolled by up to 4 px, a streak in
    frame 4 (``tests/test_stack.py:535-570``)."""
    rng = np.random.default_rng(33)
    h, w = 192, 256
    base = cv2.resize(
        rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8).astype(np.uint8),
        (w, h), interpolation=cv2.INTER_NEAREST,
    )
    frames = []
    for _ in range(9):
        dx, dy = int(rng.integers(-4, 5)), int(rng.integers(-4, 5))
        frames.append(np.roll(base, (dy, dx), (0, 1)))
    frames = np.stack(frames)
    streaked = frames[4].copy()
    cv2.line(streaked, (30, 40), (220, 150), (255, 255, 255), 3)
    frames[4] = streaked
    return frames, _write(frames, tmp_path_factory.mktemp("kp"), "k")


def _near_exact(a, b):
    diff = np.abs(a - b)
    return (diff <= 1e-4).mean() > 0.999 and diff.max() < 0.05


def test_ecc_stream_mean_matches_jax_and_whole_burst(ecc_burst):
    frames, files = ecc_burst
    want = J.ecc_match_stream(files, _ecc_params(J), chunk_size=2)
    got, st = P.ecc_match_stream(files, _ecc_params(P), chunk_size=2,
                                 return_stats=True, device="cpu")
    assert got.dtype == np.float32 and got.shape == frames.shape[1:]
    np.testing.assert_allclose(got, want, atol=1e-5)
    whole, wst = P.ecc_match_arrays(frames, _ecc_params(P), device="cpu",
                                    return_stats=True)
    np.testing.assert_allclose(got, whole, atol=1e-5)
    assert (st.frames_total, st.frames_kept, st.frames_dropped) == (5, 5, 0)
    np.testing.assert_array_equal(st.ecc_iterations, wst.ecc_iterations)
    np.testing.assert_allclose(st.ecc_rho, wst.ecc_rho, rtol=1e-6)
    # the chunking moves nothing but the order of the frame sums
    for chunk in (1, 3, 4, 16):
        np.testing.assert_allclose(
            P.ecc_match_stream(files, _ecc_params(P), chunk_size=chunk,
                               device="cpu"), whole, atol=1e-5)


def test_ecc_stream_scaled_masked_and_16_bit(ecc_burst):
    frames, files = ecc_burst
    mask = np.ones(frames.shape[1:3], np.uint8)
    mask[:20, :25] = 0
    for kw in (dict(scale_down_width=60.0), dict(mask=mask),
               dict(preserve_depth=True)):
        got = P.ecc_match_stream(files, _ecc_params(P), chunk_size=3,
                                 device="cpu", **kw)
        whole = P.ecc_match(files, _ecc_params(P), device="cpu", **kw)
        np.testing.assert_allclose(got, whole, atol=1e-5)


def test_ecc_stream_on_failure(ecc_burst, tmp_path):
    """A flat frame fails: "raise" names it with the JAX stream's
    message; "drop" leaves it out and divides by ``1 + kept``, as the
    whole-burst path does."""
    frames, _ = ecc_burst
    bad = frames.copy()
    bad[3] = 128
    files = _write(bad, tmp_path, "b")
    with pytest.raises(J.ProcessingError) as je:
        J.ecc_match_stream(files, _ecc_params(J), chunk_size=2)
    with pytest.raises(errors.ProcessingError) as pe:
        P.ecc_match_stream(files, _ecc_params(P), chunk_size=2, device="cpu")
    assert str(pe.value) == str(je.value)
    got, st = P.ecc_match_stream(files, _ecc_params(P), chunk_size=2,
                                 on_failure="drop", return_stats=True,
                                 device="cpu")
    whole = P.ecc_match_arrays(bad, _ecc_params(P), on_failure="drop",
                               device="cpu")
    assert (st.frames_kept, st.frames_dropped) == (4, 1)
    np.testing.assert_allclose(got, whole, atol=1e-5)


def test_ecc_stream_sigma_clip_matches_jax_and_whole_burst(sigma_burst):
    frames, files = sigma_burst
    kw = dict(max_count=80, stacking="sigma_clip", sigma_kappa=2.5,
              sigma_iters=2)
    want, jst = J.ecc_match_stream(files, _ecc_params(J, **kw), chunk_size=5,
                                   return_stats=True)
    got, st = P.ecc_match_stream(files, _ecc_params(P, **kw), chunk_size=5,
                                 return_stats=True, device="cpu")
    whole, wst = P.ecc_match_arrays(frames, _ecc_params(P, **kw),
                                    return_stats=True, device="cpu")
    assert _near_exact(got, whole)
    assert np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8]).max() < 0.02
    assert st.frames_kept == wst.frames_kept == jst.frames_kept == 16
    assert st.clipped_sample_frac > 0.0  # the streak was rejected
    assert abs(st.clipped_sample_frac - jst.clipped_sample_frac) < 5e-3
    # chunks of 8 group the sums as the whole-burst CPU path does
    got8, st8 = P.ecc_match_stream(files, _ecc_params(P, **kw), chunk_size=8,
                                   return_stats=True, device="cpu")
    np.testing.assert_array_equal(got8, whole)
    assert st8.clipped_sample_frac == wst.clipped_sample_frac


def test_keypoint_stream_mean_matches_jax_and_whole_burst(kp_burst):
    frames, files = kp_burst
    files, frames = files[:5], frames[:5]
    jd, want = J.keypoint_match_stream(files, J.KeyPointMatchParameters(),
                                       seed=7, chunk_size=2)
    pd, got, st = P.keypoint_match_stream(
        files, P.KeyPointMatchParameters(), seed=7, chunk_size=2,
        return_stats=True, device="cpu")
    wd, whole = P.keypoint_match_arrays(frames, seed=7, device="cpu")
    assert jd == pd == wd == 0
    m = 16
    for other in (want, whole):
        diff = np.abs(got[m:-m, m:-m] - other[m:-m, m:-m])
        assert np.quantile(diff, 0.99) < 0.02
        assert diff.max() < 0.2
    assert st.frames_total == 5 and len(st.match_counts) == 4
    assert all(c >= 5 for c in st.match_counts)


@pytest.mark.parametrize("border", [constants.BORDER_REPLICATE,
                                    constants.BORDER_TRANSPARENT])
def test_keypoint_stream_borders(kp_burst, border):
    frames, files = kp_burst
    files, frames = files[:4], frames[:4]
    p = P.KeyPointMatchParameters(border_mode=border)
    d, got = P.keypoint_match_stream(files, p, seed=2, chunk_size=2,
                                     device="cpu")
    wd, whole = P.keypoint_match_arrays(frames, p, seed=2, device="cpu")
    assert d == wd == 0
    diff = np.abs(got[16:-16, 16:-16] - whole[16:-16, 16:-16])
    assert np.quantile(diff, 0.99) < 0.02


def test_keypoint_stream_sigma_clip_matches_jax_and_whole_burst(kp_burst):
    frames, files = kp_burst
    kw = dict(stacking="sigma_clip", sigma_kappa=2.0, sigma_iters=1)
    jd, want = J.keypoint_match_stream(
        files, J.KeyPointMatchParameters(**kw), chunk_size=4, seed=3)
    pd, got, st = P.keypoint_match_stream(
        files, P.KeyPointMatchParameters(**kw), chunk_size=4, seed=3,
        return_stats=True, device="cpu")
    wd, whole = P.keypoint_match_arrays(
        frames, P.KeyPointMatchParameters(**kw), seed=3, device="cpu")
    assert jd == pd == wd == 0
    assert st.clipped_sample_frac is not None and st.clipped_sample_frac > 0
    assert np.mean(np.abs(got - want)) < 5e-3
    assert np.mean(np.abs(got - whole)) < 5e-3


def test_stream_guards(ecc_burst, kp_burst):
    _, files = ecc_burst
    _, kfiles = kp_burst
    for mod_stream, pstream, kw, fl in (
        (J.ecc_match_stream, P.ecc_match_stream, {}, files),
        (J.keypoint_match_stream, P.keypoint_match_stream, {}, kfiles),
    ):
        jp = (_ecc_params(J, output_scale=2) if pstream is P.ecc_match_stream
              else J.KeyPointMatchParameters(output_scale=2))
        pp = (_ecc_params(P, output_scale=2) if pstream is P.ecc_match_stream
              else P.KeyPointMatchParameters(output_scale=2))
        with pytest.raises(J.InvalidParamsError) as je:
            mod_stream(fl, jp)
        with pytest.raises(errors.InvalidParamsError) as pe:
            pstream(fl, pp, device="cpu")
        assert str(pe.value) == str(je.value)
        # mesh= (ROADMAP.md item 16, once refused here) runs: a one-shard
        # CPU mesh streams what the device stream does, bit for bit (the
        # stream without a mesh runs on a one-device mesh; one shard
        # seeds RANSAC from (seed, chunk) alone)
        p1 = dataclasses.replace(pp, output_scale=1)
        meshed = pstream(fl, p1, chunk_size=4, mesh="auto", device="cpu")
        plain = pstream(fl, p1, chunk_size=4, device="cpu")
        if pstream is P.ecc_match_stream:
            np.testing.assert_array_equal(meshed, plain)
        else:
            assert meshed[0] == plain[0]
            np.testing.assert_array_equal(meshed[1], plain[1])
        with pytest.raises(errors.NotEnoughFilesError):
            pstream([], dataclasses.replace(pp, output_scale=1), device="cpu")
    jp = J.KeyPointMatchParameters(stacking="sigma_clip",
                                   border_mode=constants.BORDER_REPLICATE)
    pp = P.KeyPointMatchParameters(stacking="sigma_clip",
                                   border_mode=constants.BORDER_REPLICATE)
    with pytest.raises(J.InvalidParamsError) as je:
        J.keypoint_match_stream(kfiles, jp)
    with pytest.raises(errors.InvalidParamsError) as pe:
        P.keypoint_match_stream(kfiles, pp, device="cpu")
    assert str(pe.value) == str(je.value)
    for sdw in (100.0, 120.0, 10.0):
        with pytest.raises(J.InvalidParamsError) as je:
            J.ecc_match_stream(files, _ecc_params(J), scale_down_width=sdw)
        with pytest.raises(errors.InvalidParamsError) as pe:
            P.ecc_match_stream(files, _ecc_params(P), scale_down_width=sdw,
                               device="cpu")
        assert str(pe.value) == str(je.value)
    # CUDA asked for without a card raises; it never falls back
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            P.ecc_match_stream(files, _ecc_params(P))
        with pytest.raises(RuntimeError, match="cuda"):
            P.keypoint_match_stream(kfiles)


def test_single_file_streams(ecc_burst):
    frames, files = ecc_burst
    # ECC: frame 0 in [0,1] as the stack's sum holds it (x * 1/255)
    got = P.ecc_match_stream(files[:1], _ecc_params(P), device="cpu")
    np.testing.assert_array_equal(
        got, frames[0].astype(np.float32) * np.float32(1.0 / 255.0))
    # keypoint: the reference's early return (x / 255)
    want = frames[0].astype(np.float32) / 255.0
    d, got = P.keypoint_match_stream(files[:1], device="cpu")
    assert d == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, J.keypoint_match_stream(files[:1])[1])


@pytest.mark.parametrize("n_frames,chunk", [(3, 5), (5, 5), (7, 3)])
def test_pad_chunk_matches_jax(n_frames, chunk):
    rng = np.random.default_rng(n_frames)
    frames = rng.integers(0, 256, (min(n_frames, chunk), 6, 7, 3), np.uint8)
    fill = rng.integers(0, 256, (6, 7, 3), np.uint8)
    for f in (None, fill):
        got = pio.pad_chunk(frames, chunk, fill=f)
        np.testing.assert_array_equal(got, jio.pad_chunk(frames, chunk, fill=f))
        assert got.shape[0] == chunk


@pytest.mark.parametrize("start,chunk", [(1, 2), (0, 3), (4, 8)])
def test_prefetched_chunks_match_jax(ecc_burst, start, chunk):
    frames, files = ecc_burst
    got = list(pio.prefetched_chunks(files, chunk, 80, 100, start=start))
    want = list(jio.prefetched_chunks(files, chunk, 80, 100, start=start))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got), frames[start:])
    with pytest.raises(errors.StackerIoError, match="size mismatch"):
        list(pio.prefetched_chunks(files, chunk, 80, 99, start=start))


def test_chunk_uploader_cpu_wraps_without_copy():
    frames = np.arange(2 * 3 * 4 * 3, dtype=np.uint8).reshape(2, 3, 4, 3)
    up = ChunkUploader(torch.device("cpu"))
    got = up.ready(up.put(frames))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert got.data_ptr() == frames.__array_interface__["data"][0]
    np.testing.assert_array_equal(got.numpy(), frames)
