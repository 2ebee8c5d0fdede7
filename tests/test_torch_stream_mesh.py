"""PyTorch port vs libstacker_tpu: the streams over a mesh
(``mesh=`` on ``ecc_match_stream`` / ``keypoint_match_stream``), on a CPU
mesh of 4 shards.

The three cases of ``tests/test_stream_mesh.py`` with its bursts and
bars, held against the JAX package's whole-burst DENSE pipelines, as
that file holds the JAX package's stream over its mesh:

- ECC mean: atol 2e-4; chunk_size 3 rounds up to 4, 9 lanes -> chunks
  of 4 + 4 + 1 (the tail padded with frame 0, its pad lanes left out);
- ECC sigma-clip: ``(diff <= 2e-4).mean() > 0.99``, max < 0.05;
- keypoint mean: equal drop counts, atol 0.06, mean < 5e-3 (RANSAC
  draws per chunk and shard, so the agreement is statistical).

Each is also held to the port's own stream on one device (within 1e-6
for ECC; the keypoint stream draws per chunk there, so at the keypoint
bars).  Then a mesh stream killed after two chunks and resumed from its
checkpoint equals the uninterrupted mesh stream bitwise, and the key of
the checkpoint holds the rounded chunk size, as the JAX package's does.
"""

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("jax")

import libstacker_tpu as J  # noqa: E402

import libstacker_tpu_torch as P  # noqa: E402
from libstacker_tpu_torch.parallel import make_mesh  # noqa: E402
from libstacker_tpu_torch.utils import io as io_mod  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(["cpu"] * 4, data=4, spatial=1)


def _write_burst(d, frames):
    d.mkdir()
    files = []
    for i, f in enumerate(frames):
        p = d / f"f{i:02d}.png"
        Image.fromarray(f).save(p)
        files.append(str(p))
    return files


def _shifted(rng, base, h, w, n):
    frames = []
    shifts = [(0.0, 0.0)] + [
        (float(rng.uniform(-3, 3)), float(rng.uniform(-3, 3)))
        for _ in range(n - 1)
    ]
    for dx, dy in shifts:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1).astype(np.uint8))
    return np.stack(frames)


@pytest.fixture(scope="module")
def ecc_burst_dir(tmp_path_factory):
    """``tests/test_stream_mesh.py``'s ECC burst: 10 frames of 128x160."""
    rng = np.random.default_rng(11)
    h, w = 128, 160
    base = cv2.GaussianBlur(
        rng.random((h * 2, w * 2)).astype(np.float32), (0, 0), 3.0) * 255.0
    frames = _shifted(rng, base, h, w, 10)
    d = tmp_path_factory.mktemp("stream_mesh") / "ecc"
    return _write_burst(d, frames), frames


@pytest.fixture(scope="module")
def kp_burst_dir(tmp_path_factory):
    """``tests/test_stream_mesh.py``'s keypoint burst: 6 of 192x256."""
    rng = np.random.default_rng(19)
    h, w = 192, 256
    base = cv2.GaussianBlur(
        rng.integers(0, 256, (h * 2, w * 2), np.uint8), (0, 0), 1.2)
    frames = _shifted(rng, base, h, w, 6)
    d = tmp_path_factory.mktemp("stream_mesh_kp") / "kp"
    return _write_burst(d, frames), frames


def _ecc_params(mod, **kw):
    return mod.EccMatchParameters(motion_type=mod.MotionType.Translation,
                                  max_count=50, epsilon=1e-4, **kw)


def test_ecc_stream_mesh_matches_dense(ecc_burst_dir, mesh4):
    files, frames = ecc_burst_dir
    dense = np.asarray(J.ecc_match_arrays(frames, _ecc_params(J)))
    out, stats = P.ecc_match_stream(files, _ecc_params(P), chunk_size=3,
                                    mesh=mesh4, return_stats=True)
    np.testing.assert_allclose(out, dense, atol=2e-4)
    assert stats.frames_total == 10 and stats.frames_kept == 10
    assert len(stats.ecc_rho) == 9
    one = P.ecc_match_stream(files, _ecc_params(P), chunk_size=4,
                             device="cpu")
    np.testing.assert_allclose(out, one, atol=1e-6)


def test_ecc_stream_mesh_sigma_matches_dense(ecc_burst_dir, mesh4):
    files, frames = ecc_burst_dir
    jp = _ecc_params(J, stacking="sigma_clip", sigma_kappa=2.0,
                     sigma_iters=2)
    pp = _ecc_params(P, stacking="sigma_clip", sigma_kappa=2.0,
                     sigma_iters=2)
    dense = np.asarray(J.ecc_match_arrays(frames, jp))
    out, stats = P.ecc_match_stream(files, pp, chunk_size=3, mesh=mesh4,
                                    return_stats=True)
    diff = np.abs(out - dense)
    assert (diff <= 2e-4).mean() > 0.99, (diff <= 2e-4).mean()
    assert diff.max() < 0.05, diff.max()
    one, ost = P.ecc_match_stream(files, pp, chunk_size=4, device="cpu",
                                  return_stats=True)
    np.testing.assert_allclose(out, one, atol=1e-6)
    assert stats.clipped_sample_frac == pytest.approx(
        ost.clipped_sample_frac, abs=1e-6)


def test_keypoint_stream_mesh_matches_dense(kp_burst_dir, mesh4):
    files, frames = kp_burst_dir
    d_drop, dense = J.keypoint_match_arrays(frames, J.KeyPointMatchParameters())
    s_drop, out = P.keypoint_match_stream(
        files, P.KeyPointMatchParameters(), chunk_size=8, mesh=mesh4)
    assert s_drop == d_drop
    np.testing.assert_allclose(out, np.asarray(dense), atol=0.06)
    assert np.mean(np.abs(out - np.asarray(dense))) < 5e-3
    o_drop, one = P.keypoint_match_stream(
        files, P.KeyPointMatchParameters(), chunk_size=8, device="cpu")
    assert o_drop == s_drop
    np.testing.assert_allclose(out, one, atol=0.06)
    # sigma-clip: the homographies gathered, the sweeps' moments reduced;
    # against the one-device stream at the keypoint sigma-clip bar
    # (tests/test_stack.py:535-570)
    sig = P.KeyPointMatchParameters(stacking="sigma_clip")
    g_drop, got = P.keypoint_match_stream(files, sig, chunk_size=8,
                                          mesh=mesh4)
    w_drop, want = P.keypoint_match_stream(files, sig, chunk_size=8,
                                           device="cpu")
    assert g_drop == w_drop == 0
    assert np.mean(np.abs(got - want)) < 5e-3


class _Crash:
    """``io.prefetched_chunks`` that raises after ``limit`` chunks."""

    def __init__(self, limit):
        self.limit = limit
        self.orig = io_mod.prefetched_chunks
        self.starts = []

    def __call__(self, files, chunk_size, h, w, start=1, **kw):
        self.starts.append(start)
        inner = self.orig(files, chunk_size, h, w, start=start, **kw)

        def gen():
            for i, chunk in enumerate(inner):
                if self.limit is not None and i >= self.limit:
                    raise RuntimeError("simulated crash")
                yield chunk

        return gen()


@pytest.mark.parametrize("path", ["ecc", "keypoint"])
def test_mesh_stream_resume_bitwise(ecc_burst_dir, kp_burst_dir, mesh4,
                                    tmp_path, monkeypatch, path):
    """Killed after two chunks of 4 (chunk_size 3 rounded up), resumed
    from the checkpoint: bitwise the uninterrupted mesh stream, starting
    at file 1 + 1 * 4 (the checkpoint after chunk 1 of 2 read)."""
    from libstacker_tpu_torch.utils.checkpoint import burst_key

    if path == "ecc":
        files = ecc_burst_dir[0]
        run = lambda **kw: P.ecc_match_stream(  # noqa: E731
            files, _ecc_params(P), chunk_size=3, mesh=mesh4, **kw)
        key = burst_key(files, _ecc_params(P), None, 4, extra="ecc")
    else:
        files = kp_burst_dir[0] + kp_burst_dir[0][1:5]
        run = lambda **kw: P.keypoint_match_stream(  # noqa: E731
            files, P.KeyPointMatchParameters(), chunk_size=3, mesh=mesh4,
            seed=2, **kw)
        key = burst_key(files, P.KeyPointMatchParameters(), None, 4,
                        extra="kp|2")
    want = run()
    ck = tmp_path / "ck.npz"
    monkeypatch.setattr(io_mod, "prefetched_chunks", _Crash(2))
    with pytest.raises(RuntimeError, match="simulated crash"):
        run(checkpoint_path=ck, checkpoint_every=1)
    with np.load(ck) as z:
        assert str(z["key"]) == key and int(z["chunks_done"]) == 1
    resume = _Crash(None)
    monkeypatch.setattr(io_mod, "prefetched_chunks", resume)
    got = run(checkpoint_path=ck, checkpoint_every=1)
    assert resume.starts == [5]
    assert not ck.exists()
    if path == "ecc":
        np.testing.assert_array_equal(got, want)
    else:
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
