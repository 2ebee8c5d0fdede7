"""The port's streams, killed and resumed: every scenario of
``tests/test_stream_checkpoint.py`` run against ``libstacker_tpu_torch``
on the CPU.  An interrupted run resumes from the last saved chunk and
equals an uninterrupted port run bitwise (``utils/checkpoint.py``).  The
crash is injected through ``libstacker_tpu_torch.utils.io
.prefetched_chunks``, which the streams look up at run time; the chunk
starts each resumed run asks for are the JAX package's.  The keypoint
streams seed RANSAC per chunk from ``(seed, chunk index)``, so a resumed
run draws what an uninterrupted one draws with no replay."""

import functools

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from libstacker_tpu_torch import EccMatchParameters, MotionType  # noqa: E402
from libstacker_tpu_torch.models import ecc as ecc_mod  # noqa: E402
from libstacker_tpu_torch.models import keypoint as kp_mod  # noqa: E402
from libstacker_tpu_torch.params import KeyPointMatchParameters  # noqa: E402
from libstacker_tpu_torch.utils import io as io_mod  # noqa: E402

torch.set_num_threads(2)

ecc_match_stream = functools.partial(ecc_mod.ecc_match_stream, device="cpu")
keypoint_match_stream = functools.partial(kp_mod.keypoint_match_stream,
                                          device="cpu")


@pytest.fixture(scope="module")
def burst_dir(tmp_path_factory):
    rng = np.random.default_rng(33)
    h, w = 96, 128
    small = rng.integers(0, 256, (h // 8, w // 8), np.uint8)
    tex = small.repeat(8, 0).repeat(8, 1)
    d = tmp_path_factory.mktemp("burst")
    for i in range(6):
        f = np.roll(tex, i % 3, axis=1)
        Image.fromarray(np.stack([f] * 3, -1)).save(d / f"f{i}.png")
    return d


_ORIG_PREFETCH = io_mod.prefetched_chunks


class _Interrupter:
    """Wrap io.prefetched_chunks: record the start index of every run
    and optionally raise after ``limit`` yielded chunks."""

    def __init__(self, limit=None):
        self.limit = limit
        self.starts = []
        self._orig = _ORIG_PREFETCH

    def __call__(self, files, chunk_size, h, w, start=1, **kw):
        self.starts.append(start)
        inner = self._orig(files, chunk_size, h, w, start=start, **kw)

        def gen():
            for i, chunk in enumerate(inner):
                if self.limit is not None and i >= self.limit:
                    raise RuntimeError("simulated crash")
                yield chunk
            if self.limit is not None:
                raise RuntimeError("simulated crash")

        return gen()


def test_burst_key_sensitivity(tmp_path):
    from libstacker_tpu_torch.utils.checkpoint import burst_key

    p = _ecc_params()
    base = burst_key(["a.png", "b.png"], p, None, 2, extra="ecc")
    assert base == burst_key(["a.png", "b.png"], p, None, 2, extra="ecc")
    assert base != burst_key(["a.png", "c.png"], p, None, 2, extra="ecc")
    assert base != burst_key(["a.png", "b.png"], p, 400.0, 2, extra="ecc")
    assert base != burst_key(["a.png", "b.png"], p, None, 4, extra="ecc")
    assert base != burst_key(["a.png", "b.png"], p, None, 2, extra="kp|0")
    m = np.zeros((4, 4), np.uint8)
    with_mask = burst_key(["a.png", "b.png"], p, None, 2, extra="ecc",
                          mask=m)
    assert base != with_mask
    m2 = m.copy()
    m2[0, 0] = 1
    assert with_mask != burst_key(["a.png", "b.png"], p, None, 2,
                                  extra="ecc", mask=m2)


def _ecc_params():
    return EccMatchParameters(
        motion_type=MotionType.Translation, max_count=40, epsilon=1e-4
    )


def test_ecc_stream_checkpoint_resume(burst_dir, tmp_path, monkeypatch):
    files = io_mod.collect_image_files(burst_dir)
    p = _ecc_params()
    ref = ecc_match_stream(files, p, chunk_size=2)

    ck = tmp_path / "ecc_ck.npz"
    crash = _Interrupter(limit=2)
    monkeypatch.setattr(io_mod, "prefetched_chunks", crash)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ecc_match_stream(
            files, p, chunk_size=2,
            checkpoint_path=ck, checkpoint_every=1,
        )
    assert ck.exists()

    resume = _Interrupter(limit=None)
    monkeypatch.setattr(io_mod, "prefetched_chunks", resume)
    out, stats = ecc_match_stream(
        files, p, chunk_size=2, checkpoint_path=ck, checkpoint_every=1,
        return_stats=True,
    )
    # the resumed run skipped the checkpointed chunk (start = 1 + 1*2)
    assert resume.starts == [3]
    np.testing.assert_array_equal(out, ref)
    assert not ck.exists()  # removed on success
    # stats cover EVERY frame, including the pre-crash checkpointed
    # chunk (iters/rho ride the checkpoint)
    assert stats.frames_total == 6
    assert len(stats.ecc_iterations) == 5
    assert len(stats.ecc_rho) == 5
    assert stats.frames_kept == 6 and stats.frames_dropped == 0


def test_ecc_stream_checkpoint_key_mismatch_restarts(
    burst_dir, tmp_path, monkeypatch
):
    files = io_mod.collect_image_files(burst_dir)
    ck = tmp_path / "ecc_ck.npz"
    crash = _Interrupter(limit=2)
    monkeypatch.setattr(io_mod, "prefetched_chunks", crash)
    with pytest.raises(RuntimeError):
        ecc_match_stream(
            files, _ecc_params(), chunk_size=2,
            checkpoint_path=ck, checkpoint_every=1,
        )
    assert ck.exists()

    # different parameters -> different burst key -> clean restart
    p2 = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=40, epsilon=1e-3
    )
    fresh = _Interrupter(limit=None)
    monkeypatch.setattr(io_mod, "prefetched_chunks", fresh)
    out = ecc_match_stream(
        files, p2, chunk_size=2, checkpoint_path=ck, checkpoint_every=1
    )
    assert fresh.starts == [1]  # checkpoint ignored
    ref = ecc_match_stream(files, p2, chunk_size=2)
    np.testing.assert_array_equal(out, ref)


def test_ecc_stream_corrupt_checkpoint_ignored(
    burst_dir, tmp_path, monkeypatch
):
    files = io_mod.collect_image_files(burst_dir)
    ck = tmp_path / "ecc_ck.npz"
    ck.write_bytes(b"not an npz at all")
    fresh = _Interrupter(limit=None)
    monkeypatch.setattr(io_mod, "prefetched_chunks", fresh)
    out = ecc_match_stream(
        files, _ecc_params(), chunk_size=2,
        checkpoint_path=ck, checkpoint_every=1,
    )
    assert fresh.starts == [1]
    ref = ecc_match_stream(files, _ecc_params(), chunk_size=2)
    np.testing.assert_array_equal(out, ref)


class _CallCrasher:
    """Wrap io.prefetched_chunks: crash during invocation number
    ``crash_call`` (0-based across the run — the sigma-clip streams
    call it once for the align pass and once per moment sweep) after
    ``limit`` yielded chunks; record every call's start index."""

    def __init__(self, crash_call=None, limit=0):
        self.crash_call = crash_call
        self.limit = limit
        self.calls = 0
        self.starts = []
        self._orig = _ORIG_PREFETCH

    def __call__(self, files, chunk_size, h, w, start=1, **kw):
        idx = self.calls
        self.calls += 1
        self.starts.append(start)
        inner = self._orig(files, chunk_size, h, w, start=start, **kw)
        crash = self.crash_call is not None and idx == self.crash_call

        def gen():
            for i, chunk in enumerate(inner):
                if crash and i >= self.limit:
                    raise RuntimeError("simulated crash")
                yield chunk
            if crash:
                raise RuntimeError("simulated crash")

        return gen()


@pytest.fixture(scope="module")
def sigma_burst_dir(tmp_path_factory):
    """9 frames (8 aligned lanes + ref) so the kappa=2.0 clip can act."""
    rng = np.random.default_rng(35)
    h, w = 96, 128
    small = rng.integers(0, 256, (h // 8, w // 8), np.uint8)
    tex = small.repeat(8, 0).repeat(8, 1)
    d = tmp_path_factory.mktemp("sigma_burst")
    for i in range(9):
        f = np.roll(tex, i % 3, axis=1).copy()
        if i == 5:  # single-frame streak for the clip to reject
            f[40:43, 10:100] = 255
        Image.fromarray(np.stack([f] * 3, -1)).save(d / f"f{i}.png")
    return d


def _sigma_params():
    return EccMatchParameters(
        motion_type=MotionType.Translation, max_count=40, epsilon=1e-4,
        stacking="sigma_clip", sigma_kappa=2.0, sigma_iters=2,
    )


def test_ecc_sigma_stream_resumes_mid_sweep(
    sigma_burst_dir, tmp_path, monkeypatch
):
    """Kill-and-resume INSIDE the sigma-clip moment sweeps (r4 VERDICT
    item 9): the phase=1 checkpoint carries the pass index, chunk
    cursor, partial accumulators and the pass's entry state, so the
    resumed run re-decodes only the remaining sweep chunks and is
    bit-identical to an uninterrupted run."""
    files = io_mod.collect_image_files(sigma_burst_dir)
    p = _sigma_params()
    ref, ref_stats = ecc_match_stream(
        files, p, chunk_size=2, return_stats=True
    )
    assert ref_stats.clipped_sample_frac > 0  # the streak was rejected

    ck = tmp_path / "sigma_ck.npz"
    # call 0 = align pass, 1 = initial moments sweep, 2 = clip pass 1:
    # crash after 2 chunks of clip pass 1
    crash = _CallCrasher(crash_call=2, limit=2)
    monkeypatch.setattr(io_mod, "prefetched_chunks", crash)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ecc_match_stream(
            files, p, chunk_size=2,
            checkpoint_path=ck, checkpoint_every=1,
        )
    assert ck.exists()

    resume = _CallCrasher()
    monkeypatch.setattr(io_mod, "prefetched_chunks", resume)
    out, stats = ecc_match_stream(
        files, p, chunk_size=2, checkpoint_path=ck, checkpoint_every=1,
        return_stats=True,
    )
    # align pass skipped entirely; clip pass 1 resumed at chunk 2
    # (frame index 4), clip pass 2 ran from the top
    assert resume.starts == [4, 0], resume.starts
    np.testing.assert_array_equal(out, ref)
    assert not ck.exists()
    assert stats.frames_total == 9
    assert len(stats.ecc_rho) == 8  # align products rode the checkpoint
    assert stats.clipped_sample_frac == ref_stats.clipped_sample_frac


def test_ecc_sigma_stream_resumes_mid_align(
    sigma_burst_dir, tmp_path, monkeypatch
):
    """Kill-and-resume during the sigma stream's ALIGN pass: the
    phase=0 checkpoint carries the solved warps, so the resumed run
    re-solves only the remaining chunks."""
    files = io_mod.collect_image_files(sigma_burst_dir)
    p = _sigma_params()
    ref = ecc_match_stream(files, p, chunk_size=2)

    ck = tmp_path / "sigma_ck.npz"
    crash = _CallCrasher(crash_call=0, limit=2)
    monkeypatch.setattr(io_mod, "prefetched_chunks", crash)
    with pytest.raises(RuntimeError, match="simulated crash"):
        ecc_match_stream(
            files, p, chunk_size=2,
            checkpoint_path=ck, checkpoint_every=1,
        )
    assert ck.exists()

    resume = _CallCrasher()
    monkeypatch.setattr(io_mod, "prefetched_chunks", resume)
    out = ecc_match_stream(
        files, p, chunk_size=2, checkpoint_path=ck, checkpoint_every=1,
    )
    # align resumed after the 1 checkpointed chunk (the crash fired in
    # the prefetch-ahead of chunk 3, before chunk 2's save), then the
    # three full sweeps
    assert resume.starts == [3, 0, 0, 0], resume.starts
    np.testing.assert_array_equal(out, ref)
    assert not ck.exists()


def test_keypoint_sigma_stream_resumes_mid_sweep(
    sigma_burst_dir, tmp_path, monkeypatch
):
    """Keypoint-path counterpart of the mid-sweep resume."""
    files = io_mod.collect_image_files(sigma_burst_dir)
    p = KeyPointMatchParameters(
        stacking="sigma_clip", sigma_kappa=2.0, sigma_iters=1
    )
    d_ref, ref = keypoint_match_stream(files, p, chunk_size=2, seed=5)

    ck = tmp_path / "kp_sigma_ck.npz"
    crash = _CallCrasher(crash_call=1, limit=2)  # initial moments sweep
    monkeypatch.setattr(io_mod, "prefetched_chunks", crash)
    with pytest.raises(RuntimeError, match="simulated crash"):
        keypoint_match_stream(
            files, p, chunk_size=2, seed=5,
            checkpoint_path=ck, checkpoint_every=1,
        )
    assert ck.exists()

    resume = _CallCrasher()
    monkeypatch.setattr(io_mod, "prefetched_chunks", resume)
    d_out, out = keypoint_match_stream(
        files, p, chunk_size=2, seed=5,
        checkpoint_path=ck, checkpoint_every=1,
    )
    # align skipped; initial sweep resumed at chunk 2, clip pass full
    assert resume.starts == [4, 0], resume.starts
    assert d_out == d_ref
    np.testing.assert_array_equal(out, ref)
    assert not ck.exists()


def test_keypoint_stream_checkpoint_resume(burst_dir, tmp_path, monkeypatch):
    files = io_mod.collect_image_files(burst_dir)
    p = KeyPointMatchParameters()
    d_ref, ref = keypoint_match_stream(files, p, chunk_size=2, seed=7)

    ck = tmp_path / "kp_ck.npz"
    crash = _Interrupter(limit=2)
    monkeypatch.setattr(io_mod, "prefetched_chunks", crash)
    with pytest.raises(RuntimeError, match="simulated crash"):
        keypoint_match_stream(
            files, p, chunk_size=2, seed=7,
            checkpoint_path=ck, checkpoint_every=1,
        )
    assert ck.exists()

    resume = _Interrupter(limit=None)
    monkeypatch.setattr(io_mod, "prefetched_chunks", resume)
    d_out, out, stats = keypoint_match_stream(
        files, p, chunk_size=2, seed=7,
        checkpoint_path=ck, checkpoint_every=1, return_stats=True,
    )
    assert resume.starts == [3]
    # per-chunk generators make the resumed run draw the same RANSAC
    # hypotheses: bit-identical result
    assert d_out == d_ref
    np.testing.assert_array_equal(out, ref)
    assert not ck.exists()
    # match/inlier stats cover every frame via the checkpoint
    assert stats.frames_total == 6
    assert len(stats.match_counts) == 5
    assert len(stats.inlier_counts) == 5
    assert all(c > 0 for c in stats.inlier_counts)


def test_checkpoint_module_matches_jax(tmp_path):
    """The port's copy keys and stores runs as the JAX package's does."""
    pytest.importorskip("jax")
    from libstacker_tpu.utils import checkpoint as jck
    from libstacker_tpu_torch.utils import checkpoint as pck

    m = np.arange(12, dtype=np.uint8).reshape(3, 4)
    for args in ((["a.png", "b.png"], "params", None, 2),
                 (["x.png"], "other", 400.0, 16)):
        assert pck.burst_key(*args, extra="ecc", mask=m) == jck.burst_key(
            *args, extra="ecc", mask=m)
    ck = pck.StreamCheckpoint(tmp_path / "c.npz", "k1")
    assert ck.load() == (0, None)
    ck.save(3, acc=np.ones((2, 2), np.float32))
    done, state = jck.StreamCheckpoint(tmp_path / "c.npz", "k1").load()
    assert done == 3 and state["acc"].sum() == 4.0
    assert pck.StreamCheckpoint(tmp_path / "c.npz", "k2").load() == (0, None)
    ck.remove()
    ck.remove()  # a second remove is a no-op
    assert ck.load() == (0, None)
