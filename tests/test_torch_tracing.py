"""``utils/tracing.PhaseTimer``, the port's span recorder: phases and
the spans nested in them, in start order with their parents; the
phases' ``phase_ms`` as before; ``stage:`` profiler ranges for every
span and none without stats; the ECC solve's spans on a tiny CPU burst
(``ecc.prep``, ``ecc.sweep``, ``ecc.check``); and the keypoint path's
(an ``orb.level`` a pyramid level with its ``orb.topk``, ``kp.match``,
``ransac.loop`` / ``ransac.check`` a slab, ``ransac.refit``)
with the ``ransac_slabs`` count, and none of them without stats."""

import pytest

torch = pytest.importorskip("torch")

import libstacker_tpu_torch as P  # noqa: E402
from _torch_parity import burst  # noqa: E402
from libstacker_tpu_torch.ops import ecc as ecc_ops  # noqa: E402
from libstacker_tpu_torch.ops import ransac  # noqa: E402
from libstacker_tpu_torch.utils import tracing  # noqa: E402

torch.set_num_threads(2)

SOLVE = "ecc full-res solve"


def _params(**kw):
    base = dict(motion_type=P.MotionType.Homography, max_count=12,
                epsilon=1e-4, gauss_filt_size=5)
    base.update(kw)
    return P.EccMatchParameters(**base)


@pytest.fixture(scope="module")
def frames():
    return burst(19, 4, 96, 128, max_shift=3.0, max_angle=0.3)[0]


@pytest.fixture(scope="module")
def ecc_stats(frames):
    return P.ecc_match_arrays(frames, _params(), return_stats=True,
                              device="cpu")[1]


def _program_ranges(prof):
    """Names of the user ranges a profile holds (``record_function``)."""
    return [ev.name for ev in prof.events() if ev.is_user_annotation]


def test_spans_nest_in_start_order():
    t = tracing.PhaseTimer()
    with t.phase("a"):
        with t.span("a.1"):
            with t.span("a.1.x"):
                pass
        with t.span("a.2"):
            pass
    with t.phase("b"):
        pass
    with t.span("loose"):
        pass
    got = [(name, parent) for name, parent, _, _ in t.spans()]
    assert got == [("a", None), ("a.1", "a"), ("a.1.x", "a.1"),
                   ("a.2", "a"), ("b", None), ("loose", None)]
    host = {name: ms for name, _, ms, _ in t.spans()}
    assert host["a"] >= host["a.1"] >= host["a.1.x"] >= 0.0


def test_phase_ms_keys_unchanged_by_spans():
    t = tracing.PhaseTimer()
    for _ in range(2):
        with t.phase("grey"):
            with t.span("inner"):
                pass
    with t.phase("stack"):
        pass
    assert list(t.ms()) == ["grey", "stack"]
    greys = [ms for name, _, ms, _ in t.spans() if name == "grey"]
    assert t.ms()["grey"] == pytest.approx(sum(greys))
    assert "inner" not in t.report()


def test_cpu_span_has_no_device_time():
    t = tracing.PhaseTimer(torch.device("cpu"))
    with t.phase("p"):
        with t.span("s"):
            torch.ones(8).sum()
    assert [dev for _, _, _, dev in t.spans()] == [None, None]


def test_stats_ranges_all_start_with_stage(frames):
    """Every range the program opens carries the ``stage:`` prefix that
    the benchmark's trace reader leaves out of the device time."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _, st = P.ecc_match_arrays(frames, _params(), return_stats=True,
                                   device="cpu")
    names = _program_ranges(prof)
    assert names and all(name.startswith("stage:") for name in names)
    assert sorted(names) == sorted(f"stage:{name}"
                                   for name, _, _, _ in st.spans)
    assert {"stage:ecc.prep", "stage:ecc.sweep", "stage:ecc.check",
            f"stage:{SOLVE}"} <= set(names)


def test_no_stats_no_ranges(frames):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        P.ecc_match_arrays(frames, _params(), device="cpu")
    assert _program_ranges(prof) == []


def test_ecc_solve_spans_count_sweeps_and_checks(ecc_stats):
    st = ecc_stats
    kids = [s for s in st.spans if s[1] == SOLVE]
    sweeps = sum(name == "ecc.sweep" for name, _, _, _ in kids)
    checks = sum(name == "ecc.check" for name, _, _, _ in kids)
    assert [name for name, _, _, _ in kids][:2] == ["ecc.prep", "ecc.check"]
    assert sum(name == "ecc.prep" for name, _, _, _ in kids) == 1
    assert sweeps > 0 and sweeps % ecc_ops._CHUNK_ITERS == 0
    assert checks == sweeps // ecc_ops._CHUNK_ITERS + 1
    lanes = len(st.ecc_iterations)
    assert lanes == 3
    assert sum(st.ecc_iterations) <= sweeps * lanes
    assert max(st.ecc_iterations) > sweeps - ecc_ops._CHUNK_ITERS
    # the phases keep their keys; the solve's spans sit inside its phase
    assert set(st.phase_ms) == {"grey", "phase init", SOLVE, "stack"}
    assert sum(ms for _, _, ms, _ in kids) <= st.phase_ms[SOLVE]
    assert all(dev is None for _, _, _, dev in st.spans)


def test_rescue_spans_nest_the_forward_resolve(frames, monkeypatch):
    """A 'lazy' solve whose lanes all fail is re-solved forward under
    ``ecc.rescue``, with its own checks and sweeps."""
    real = ecc_ops._iterate

    def failing(srcs, texels, templates_f, st, active, motion_type, mode,
                eps, with_gram):
        out = real(srcs, texels, templates_f, st, active, motion_type, mode,
                   eps, with_gram)
        if mode == "lazy":
            out = out._replace(ok=out.ok & ~active)
        return out

    monkeypatch.setattr(ecc_ops, "_iterate", failing)
    _, st = P.ecc_match_arrays(frames, _params(solver="lazy"),
                               return_stats=True, device="cpu")
    names = [(name, parent) for name, parent, _, _ in st.spans]
    assert ("ecc.rescue", SOLVE) in names
    inner = [name for name, parent in names if parent == "ecc.rescue"]
    assert inner[0] == "ecc.check" and "ecc.sweep" in inner
    assert inner.count("ecc.check") == (
        inner.count("ecc.sweep") // ecc_ops._CHUNK_ITERS + 1)


@pytest.fixture(scope="module")
def kp_frames():
    from libstacker_tpu_torch.utils.synth import make_textured_burst

    return make_textured_burst(4, 288, 512, seed=1)[0].numpy()


def _kp_stats(kp_frames, monkeypatch):
    """A keypoint call with stats, and the slabs its loop drew."""
    drawn = []
    real = ransac._hypotheses

    def counted(p, generator, n_hyp):
        drawn.append(n_hyp)
        return real(p, generator, n_hyp)

    monkeypatch.setattr(ransac, "_hypotheses", counted)
    _, _, st = P.keypoint_match_arrays(kp_frames, return_stats=True,
                                       device="cpu")
    return st, drawn


def test_keypoint_spans_and_slab_count(kp_frames, monkeypatch):
    st, drawn = _kp_stats(kp_frames, monkeypatch)
    names = [(name, parent) for name, parent, _, _ in st.spans]
    assert [n for n, parent in names if parent is None] == [
        "grey", "detect", "match+ransac", "stack"]
    levels = [i for i, (n, _) in enumerate(names) if n == "orb.level"]
    assert len(levels) == 8  # every level of the 288x512 pyramid runs
    assert all(names[i][1] == "detect" for i in levels)
    # one orb.topk inside each level, right after its start
    tops = [i for i, (n, _) in enumerate(names) if n == "orb.topk"]
    assert len(tops) == 8
    assert all(names[i][1] == "orb.level" for i in tops)
    assert all(lvl < top for lvl, top in zip(levels, tops))
    kids = [n for n, parent in names if parent == "match+ransac"]
    slabs = kids.count("ransac.loop")
    assert kids == (["kp.match"] + ["ransac.loop", "ransac.check"] * slabs
                    + ["ransac.refit"])
    # the counter is the loop's slabs, each one _SLAB draws and one read
    assert st.ransac_slabs == len(drawn) == slabs >= 1
    assert set(drawn) == {ransac._SLAB}
    assert set(st.phase_ms) == {"grey", "detect", "match+ransac", "stack"}
    assert all(dev is None for _, _, _, dev in st.spans)


def test_keypoint_nothing_recorded_without_stats(kp_frames, monkeypatch):
    """No span, no range and no count without ``return_stats``; with
    it, every range the keypoint path opens is one of its spans."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = P.keypoint_match_arrays(kp_frames, device="cpu")
    assert len(out) == 2 and _program_ranges(prof) == []
    with torch.profiler.profile(activities=acts) as prof:
        st, _ = _kp_stats(kp_frames, monkeypatch)
    assert sorted(_program_ranges(prof)) == sorted(
        f"stage:{name}" for name, _, _, _ in st.spans)
