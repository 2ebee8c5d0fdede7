"""The ECC solve's span readers (``ecc_sweeps``, ``ecc_lane_util_pct``,
``ecc_prep_ms``, ``ecc_sweep_ms``, ``ecc_sweep_host_ms``,
``ecc_check_ms``) on synthetic traced windows: the mean over calls of
each call's reading or over every sweep, only the spans under ``ecc
full-res solve``, and None where no call recorded spans."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from stackbench import harness

METRICS = Path(harness.__file__).resolve().parent / "metrics"
NAMES = ("ecc_sweeps", "ecc_lane_util_pct", "ecc_prep_ms", "ecc_sweep_ms",
         "ecc_sweep_host_ms", "ecc_check_ms")
SOLVE = "ecc full-res solve"


def _read(name, ctx):
    return harness.load_file(METRICS / f"{name}.py").read(ctx)


def _call(iters, sweeps, prep=(1.0, 20.0), sweep=(0.5, 3.0), check=2.0,
          device=True):
    """The stats of one call: ``sweeps`` sweeps in chunks of 4, a check
    before each chunk and one after the last; (host, device) ms."""
    dev = (lambda ms: ms) if device else (lambda ms: None)
    spans = [("grey", None, 9.0, dev(8.0)), (SOLVE, None, 100.0, dev(90.0)),
             ("ecc.prep", SOLVE, prep[0], dev(prep[1]))]
    for k in range(sweeps):
        if k % 4 == 0:
            spans.append(("ecc.check", SOLVE, check, dev(0.01)))
        spans.append(("ecc.sweep", SOLVE, sweep[0], dev(sweep[1])))
    spans.append(("ecc.check", SOLVE, check, dev(0.01)))
    # an octave's spans are not the full-resolution solve's
    spans += [("ecc.sweep", "ecc octave solve", 50.0, dev(50.0)),
              ("stack", None, 5.0, dev(4.0))]
    stats = SimpleNamespace(ecc_iterations=list(iters), spans=spans)
    return {"b": 0, "stats": stats, "frames": len(iters) + 1,
            "stacked": len(iters) + 1}


def _ctx(*calls):
    return SimpleNamespace(calls=list(calls))


def test_readers_on_two_calls():
    a = _call([4, 4, 3, 5], 8, prep=(1.0, 20.0), sweep=(0.5, 3.0), check=2.0)
    b = _call([2, 2, 2, 2], 4, prep=(3.0, 30.0), sweep=(1.5, 5.0), check=4.0)
    ctx = _ctx(a, b)
    assert _read("ecc_sweeps", ctx) == pytest.approx(6.0)
    # 16 of 32 lane-sweeps, then 8 of 16
    assert _read("ecc_lane_util_pct", ctx) == pytest.approx(50.0)
    assert _read("ecc_prep_ms", ctx) == pytest.approx(25.0)
    # pooled over the 12 sweeps: (8 x 3 + 4 x 5) / 12, (8 x 0.5 + 4 x 1.5) / 12
    assert _read("ecc_sweep_ms", ctx) == pytest.approx(44.0 / 12)
    assert _read("ecc_sweep_host_ms", ctx) == pytest.approx(10.0 / 12)
    # 3 checks of 2 ms, then 2 of 4 ms
    assert _read("ecc_check_ms", ctx) == pytest.approx(7.0)
    # prep + sweeps x sweep is the mean device time of a call's prep and
    # sweeps: (20 + 24 + 30 + 20) / 2
    assert (_read("ecc_prep_ms", ctx) + _read("ecc_sweeps", ctx)
            * _read("ecc_sweep_ms", ctx)) == pytest.approx(47.0)


def test_lane_use_times_sweeps_is_the_mean_iterations():
    iters = [3, 6, 4, 5, 4]
    call = _call(iters, 8)
    util = _read("ecc_lane_util_pct", _ctx(call))
    sweeps = _read("ecc_sweeps", _ctx(call))
    assert util * sweeps / 100.0 == pytest.approx(sum(iters) / len(iters))


@pytest.mark.parametrize("name", NAMES)
def test_none_without_spans(name):
    parent = SimpleNamespace(ecc_iterations=[4, 4], phase_ms={SOLVE: 9.0})
    no_spans = SimpleNamespace(ecc_iterations=[4, 4], spans=None)
    calls = [{"b": 0, "stats": st, "frames": 3, "stacked": 3}
             for st in (None, parent, no_spans)]
    assert _read(name, _ctx()) is None
    assert _read(name, _ctx(*calls)) is None


@pytest.mark.parametrize("name", ["ecc_prep_ms", "ecc_sweep_ms"])
def test_device_readers_none_off_cuda(name):
    assert _read(name, _ctx(_call([4, 4], 4, device=False))) is None


def test_host_readers_read_off_cuda():
    ctx = _ctx(_call([4, 4], 4, device=False))
    assert _read("ecc_sweeps", ctx) == 4
    assert _read("ecc_sweep_host_ms", ctx) == pytest.approx(0.5)
    assert _read("ecc_check_ms", ctx) == pytest.approx(4.0)
