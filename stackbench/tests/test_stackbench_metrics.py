"""The yardstick's arithmetic: the end-to-end metrics over all bursts
and the whole window, the trace's busy union and idle gaps, the
rooflines' counts and the check's comparisons."""

import numpy as np
import pytest
import torch

from stackbench import compare, harness, trace
from stackbench.roofline import fast, peaks, warp_accum


def _metrics(lat, frames_per_burst=100):
    window = float(np.sum(lat))
    return harness.end_to_end(lat, frames_per_burst * len(lat), window,
                              2**30, 1.0)


def test_stall_moves_p95_and_rate():
    steady = [0.15] * 200
    stalled = list(steady)
    for i in range(0, 200, 10):  # one burst in ten stalls by 0.4 s
        stalled[i] += 0.4
    a, b = _metrics(steady), _metrics(stalled)
    assert a["burst_p95_ms"][0] == pytest.approx(150.0)
    assert b["burst_p95_ms"][0] == pytest.approx(550.0)
    assert a["frames_per_s"][0] == pytest.approx(100 / 0.15)
    # the rate is over the whole window, the stalls included
    assert b["frames_per_s"][0] == pytest.approx(
        100 * 200 / (0.15 * 200 + 0.4 * 20))
    assert a["work_mem_gib"] == (1.0, "GiB")


def test_p95_is_over_every_burst():
    lat = [0.1] * 94 + [1.0] * 6  # six slow bursts of 100: p95 in them
    assert _metrics(lat)["burst_p95_ms"][0] > 100.0
    lat = [0.1] * 96 + [1.0] * 4
    assert _metrics(lat)["burst_p95_ms"][0] == pytest.approx(100.0)


def test_busy_union_and_gaps():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0)]
    assert trace.busy_us(ev) == 20.0
    assert trace.idle_gaps(ev, 0.0, 50.0) == [(15.0, 30.0), (35.0, 50.0)]
    clipped = trace.clip(ev, 8.0, 32.0)
    assert trace.busy_us(clipped) == pytest.approx(7.0 + 2.0)
    stages = [("solve", 10.0, 40.0), ("inner", 12.0, 20.0)]
    by = dict(trace.gaps_by_stage([(15.0, 30.0), (35.0, 50.0)], stages))
    assert by == {"inner": 15e-6, "solve": 15e-6}


def test_rooflines_count_from_shapes():
    n, h, w = 100, 2160, 3840
    t, by = warp_accum.bound_s(n, h, w)
    hw = h * w
    nbytes = (n - 1) * hw * 3.0 + hw * 12.0 + n * 40.0
    ops = (n - 1) * hw * warp_accum.OPS_PIXEL_FRAME
    assert t == pytest.approx(max(nbytes / peaks.PEAK_BYTES_S,
                                  ops / peaks.PEAK_OPS_S))
    assert by == "operations"
    levels = fast.level_sizes(h, w)
    assert levels[0] == (h, w) and levels[1] == (1800, 3200)
    assert len(levels) == 8
    t, by = fast.bound_s(20, h, w)
    assert by == "bytes"
    assert t == pytest.approx(20 * sum(a * b for a, b in levels) * 5.0
                              / peaks.PEAK_BYTES_S)


def test_verdict_needs_every_named_number():
    ok, checks = compare.verdict({"a": 0.1, "b": 2.0}, {"a": 0.2})
    assert ok and list(checks) == ["a"]
    assert not compare.verdict({"a": 0.3}, {"a": 0.2})[0]
    assert not compare.verdict({}, {"a": 0.2})[0]
    assert not compare.verdict({"a": float("nan")}, {"a": 0.2})[0]


def test_rank_gap():
    teng = np.array([3.0, 1.0, 2.0, 4.0])
    assert compare.rank_gap([3, 0, 2], teng) == 0.0
    assert compare.rank_gap([0, 3, 2], teng) == pytest.approx(1 / 3)
    assert compare.rank_gap([3, 0, 1], teng) == pytest.approx(1.0)


def test_sharp_rel():
    want = {"teng": np.array([2.0, 4.0])}
    assert compare.sharp_rel({"teng": np.array([2.0, 4.4])}, want) == \
        pytest.approx(0.1)


def test_corner_gap_of_a_shift():
    from stackbench.reference import _plain

    pts = _plain.grid_points(100, 200)
    a = torch.eye(3, dtype=torch.float64)[None]
    b = a.clone()
    b[0, 0, 2] = 0.5
    assert float(_plain.corner_gap(a, b, pts)[0]) == pytest.approx(0.5)
