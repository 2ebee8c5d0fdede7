"""The keypoint path's readers: ``orb_topk_ms``, ``ransac_loop_ms``,
``ransac_refit_ms`` (device ms a call), ``ransac_check_ms`` (host ms a
call), ``ransac_slabs`` (the counter) and the refit kernels' shares of
their rooflines.  On synthetic traced windows: each call's sum, the mean
over calls, None where nothing is recorded.  On the tiny cells: a number
from every reader on the keypoint cell (on the CPU the host readers; on
a card, marked ``cuda``, every one) and None from every one on the ECC
cells."""

import time
from types import SimpleNamespace

import pytest
import torch

from stackbench import harness
from stackbench.roofline import ransac_refit
from stackbench.tests import _tiny

SPANS = ("orb_topk_ms", "ransac_loop_ms", "ransac_refit_ms",
         "ransac_check_ms")
DEVICE = ("orb_topk_ms", "ransac_loop_ms", "ransac_refit_ms")
ROOFLINES = ("ransac_dlt_roofline", "ransac_refine_roofline")
NEW = SPANS + ("ransac_slabs",) + ROOFLINES
CELL = "orb4k_mean_b20"


def _read(name, ctx):
    return harness.load_file(harness.HERE / "metrics" / f"{name}.py").read(ctx)


def _call(topk=(2.0, 30.0), chunks=1, loop=(0.5, 0.4), check=1.5,
          refit=(0.3, 0.2), slabs=1, device=True):
    """One call's stats: 8 levels, ``chunks`` loop / check pairs; (host,
    device) ms."""
    dev = (lambda ms: ms) if device else (lambda ms: None)
    spans = [("grey", None, 6.0, dev(5.0)), ("detect", None, 60.0, dev(58.0))]
    for _ in range(8):
        spans += [("orb.level", "detect", 5.0, dev(6.0)),
                  ("orb.topk", "orb.level", topk[0], dev(topk[1]))]
    spans += [("match+ransac", None, 9.0, dev(4.0)),
              ("kp.match", "match+ransac", 1.0, dev(0.8))]
    for _ in range(chunks):
        spans += [("ransac.loop", "match+ransac", loop[0], dev(loop[1])),
                  ("ransac.check", "match+ransac", check, dev(0.01))]
    spans += [("ransac.refit", "match+ransac", refit[0], dev(refit[1])),
              ("stack", None, 2.0, dev(1.5))]
    stats = SimpleNamespace(spans=spans, ransac_slabs=slabs)
    return {"b": 0, "stats": stats, "frames": 20, "stacked": 20}


def _ctx(*calls, events=(), profiled=0):
    return SimpleNamespace(calls=list(calls), events=list(events),
                           profiled_calls=profiled)


def test_readers_on_two_calls():
    a = _call(topk=(2.0, 30.0), chunks=1, loop=(0.5, 0.4), check=1.5,
              refit=(0.3, 0.2), slabs=1)
    b = _call(topk=(1.0, 34.0), chunks=2, loop=(0.7, 0.6), check=2.5,
              refit=(0.5, 0.4), slabs=3)
    ctx = _ctx(a, b)
    # eight levels' top-k a call: (8 x 30 + 8 x 34) / 2
    assert _read("orb_topk_ms", ctx) == pytest.approx(256.0)
    # one chunk, then two: (0.4 + 1.2) / 2
    assert _read("ransac_loop_ms", ctx) == pytest.approx(0.8)
    assert _read("ransac_refit_ms", ctx) == pytest.approx(0.3)
    # host ms of the reads: (1.5 + 2 x 2.5) / 2
    assert _read("ransac_check_ms", ctx) == pytest.approx(3.25)
    assert _read("ransac_slabs", ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("name", SPANS + ("ransac_slabs",))
def test_none_without_spans(name):
    parent = SimpleNamespace(phase_ms={"detect": 58.0})  # no spans field
    no_spans = SimpleNamespace(spans=None, ransac_slabs=None)
    ecc = SimpleNamespace(spans=[("ecc.sweep", "ecc full-res solve", 1.0,
                                  2.0)], ransac_slabs=None)
    calls = [{"b": 0, "stats": st, "frames": 3, "stacked": 3}
             for st in (None, parent, no_spans, ecc)]
    assert _read(name, _ctx(*calls)) is None


@pytest.mark.parametrize("name", DEVICE)
def test_device_readers_none_off_cuda(name):
    assert _read(name, _ctx(_call(device=False))) is None


def test_host_readers_read_off_cuda():
    ctx = _ctx(_call(device=False))
    assert _read("ransac_check_ms", ctx) == pytest.approx(1.5)
    assert _read("ransac_slabs", ctx) == pytest.approx(1.0)


def test_rooflines_from_kernel_time():
    """Bound over device time by name, over the profiled calls."""
    dlt_s = ransac_refit.dlt_bound_s(20)
    ref_s = ransac_refit.refine_bound_s(20)
    events = [("void (anonymous namespace)::ransac_dlt_kernel(float const*)",
               0.0, 1e6 * dlt_s * 50), ("elementwise", 0.0, 9e9),
              ("void (anonymous namespace)::ransac_refine_kernel(float)",
               0.0, 1e6 * ref_s * 100)]
    ctx = _ctx(_call(), _call(), events=events, profiled=2)
    assert _read("ransac_dlt_roofline", ctx) == pytest.approx(4.0)
    assert _read("ransac_refine_roofline", ctx) == pytest.approx(2.0)
    assert _read("ransac_dlt_roofline", _ctx(_call(), profiled=1)) is None
    # the polish does ten steps of the DLT's slots: its bound is the
    # operations', not the bytes'
    assert ref_s > 10 * dlt_s


def _bench_with_new_readers(tmp_path):
    """The tiny cells, the new readers asked of all three."""
    b = _tiny.bench(tmp_path)
    for m in b["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"] = m["workloads"] + sorted(_tiny.CELLS)
    return b


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_tiny_cells(tmp_path, cell):
    b = _bench_with_new_readers(tmp_path)
    res = _tiny.run(b, tmp_path, cell, traced=True)
    assert res["correct"], res["checks"]
    got = set(res["metrics"]) & set(NEW)
    if cell == "tiny_kp":
        # no card: the device readers find nothing and are left out
        assert got == {"ransac_check_ms", "ransac_slabs"}
        assert res["metrics"]["ransac_slabs"]["value"] >= 1
        assert {"stage_ms.detect", "stage_ms.match_ransac"} <= set(
            res["metrics"])
    else:
        assert got == set()


@pytest.mark.cuda
def test_tiny_keypoint_cell_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b = _bench_with_new_readers(tmp_path)
    res = harness.run(harness.Cell(b, "tiny_kp", base=tmp_path), 2**33 + 5,
                      0.5, True, "cuda", time.time())
    assert res["correct"], res["checks"]
    assert set(NEW) <= set(res["metrics"])
    assert all(res["metrics"][n]["value"] > 0 for n in NEW)
