"""A cell defined only by new data files (a configuration and a traffic
mix) is found by name and runs through its driver, window, per-layer
readers and check, on the CPU at a tiny size."""

import pytest

from stackbench.tests import _tiny


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
@pytest.mark.parametrize("traced", [False, True])
def test_cell_from_data_files(tmp_path, cell, traced):
    b = _tiny.bench(tmp_path)
    res = _tiny.run(b, tmp_path, cell, traced=traced)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    config, traffic, _ = _tiny.CELLS[cell]
    want = _tiny.LIMITS[traffic][config]
    assert set(res["checks"]) == set(want)
    if traced:
        names = {m["name"] for m in b["per_layer"]
                 if cell in m.get("workloads", [])}
        # no card: the device readers find nothing and are left out
        assert set(res["metrics"]) <= names
        assert "stage_ms.stack" in res["metrics"]
        assert "busy_s" in res["device"] and "breakdown" in res
    else:
        assert set(res["metrics"]) == {
            "frames_per_s", "burst_p95_ms", "work_mem_gib", "setup_s"}
        assert all(v["value"] > 0 for k, v in res["metrics"].items()
                   if k != "work_mem_gib")


def test_unknown_cell_is_refused(tmp_path):
    from stackbench import harness

    with pytest.raises(KeyError):
        harness.Cell(_tiny.bench(tmp_path), "no_such_cell", base=tmp_path)
