"""The check's control and faults, at a tiny size on the CPU: the plain
reference computed in bfloat16 put in the program's place fails the
check, and a run whose timed path is broken underneath (half of each
burst left out; a frame's warp moved 4 px where the alignment produces
it; the stacked image altered where it is produced; on the keypoint
path, RANSAC without its refit on the inliers) comes out not correct.
A sound run comes out correct."""

import json

import pytest

from stackbench import check, compare, harness
from stackbench.tests import _tiny


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_control_fails(tmp_path, cell):
    b = _tiny.bench(tmp_path)
    c = harness.Cell(b, cell, base=tmp_path)
    nums = check.control(c, 2**32 + 9, "cpu")
    ok, checks = compare.verdict(nums, c.limits)
    assert not ok, checks


@pytest.mark.parametrize("fault", sorted(check.FAULTS))
@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_fault_is_not_correct(tmp_path, cell, fault):
    b = _tiny.bench(tmp_path)
    res = _tiny.run(b, tmp_path, cell, seed=2**32 + 11,
                    hook=check.FAULTS[fault])
    assert not res["correct"], res["checks"]


def _entry_faults():
    """(cell, fault) for each fault of a tiny cell's own entry point."""
    for cell, (config, _, _) in sorted(_tiny.CELLS.items()):
        src = _tiny.CONFIGS[config][0]
        cfg = json.loads((_tiny.ROOT / f"stackbench/configs/{src}.json")
                         .read_text())
        for fault in sorted(check.ENTRY_FAULTS.get(cfg["entry"], {})):
            yield cell, fault


@pytest.mark.parametrize("cell, fault", list(_entry_faults()))
def test_entry_fault_is_not_correct(tmp_path, cell, fault):
    b = _tiny.bench(tmp_path)
    res = _tiny.run(b, tmp_path, cell, seed=2**32 + 11,
                    hook=check.ALL_FAULTS[fault])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(_tiny.CELLS))
def test_sound_run_after_faults(tmp_path, cell):
    """The faults leave nothing behind in the port's modules."""
    b = _tiny.bench(tmp_path)
    for fault in ("warp", *check.ENTRY_FAULTS.get(
            harness.Cell(b, cell, base=tmp_path).config["entry"], {})):
        _tiny.run(b, tmp_path, cell, hook=check.ALL_FAULTS[fault])
    assert _tiny.run(b, tmp_path, cell)["correct"]
