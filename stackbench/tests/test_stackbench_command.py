"""The command without a card exits non-zero and prints no result; on
a card (marked ``cuda``) a short run of each cell prints the result
object last."""

import json
import subprocess
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(cell, seconds="1", trace="0"):
    return subprocess.run(
        BENCH["command"] + ["--workload", cell, "--seed", "2200000999",
                            "--seconds", seconds, "--trace", trace],
        cwd=ROOT, capture_output=True, text=True, timeout=900)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    out = _run(BENCH["workloads"][0]["name"])
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_short_run_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(cell, seconds="3")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu"
