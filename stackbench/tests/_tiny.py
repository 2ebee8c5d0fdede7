"""Cells defined only by new files, at sizes a CPU test holds: tiny
copies of the benchmark's configurations and traffic, and a reference
module for each configuration, written to a temporary directory and
added to a copy of ``BENCHMARK.json``."""

import json
import time
from pathlib import Path

from stackbench import harness

ROOT = Path(__file__).resolve().parents[2]

CONFIGS = {"ecc_tiny": ("ecc_homography_4k", 144, 256),
           "kp_tiny": ("keypoint_orb_4k", 288, 512)}
# set from six seeds' readings at these sizes (the program's largest;
# the bfloat16 control's and the faults' smallest): stack_gap
# 0.0017-0.0019 against 0.0130-0.0132 (ECC), 0.0024 against 0.0141
# (keypoint); sharp_rel 1.4e-7 against 0.159; warp_px_median
# 0.025-0.042 against 0.088-0.091; warp_px 0.135 (ECC) against the
# 4-px move's 4.0, and 0.79 (keypoint) against the move's 4.07 and
# RANSAC without its refit's 4.31
_ECC = {"warp_px": 1.0, "warp_px_median": 0.06, "kept_mismatch": 0,
        "stack_gap": 0.005}
LIMITS = {  # traffic -> configuration -> limits
    "tiny_burst": {"ecc_tiny": _ECC, "kp_tiny": {
        "warp_px": 3.0, "kept_mismatch": 0, "stack_gap": 0.006}},
    "tiny_ranked": {"ecc_tiny": dict(_ECC, sharp_rel=1e-4, rank_gap=1e-4)},
}
DEPTH = 12
# at these sizes a lane or two of the ECC solve never settles to the
# configuration's epsilon (1e-5) and would run all of its max_count
# (5000) iterations, minutes on a CPU: the tiny copies stop at 50
MAX_COUNT = 50
TRAFFIC = {"tiny_burst": "burst", "tiny_ranked": "ranked"}
# cell -> (config, traffic, the real cell whose per-layer metrics it reads)
CELLS = {"tiny_ecc": ("ecc_tiny", "tiny_burst", "ecc4k_mean_b100"),
         "tiny_kp": ("kp_tiny", "tiny_burst", "ecc4k_mean_b100"),
         "tiny_rank": ("ecc_tiny", "tiny_ranked", "ecc4k_rank_b32")}
# the keypoint layers' per-layer metrics, which no cell of
# ``BENCHMARK.json`` reports yet: name -> (unit, better, source, layer)
KP_METRICS = {
    "stage_ms.detect": ("ms", "lower", "program_span", "ORB"),
    "stage_ms.match_ransac": ("ms", "lower", "program_span",
                              "match and RANSAC"),
    "fast_roofline": ("%", "higher", "device_trace", "kernels"),
}


def bench(tmp: Path) -> dict:
    """A copy of ``BENCHMARK.json`` with the tiny cells, their files
    written under ``tmp``."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "reference"):
        (tmp / sub).mkdir(exist_ok=True)
    for name, (src, h, w) in CONFIGS.items():
        cfg = json.loads((ROOT / f"stackbench/configs/{src}.json").read_text())
        cfg.update(name=name)
        if "max_count" in cfg["params"]:
            cfg["params"]["max_count"] = MAX_COUNT
        (tmp / "reference" / f"{name}.py").write_text(
            f"from stackbench.reference.{src} import align, stack  # noqa\n")
        cfg["frame"].update(height=h, width=w)
        path = tmp / "configs" / f"{name}.json"
        path.write_text(json.dumps(cfg))
        b["configs"].append({"name": name, "source": cfg["source"],
                             "file": str(path), "reduced": [], "why": "tiny"})
    for name, driver in TRAFFIC.items():
        (tmp / "traffic" / f"{name}.json").write_text(json.dumps({
            "why": "tiny", "driver": driver, "depth": DEPTH, "pool": 2,
            "scale_down_width": None, "check_calls": 2, "trace_calls": 2,
            "limits": LIMITS[name]}))
    for name, (cfg, traffic, like) in CELLS.items():
        b["workloads"].append({"name": name, "config": cfg, "traffic": traffic,
                               "chips": 1, "why": "tiny"})
        for m in b["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    for name, (unit, better, source, layer) in KP_METRICS.items():
        b["per_layer"].append({
            "name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": "frames_per_s", "workloads": ["tiny_kp"]})
    return b


def run(b: dict, tmp: Path, cell: str, seed: int = 2**33 + 3,
        seconds: float = 0.5, traced: bool = False, hook=None) -> dict:
    return harness.run(harness.Cell(b, cell, base=tmp), seed, seconds,
                       traced, "cpu", time.time(), hook)
