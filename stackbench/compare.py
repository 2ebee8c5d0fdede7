"""The comparison that decides ``correct``: a run's answers against the
configuration's plain reference, once the window has closed.

Numbers (each held to its limit in the traffic file, under the
configuration's name):

- ``warp_px``: the largest distance, over the frames both sides keep
  and a 9x9 grid of points spread over the frame, between where the
  answer's warp and the reference's send a point (full-resolution px);
- ``warp_px_median``: the median over those frames of each frame's
  largest such distance;
- ``kept_mismatch``: frames kept by one side only, plus any gap between
  the dropped count the entry point reported and its kept flags, plus
  any frame the answer lacks (exact: limit 0);
- ``stack_gap``: the largest absolute gap, over every pixel and
  channel, between a sampled call's stacked image and the reference's
  stack of the same frames by the answer's own warps and kept flags
  (the stage after the alignment, checked by itself);
- with a ranked loop, ``sharp_rel``: the largest relative gap of the
  four sharpness scores of every frame, and ``rank_gap``: how far, as a
  share of the reference's TENG, the answer's order and dropped frame
  go against the reference's scores (0 where they agree).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from stackbench.reference import _plain


def _max(a: float, b: float) -> float:
    if math.isnan(a) or math.isnan(b):
        return math.inf
    return max(a, b)


def judge(answers, ref, traffic: dict, hw) -> dict:
    """Numbers of the answers (``Loop.answer`` dicts) against ``ref``."""
    nums = {"warp_px": 0.0, "kept_mismatch": 0, "stack_gap": 0.0}
    refs, scores, frame_gaps = {}, {}, []
    for a in answers:
        frames = a["frames"]()
        dev = frames.device
        pts = _plain.grid_points(*hw, device=dev)
        if a["key"] not in refs:
            t = time.perf_counter()
            refs[a["key"]] = ref.align(frames, traffic)
            _log(f"reference alignment of {frames.shape[0]} frames: "
                 f"{time.perf_counter() - t:.3f} s")
        rw, rok = refs[a["key"]]
        ok = a["ok"].to(dev)
        warps = a["warps"].to(dev)
        miss = rok.shape[0] - ok.shape[0]
        nums["kept_mismatch"] += abs(miss)
        if miss:  # the answer lacks frames: judge the ones it has
            rw, rok = rw[: ok.shape[0]], rok[: ok.shape[0]]
            frames = frames[: ok.shape[0] + 1]
        nums["kept_mismatch"] += int((ok != rok).sum())
        if a["dropped"] is not None:
            nums["kept_mismatch"] += abs(int(a["dropped"]) - int((~ok).sum()))
        both = ok & rok
        if bool(both.any()):
            gap = _plain.corner_gap(warps[both], rw[both], pts)
            nums["warp_px"] = _max(nums["warp_px"], float(gap.max()))
            frame_gaps.append(gap.cpu())
        if a["out"] is not None:
            t = time.perf_counter()
            rs = ref.stack(frames, warps, ok)
            _log(f"reference stack of {frames.shape[0]} frames: "
                 f"{time.perf_counter() - t:.3f} s")
            gap = (a["out"].to(torch.float32) - rs).abs().max()
            nums["stack_gap"] = _max(nums["stack_gap"], float(gap))
            del rs
        if "scores" in a:
            b = a["burst"]
            if b not in scores:
                full = a["pool_frames"]()
                scores[b] = {k: v.cpu().numpy() for k, v in
                             _plain.sharpness(_plain.grey(full)).items()}
            nums.setdefault("sharp_rel", 0.0)
            nums.setdefault("rank_gap", 0.0)
            nums["sharp_rel"] = _max(nums["sharp_rel"], sharp_rel(
                a["scores"], scores[b]))
            nums["rank_gap"] = _max(nums["rank_gap"], rank_gap(
                a["keep"], scores[b]["teng"]))
        del frames
    gaps = torch.cat(frame_gaps) if frame_gaps else torch.zeros(1)
    nums["warp_px_median"] = float(gaps.median())
    return nums


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def sharp_rel(got: dict, want: dict) -> float:
    gap = 0.0
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        gap = _max(gap, float(np.max(np.abs(g - w) / np.abs(w))))
    return gap


def rank_gap(keep, teng) -> float:
    """0 where ``keep`` (sharpest first, the least sharp left out) is
    the order of the reference's TENG; else the largest share of TENG
    by which it goes against it."""
    keep = [int(i) for i in keep]
    dropped = sorted(set(range(len(teng))) - set(keep))
    low = float(np.min(teng))
    gap = max((float(teng[d]) - low) / low for d in dropped) if dropped else 1.0
    for a, b in zip(keep, keep[1:]):
        gap = max(gap, (float(teng[b]) - float(teng[a])) / float(teng[a]))
    return max(gap, 0.0)


def verdict(nums: dict, limits: dict):
    """``(correct, checks)``: each number the cell's limits name, with
    its limit; a named number that was not measured, is over its limit
    or is not a number is not correct."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = nums.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            correct = False
    return correct, checks
