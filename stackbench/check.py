"""Readings that set the limits of the check, on the card, at a cell's
own size.

    python3 stackbench/check.py --workload NAME --seeds 11,12,13 \
        --mode program|control|half|warp|pixel|refit [--seconds S]

- ``program``: a whole run of the cell (a short window), its numbers;
- ``control``: the plain reference computed in bfloat16 put in the
  program's place (``bfloat16`` for the configuration's float32): its
  answers on the bursts a run would check, judged as the program's are;
- ``half``, ``warp``, ``pixel``: a run with the timed path broken
  underneath: half of each burst left out and the mean taken over the
  rest; one frame's warp moved by 4 px where the alignment produces it;
  the stacked image altered by 0.1 on a 16x16 patch where it is produced;
- ``refit`` (keypoint cells): RANSAC's refit on the inliers left out.

Prints one line a seed: ``READING <mode> <seed> {numbers}``.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _half(loop):
    inner = loop.entry

    def half(frames, stats):
        return inner(frames[: max(frames.shape[0] // 2, 2)], stats)

    loop.entry = half


# the warp fault's move, in full-resolution px
MOVE_PX = 4.0


def _warp(loop):
    """Move frame 1's warp by ``MOVE_PX`` in x where the alignment
    returns it;
    the loop records the moved warp, the one the stack uses."""
    from libstacker_tpu_torch.models import keypoint as kp
    from libstacker_tpu_torch.ops import ecc as ecc_ops

    from stackbench.drivers import burst

    entry = loop.entry
    solve = ecc_ops.find_transform_ecc_batched

    def ecc_moved(*args, **kwargs):
        res = solve(*args, **kwargs)
        wm = res.warp_matrix.clone()
        wm[0, 0, 2] += MOVE_PX
        entry.last = (wm, res.ok)
        return res._replace(warp_matrix=wm)

    estimate = kp._match_and_estimate

    def kp_moved(*args, **kwargs):
        hs, ok, *rest = estimate(*args, **kwargs)
        hs = hs.clone()
        hs[0, 0, 2] += MOVE_PX
        entry.last = (hs, ok)
        return (hs, ok, *rest)

    burst.patch(loop.patches, ecc_ops, "find_transform_ecc_batched", ecc_moved)
    burst.patch(loop.patches, kp, "_match_and_estimate", kp_moved)


def _pixel(loop):
    inner = loop.entry

    def altered(frames, stats):
        out, st, rec = inner(frames, stats)
        h, w = out.shape[0], out.shape[1]
        out[h // 2 : h // 2 + 16, w // 2 : w // 2 + 16] += 0.1
        return out, st, rec

    loop.entry = altered


def _no_refit(loop):
    """RANSAC without its last stage: the best 4-point hypothesis is
    returned as it was drawn, with no least-squares refit and no
    Gauss-Newton polish on its inliers."""
    import torch
    from libstacker_tpu_torch.ops import ransac

    from stackbench.drivers import burst

    def no_fit(src, dst, weights):
        shape = src.shape[:-2] + (3, 3)
        return torch.full(shape, float("nan"), device=src.device)

    burst.patch(loop.patches, ransac, "_dlt_least_squares", no_fit)
    burst.patch(loop.patches, ransac, "_gauss_newton_refine",
                lambda h, *args, **kwargs: h)


# faults that every cell can have
FAULTS = {"half": _half, "warp": _warp, "pixel": _pixel}
# faults of one entry point's own layers: entry -> name -> fault
ENTRY_FAULTS = {"keypoint_match_arrays": {"refit": _no_refit}}
ALL_FAULTS = dict(FAULTS, **{k: f for d in ENTRY_FAULTS.values()
                             for k, f in d.items()})


def control(cell, seed: int, device):
    """The reference in bfloat16 in the program's place, on the bursts
    a run of ``seed`` would check."""
    import numpy as np
    import torch

    from stackbench import compare
    from stackbench.reference import _plain

    _plain.no_tf32()
    loop = cell.driver.Loop(cell.config, cell.traffic, device, seed)
    pick = np.random.default_rng([seed, 3])
    bursts = sorted({int(b) for b in pick.choice(
        cell.traffic["pool"], cell.traffic["check_calls"])})
    loop.release(set(bursts))
    answers = [loop.control_answer(b, cell.reference, torch.bfloat16)
               for b in bursts]
    return compare.judge(answers, cell.reference, cell.traffic, loop.hw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("program", "control") + tuple(ALL_FAULTS))
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from stackbench import harness

    if not torch.cuda.is_available():
        harness.log("check: needs a CUDA card")
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell(bench, args.workload)
        t = time.time()
        if args.mode == "control":
            nums = control(cell, seed, "cuda")
            correct = harness.compare.verdict(nums, cell.limits)[0]
        else:
            res = harness.run(cell, seed, args.seconds, False, "cuda",
                              time.time(), ALL_FAULTS.get(args.mode))
            nums = {k: v["value"] for k, v in res["checks"].items()}
            correct = res["correct"]
        torch.cuda.empty_cache()
        print(f"READING {args.mode} {args.workload} {seed} correct={correct} "
              f"{json.dumps(nums)} ({time.time() - t:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
