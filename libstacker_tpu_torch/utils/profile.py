"""Device-time profile of one warm run of an entry point on a CUDA card.

    python -m libstacker_tpu_torch.utils.profile [--scale-down-width 800]
        [--path keypoint|ecc]
        [--variant mean|sigma_clip|replicate|mask|sr|lazy|ic|rotation]

Builds the bench's burst on the card (``utils/synth.py``: for the
keypoint path 20 textured 2160x3840 frames and its default parameters,
for ECC 100 frames of 2160x3840 and the headline parameters of
``chip_smoke.py``), runs the entry point once cold and once warm, then
once more under ``torch.profiler``.  ``--variant`` picks the stack:
the mean (default), kappa-sigma clipping (kappa 2.5, one pass), the
keypoint path's BORDER_REPLICATE, a mask zero on the top-left
sixteenth (ECC's alignment mask, the keypoint path's detection mask),
or ``output_scale=2`` (``sr``; ECC then stacks the first 8 frames, as
``bench.py:643`` does); for ECC also ``solver="lazy"``, ``solver="ic"``
or ``phase_init_rotation=True``.  Prints the card's name and power limit, the
warm wall time, the device busy time and idle share over the traced
span, and the device time by kernel name, largest first; writes the
chrome trace to ``chiprun_out/``.  Then it traces one more run with
``return_stats=True``, whose stages each end in a synchronise, and
prints the device time and operations of each stage (``grey``,
``detect``, ``stack``, ...) with its largest kernels: a device operation
belongs to the outermost stage whose host span contains its start.
Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

OUT = Path(__file__).resolve().parents[2] / "chiprun_out"


def _device_events(prof):
    """(name, start_us, duration_us) of every device-side operation (the
    device-side copies of the ``stage:`` ranges are left out)."""
    out = []
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.name.startswith("stage:")):
            out.append((ev.name, ev.time_range.start, ev.time_range.elapsed_us()))
    return out


def _busy_us(events) -> float:
    """Union of the device intervals (overlapping kernels count once)."""
    spans = sorted((s, s + d) for _, s, d in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _by_stage(prof, events):
    """stage -> (device us, operations, {kernel: us}) for the device
    events that start inside a ``stage:`` host range, the outermost
    where ranges nest: a phase synchronises at its end, so a device
    operation that starts inside it was launched by it; a span nested
    in a phase does not, so the card may still run its predecessors'
    work."""
    spans = [(ev.name[len("stage:"):], ev.time_range.start,
              ev.time_range.end) for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CPU
             and ev.name.startswith("stage:")]
    out = {}
    for name, s, d in events:
        inside = [(b - a, st) for st, a, b in spans if a <= s <= b]
        stage = max(inside)[1] if inside else "(none)"
        us, ops, names = out.setdefault(stage, [0.0, 0, defaultdict(float)])
        out[stage][0] = us + d
        out[stage][1] = ops + 1
        names[name] += d
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale-down-width", type=float, default=None)
    ap.add_argument("--path", choices=("keypoint", "ecc"), default="keypoint")
    ap.add_argument("--variant", default="mean",
                    choices=("mean", "sigma_clip", "replicate", "mask", "sr",
                             "lazy", "ic", "rotation"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: needs a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from libstacker_tpu_torch import (
        EccMatchParameters, KeyPointMatchParameters, MotionType, constants,
        ecc_match_arrays, keypoint_match_arrays,
    )
    from libstacker_tpu_torch.utils.device import resolve_device
    from libstacker_tpu_torch.utils.synth import make_burst, make_textured_burst

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    h, w = 2160, 3840
    mask = None
    if args.variant == "mask":
        mask = np.full((h, w), 255, np.uint8)
        mask[: h // 4, : w // 4] = 0
    kw = {}
    kw = {
        "sigma_clip": dict(stacking="sigma_clip", sigma_kappa=2.5,
                           sigma_iters=1),
        "sr": dict(output_scale=2),
        "lazy": dict(solver="lazy"),
        "ic": dict(solver="ic"),
        "rotation": dict(phase_init_rotation=True),
    }.get(args.variant, {})
    if args.path == "ecc":
        if args.variant == "replicate":
            ap.error("the ECC path has no border mode")
        n = 8 if args.variant == "sr" else 100
        frames, _ = make_burst(100, h, w, seed=0, device=dev)
        frames = frames[:n].contiguous()
        params = EccMatchParameters(
            motion_type=MotionType.Homography, max_count=50, epsilon=1e-4,
            gauss_filt_size=5, coarse_levels=1, **kw)

        def run(stats=False):
            return ecc_match_arrays(
                frames, params, scale_down_width=args.scale_down_width,
                mask=mask, device_output=True, return_stats=stats)
    else:
        if args.variant in ("lazy", "ic", "rotation"):
            ap.error(f"--variant {args.variant} is an ECC option")
        if args.variant == "replicate":
            kw = dict(border_mode=constants.BORDER_REPLICATE)
        n = 20
        frames, _ = make_textured_burst(n, h, w, seed=0, device=dev)
        params = KeyPointMatchParameters(**kw)

        def run(stats=False):
            return keypoint_match_arrays(
                frames, params, scale_down_width=args.scale_down_width,
                mask=mask, device_output=True, return_stats=stats)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    events = _device_events(prof)
    OUT.mkdir(exist_ok=True)
    tag = args.path + (f"_sdw{int(args.scale_down_width)}"
                       if args.scale_down_width else "")
    if args.variant != "mean":
        tag += f"_{args.variant}"
    trace = OUT / f"profile_{tag}.json"
    prof.export_chrome_trace(str(trace))
    print(smi)
    print(f"{args.path} slice ({args.variant}), {n}x{h}x{w}, "
          f"scale_down_width={args.scale_down_width}: warm wall "
          f"{warm_ms:.1f} ms")
    if not events:
        print("no device events in the trace")
        return 1
    span = max(s + d for _, s, d in events) - min(s for _, s, _ in events)
    busy = _busy_us(events)
    print(f"device span {span / 1e3:.2f} ms, busy {busy / 1e3:.2f} ms, "
          f"idle {100.0 * (1.0 - busy / span):.1f} %, kernels {len(events)}")
    by_name = defaultdict(lambda: [0.0, 0])
    for name, _, d in events:
        by_name[name][0] += d
        by_name[name][1] += 1
    total = sum(v[0] for v in by_name.values())
    print(f"{'device ms':>10} {'share':>6} {'count':>6}  kernel")
    for name, (d, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{d / 1e3:10.3f} {100.0 * d / total:5.1f}% {c:6d}  {name[:110]}")
    print(f"trace: {trace}")

    run(stats=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run(stats=True)
        torch.cuda.synchronize()
    staged = _by_stage(prof, _device_events(prof))
    print("by stage (a run with return_stats=True, each stage synchronised):")
    for stage, (us, ops, names) in staged.items():
        top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
        print(f"  {stage}: device {us / 1e3:.3f} ms, {ops} operations; "
              + "; ".join(f"{d / 1e3:.3f} {k[:60]}" for k, d in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
