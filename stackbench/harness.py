"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the check against the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name:

- ``BENCHMARK.json``'s ``configs[].file``: the configuration (entry
  point, parameters, frame shape, content recipe);
- ``stackbench/traffic/<traffic>.json``: the loop (``driver``), burst
  depth, pool, ``scale_down_width``, the calls checked and traced, and
  the limits of the check under each configuration's name;
- ``stackbench/drivers/<driver>.py``: the loop's ``Loop`` class;
- ``stackbench/reference/<config>.py``: the configuration's plain
  reference;
- ``stackbench/metrics/<metric>.py``: a per-layer metric's ``read(ctx)``,
  which returns a number or None (nothing to read: left out).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from stackbench import compare, trace
from stackbench.reference import _plain

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "libstacker_tpu")


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(
        "stackbench._loaded." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is in ``FORBIDDEN``."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Cell:
    """A workload of ``bench`` and everything it names."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT,
                 base: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        cfg = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = load_json(root / cfg["file"])
        self.config_name = cfg["name"]
        self.traffic = load_json(base / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.driver = importlib.import_module(
            "stackbench.drivers." + self.traffic["driver"])
        self.reference = load_file(base / "reference"
                                   / f"{self.config_name}.py")
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.readers = {m["name"]: load_file(HERE / "metrics"
                                             / f"{m['name']}.py")
                        for m in self.per_layer}

    @property
    def limits(self) -> dict:
        return self.traffic["limits"][self.config_name]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _order(rng, pool: int):
    while True:
        yield from (int(b) for b in rng.permutation(pool))


def _mem(device, fn: str) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(getattr(torch.cuda, fn)())


def end_to_end(lat_s, frames: int, window_s: float, work_bytes: int,
               setup_s: float) -> dict:
    """name -> (value, unit): frames handed in over the whole window
    (first call to last completion), the 95th percentile of every
    burst's latency, the window's peak allocation above what set-up
    held, and the set-up time."""
    return {
        "frames_per_s": (frames / window_s, "frames/s"),
        "burst_p95_ms": (float(np.percentile(np.asarray(lat_s) * 1e3, 95)),
                         "ms"),
        "work_mem_gib": (work_bytes / 2**30, "GiB"),
        "setup_s": (setup_s, "s"),
    }


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t0: float, loop_hook=None) -> dict:
    """One run; returns the result object that the command prints.
    ``t0`` is the process's start on ``time.time()``; ``loop_hook``, if
    given, is called on the loop before the window (the fault tests
    break the timed path there)."""
    traffic = cell.traffic
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if traced:
        from libstacker_tpu_torch.utils import tracing
        trace.stage_ranges(tracing.PhaseTimer)
        # the profiler's first start loads CUPTI (seconds): in set-up
        with torch.profiler.profile(activities=acts):
            torch.zeros(1, device=device).add_(1)
            _sync(device)
    loop = cell.driver.Loop(cell.config, traffic, device, seed)
    if loop_hook is not None:
        loop_hook(loop)
    out, _, _ = loop.call(0, traced)
    _sync(device)
    del out
    setup_s = time.time() - t0
    setup_peak = _mem(device, "max_memory_allocated")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    held = _mem(device, "memory_allocated")

    rng = np.random.default_rng([seed, 1])
    pick = np.random.default_rng([seed, 2])
    n_check = traffic["check_calls"]
    trace_from, trace_calls = 2, traffic["trace_calls"]
    lat, calls, sampled = [], [], []
    attempted = failed = frames = 0
    prof = prof_done = None
    t_start = time.perf_counter()
    t_end = t_start
    for k, b in enumerate(_order(rng, traffic["pool"])):
        if traced and k == trace_from:
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        t = time.perf_counter()
        out = st = rec = None
        try:
            with torch.profiler.record_function("stackbench.call"):
                out, st, rec = loop.call(b, traced)
                _sync(device)
        except Exception:  # a failed call is counted and the run goes on
            failed += 1
            if failed == 1:
                log(traceback.format_exc())
        t_end = time.perf_counter()
        attempted += 1
        frames += loop.frames_in(b)
        lat.append(t_end - t)
        if prof is not None and k == trace_from + trace_calls - 1:
            prof.__exit__(None, None, None)
            prof_done, prof = prof, None
        if rec is not None:
            calls.append({"b": b, "record": rec, "stats": st, "k": k})
            if len(sampled) < n_check:
                sampled.append((k, b, out, rec))
            else:
                j = int(pick.integers(0, len(calls)))
                if j < n_check:
                    sampled[j] = (k, b, out, rec)
        del out, st, rec
        # a traced run goes on until its profiled calls are done
        if t_end - t_start >= seconds and (prof_done or not traced):
            break
    if prof is not None:
        prof.__exit__(None, None, None)
        prof_done = prof
    window = t_end - t_start
    work = _mem(device, "max_memory_allocated") - held
    peak = max(setup_peak, _mem(device, "max_memory_allocated"))
    lat_ms = np.asarray(lat) * 1e3
    log(f"window: {attempted} bursts ({failed} failed), {frames} frames "
        f"in {window:.3f} s; burst latency median "
        f"{np.median(lat_ms):.3f} ms, p95 {np.percentile(lat_ms, 95):.3f} "
        f"ms over {len(lat_ms)} bursts; set-up {setup_s:.3f} s")
    e2e = end_to_end(lat, frames, window, work, setup_s)
    result = {"correct": False, "attempted": attempted, "failed": failed}
    dev_info = {"platform": "gpu" if torch.device(device).type == "cuda"
                else "cpu",
                "kind": (torch.cuda.get_device_name()
                         if torch.device(device).type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if traced:
        metrics, extra, breakdown = _per_layer(cell, loop, calls, prof_done)
        dev_info.update(extra)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]][0],
                               "unit": e2e[m["name"]][1]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev_info
    if breakdown is not None:
        result["breakdown"] = breakdown

    # the check, once the window has closed and the program's state is
    # freed: the sampled calls, and every call on their bursts
    keys = {b for _, b, _, _ in sampled}
    answers = [loop.answer(b, rec, out) for _, b, out, rec in sampled]
    sampled_k = {k for k, _, _, _ in sampled}
    answers += [loop.answer(c["b"], c["record"]) for c in calls
                if c["b"] in keys and c["k"] not in sampled_k]
    del calls, sampled
    loop.release(keys)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    _plain.no_tf32()
    t_check = time.perf_counter()
    nums = compare.judge(answers, cell.reference, traffic, loop.hw)
    log(f"check: {len(answers)} answers on {len(keys)} bursts against the "
        f"plain reference in {time.perf_counter() - t_check:.3f} s")
    ok, checks = compare.verdict(nums, cell.limits)
    result["correct"] = ok and failed == 0 and attempted > 0
    result["checks"] = checks
    return result


def _per_layer(cell: Cell, loop, calls, prof):
    """The traced run's per-layer metrics, ``busy_s`` / ``window_s`` and
    the breakdown."""
    events, window = [], (0.0, 0.0)
    stages = []
    if prof is not None:
        ranges = trace.host_ranges(prof, "stackbench.call")
        if ranges:
            window = (min(a for _, a, _ in ranges),
                      max(b for _, _, b in ranges))
        events = trace.clip(trace.device_events(prof), *window)
        stages = trace.host_ranges(prof, "stage:")
    w_us = window[1] - window[0]
    busy = trace.busy_us(events)
    profiled = len(trace.host_ranges(prof, "stackbench.call")) if prof else 0
    ctx = SimpleNamespace(
        calls=[{"b": c["b"], "stats": c["stats"],
                "frames": loop.frames_in(c["b"]),
                "stacked": loop.frames_stacked(c["b"])} for c in calls],
        spans=loop.spans, events=events, window_us=w_us, busy_us=busy,
        profiled_calls=profiled, config=cell.config, traffic=cell.traffic,
        hw=loop.hw,
    )
    metrics = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    extra = {"busy_s": busy / 1e6, "window_s": w_us / 1e6}
    gaps = trace.idle_gaps(events, *window) if w_us > 0 else []
    breakdown = {
        "device_ops": [[n[:160], s] for n, s in trace.by_name(events)[:10]],
        "idle_gaps": [[n, s] for n, s in trace.gaps_by_stage(gaps, stages)[:10]],
    }
    log(f"traced: {profiled} calls profiled, window {w_us / 1e6:.6f} s, "
        f"device busy {busy / 1e6:.6f} s")
    return metrics, extra, breakdown
