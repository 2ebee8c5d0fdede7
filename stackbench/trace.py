"""Device time from a ``torch.profiler`` trace: a frozen copy of the
arithmetic of ``libstacker_tpu_torch/utils/profile.py``
(``_device_events`` :46-54, ``_busy_us`` :57-71, the ``stage:`` ranges of
``_stage_ranges`` :74-86 and ``_by_stage`` :89-104), with the device
intervals clipped to the traced window and the idle gaps attributed to
the host stage in which they start.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch


def stage_ranges(timer_cls) -> None:
    """Open a profiler range ``stage:<name>`` around every phase of the
    entry points' ``PhaseTimer`` (this process only)."""
    phase = timer_cls.phase

    @contextlib.contextmanager
    def ranged(self, name):
        with torch.profiler.record_function(f"stage:{name}"):
            with phase(self, name):
                yield

    timer_cls.phase = ranged


def device_events(prof):
    """``(name, start_us, duration_us)`` of every device-side operation
    (the device-side copies of the ``stage:`` ranges left out)."""
    out = []
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.name.startswith("stage:")
                and not ev.name.startswith("stackbench.")):
            out.append((ev.name, ev.time_range.start,
                        ev.time_range.elapsed_us()))
    return out


def host_ranges(prof, prefix: str):
    """``(name, start_us, end_us)`` of the host ranges named
    ``prefix...``, the prefix taken off."""
    return [(ev.name[len(prefix):], ev.time_range.start, ev.time_range.end)
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CPU
            and ev.name.startswith(prefix)]


def clip(events, t0: float, t1: float):
    """The events' parts inside ``[t0, t1]``."""
    out = []
    for name, s, d in events:
        a, b = max(s, t0), min(s + d, t1)
        if b > a:
            out.append((name, a, b - a))
    return out


def _union(events):
    spans = sorted((s, s + d) for _, s, d in events)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_us(events) -> float:
    """Union of the device intervals (overlapping kernels count once)."""
    return sum(e - s for s, e in _union(events))


def idle_gaps(events, t0: float, t1: float):
    """``(start_us, end_us)`` of every stretch of ``[t0, t1]`` in which
    no device operation ran."""
    gaps, cur = [], t0
    for s, e in _union(events):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def by_name(events):
    """Device seconds by operation name, largest first."""
    tot = defaultdict(float)
    for name, _, d in events:
        tot[name] += d / 1e6
    return sorted(tot.items(), key=lambda kv: -kv[1])


def gaps_by_stage(gaps, stages):
    """Idle seconds by the host stage whose range holds a gap's start
    (the innermost, where ranges nest), largest first."""
    tot = defaultdict(float)
    for s, e in gaps:
        inside = [(b - a, name) for name, a, b in stages if a <= s < b]
        name = min(inside)[1] if inside else "(host, outside the stages)"
        tot[name] += (e - s) / 1e6
    return sorted(tot.items(), key=lambda kv: -kv[1])
