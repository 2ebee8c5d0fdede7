"""Run records, phase timers and profiler traces (counterpart of
``libstacker_tpu/utils/tracing.py``).

:class:`PipelineStats` is a copy of the reference dataclass.
:class:`PhaseTimer` adds one thing: given a CUDA device it synchronises
at the end of every phase, so a phase's wall time includes the device
work it enqueued (PyTorch returns before the card finishes).
:func:`trace` records ``torch.profiler`` where the JAX package records
``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import torch


class PhaseTimer:
    """Collects named wall-time phases.

    >>> t = PhaseTimer()
    >>> with t.phase("load"):
    ...     pass
    >>> _ = t.report()
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.durations: Dict[str, float] = {}
        self._order: List[str] = []
        self._sync = device is not None and torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name not in self.durations:
                self._order.append(name)
                self.durations[name] = 0.0
            self.durations[name] += dt

    def ms(self) -> Dict[str, float]:
        """Phase durations in milliseconds, in first-seen order."""
        return {k: self.durations[k] * 1e3 for k in self._order}

    def report(self) -> str:
        lines = [f"{name:>24s}: {self.durations[name]*1e3:10.2f} ms"
                 for name in self._order]
        total = sum(self.durations.values())
        lines.append(f"{'total':>24s}: {total*1e3:10.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (host operations, and
    the card's kernels where CUDA is available) and write a Chrome trace
    ``trace_<pid>_<ns>.json`` into ``log_dir``; a no-op when ``log_dir``
    is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclasses.dataclass
class PipelineStats:
    """Structured per-run observability (SURVEY.md §5 metrics/logging)."""

    frames_total: int = 0
    frames_kept: int = 0
    frames_dropped: int = 0
    ecc_iterations: Optional[List[int]] = None
    ecc_rho: Optional[List[float]] = None
    match_counts: Optional[List[int]] = None
    inlier_counts: Optional[List[int]] = None
    phase_ms: Optional[Dict[str, float]] = None
    #: stacking="sigma_clip" only: fraction of warped samples rejected
    #: by the kappa-sigma clip (0.0 on outlier-free bursts).
    clipped_sample_frac: Optional[float] = None

    def summary(self) -> str:
        parts = [
            f"frames {self.frames_kept}/{self.frames_total} kept "
            f"({self.frames_dropped} dropped)"
        ]
        if self.ecc_iterations is not None:
            parts.append(f"ecc iters {self.ecc_iterations}")
        if self.match_counts is not None:
            parts.append(f"matches {self.match_counts}")
        if self.inlier_counts is not None:
            parts.append(f"inliers {self.inlier_counts}")
        return "; ".join(parts)
