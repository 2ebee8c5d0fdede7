"""Run records and the port's span recorder (counterpart of
``libstacker_tpu/utils/tracing.py``).

:class:`PipelineStats` is a copy of the reference dataclass plus
``spans``.  :class:`PhaseTimer` records a call's spans: a phase, which
given a CUDA device synchronises at its end so that its wall time
includes the device work it enqueued (PyTorch returns before the card
finishes), and spans nested in it, which never synchronise.  Each span
opens a ``torch.profiler`` range ``stage:<name>``, so a trace shows it
on the clock of the card's kernels.  A timer also keeps a call's counts
(:meth:`PhaseTimer.count`).  The module functions :func:`phase_of`,
:func:`span_of` and :func:`count_of` take a timer or None, so that a
call without stats pays one branch a span.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

#: one recorded span: (name, parent's name or None, host ms, device ms
#: or None off CUDA)
Span = Tuple[str, Optional[str], float, Optional[float]]


class PhaseTimer:
    """Records a call's phases and the spans nested in them.

    Every span keeps its name, its parent (the innermost span open when
    it started), its host duration and, on CUDA, its device duration:
    the stream time between two timing events recorded on the current
    stream at its start and end.  Read :meth:`spans` only once the
    caller has synchronised past the last span: the recorder itself
    synchronises only at a phase's end.

    >>> t = PhaseTimer()
    >>> with t.phase("load"):
    ...     with t.span("decode"):
    ...         pass
    >>> [(name, parent) for name, parent, _, _ in t.spans()]
    [('load', None), ('decode', 'load')]
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.durations: Dict[str, float] = {}
        self._order: List[str] = []
        self._cuda = device is not None and torch.device(device).type == "cuda"
        # [name, parent, host s, start event, end event] in start order
        self._records: List[list] = []
        self._open: List[str] = []
        #: name -> count, in first-seen order (:meth:`count`)
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def _record(self, name: str, sync: bool):
        rec = [name, self._open[-1] if self._open else None, 0.0, None, None]
        self._records.append(rec)
        self._open.append(name)
        with torch.profiler.record_function(f"stage:{name}"):
            if self._cuda:
                rec[3] = torch.cuda.Event(enable_timing=True)
                rec[3].record()
            t0 = time.perf_counter()
            try:
                yield rec
            finally:
                if self._cuda:
                    rec[4] = torch.cuda.Event(enable_timing=True)
                    rec[4].record()
                    if sync:
                        torch.cuda.synchronize()
                rec[2] = time.perf_counter() - t0
                self._open.pop()

    @contextlib.contextmanager
    def phase(self, name: str):
        """A stage of the call: its wall time adds to ``durations[name]``
        (and :meth:`ms`), on CUDA after a synchronise."""
        rec = None
        try:
            with self._record(name, sync=True) as rec:
                yield
        finally:
            if name not in self.durations:
                self._order.append(name)
                self.durations[name] = 0.0
            self.durations[name] += rec[2]

    def span(self, name: str):
        """A span nested in the open phase or span; never synchronises."""
        return self._record(name, sync=False)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the call's count ``name``."""
        self.counts[name] = self.counts.get(name, 0) + n

    def spans(self) -> List[Span]:
        """Every span in start order, as ``(name, parent, host_ms,
        device_ms)``."""
        return [(name, parent, host_s * 1e3,
                 None if start is None else start.elapsed_time(end))
                for name, parent, host_s, start, end in self._records]

    def ms(self) -> Dict[str, float]:
        """Phase durations in milliseconds, in first-seen order."""
        return {k: self.durations[k] * 1e3 for k in self._order}

    def report(self) -> str:
        lines = [f"{name:>24s}: {self.durations[name]*1e3:10.2f} ms"
                 for name in self._order]
        total = sum(self.durations.values())
        lines.append(f"{'total':>24s}: {total*1e3:10.2f} ms")
        return "\n".join(lines)


_NO_SPAN = contextlib.nullcontext()


def phase_of(timer: Optional[PhaseTimer], name: str):
    """``timer.phase(name)``, or without a timer one shared no-op."""
    return _NO_SPAN if timer is None else timer.phase(name)


def span_of(timer: Optional[PhaseTimer], name: str):
    """``timer.span(name)``, or without a timer one shared no-op."""
    return _NO_SPAN if timer is None else timer.span(name)


def count_of(timer: Optional[PhaseTimer], name: str, n: int = 1) -> None:
    """``timer.count(name, n)``; nothing without a timer."""
    if timer is not None:
        timer.count(name, n)


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
    #: the call's spans in start order, ``(name, parent, host_ms,
    #: device_ms)`` (``PhaseTimer.spans``): the phases; inside the ECC
    #: solve ``ecc.prep``, ``ecc.sweep``, ``ecc.check`` and
    #: ``ecc.rescue``; inside the keypoint path's ``detect`` an
    #: ``orb.level`` a pyramid level with its ``orb.topk``, and inside
    #: ``match+ransac`` ``kp.match``, a ``ransac.loop`` and a
    #: ``ransac.check`` a slab of RANSAC's loop, and ``ransac.refit``.
    spans: Optional[List[Span]] = None
    #: keypoint path: the slabs of ``ops.ransac._SLAB`` hypotheses its
    #: RANSAC loop ran (the whole-burst entry point, with stats).
    ransac_slabs: Optional[int] = None

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
