"""Step watchdog and straggler detection (``repro/runtime/
fault_tolerance.py``: ``StragglerReport`` and ``StepWatchdog``; the
training restart loop waits for ROADMAP A10).

The engine times every batched decode step; a step slower than
``threshold`` x the rolling median of the steps before it is a
straggler, counted in ``EngineMetrics.straggler_steps``."""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    median: float
    ratio: float
    is_straggler: bool


class StepWatchdog:
    """Per-step wall time against the rolling median of the last
    ``window`` steps; after ``warmup_steps`` (and at least five timed
    steps), a step above ``threshold`` x the median is a straggler, and
    it stays out of the window the median is taken over."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 warmup_steps: int = 5):
        self.window: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self.reports: List[StragglerReport] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self) -> StragglerReport:
        assert self._t0 is not None, "start_step not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        self._step += 1
        med = sorted(self.window)[len(self.window) // 2] if self.window else dt
        ratio = dt / max(med, 1e-9)
        is_straggler = (self._step > self.warmup_steps
                        and len(self.window) >= 5
                        and ratio > self.threshold)
        if not is_straggler:
            self.window.append(dt)
        rep = StragglerReport(self._step, dt, med, ratio, is_straggler)
        self.reports.append(rep)
        return rep

    @property
    def straggler_steps(self) -> List[int]:
        return [r.step for r in self.reports if r.is_straggler]
