"""Step watchdog, straggler detection and the checkpoint-restart driver
loop (``repro/runtime/fault_tolerance.py``).

The engine and the trainer time every step; a step slower than
``threshold`` x the rolling median of the steps before it is a
straggler (``EngineMetrics.straggler_steps``, ``train``'s
``stragglers``). ``run_with_restarts`` drives a training loop that
raises on a failure and resumes from its last committed checkpoint."""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional


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


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    last_resume_step: int = 0
    failures: List[str] = dataclasses.field(default_factory=list)


def run_with_restarts(
    train_loop: Callable[[int], int],
    *,
    max_restarts: int = 3,
    on_failure: Optional[Callable[[Exception, int], int]] = None,
) -> RestartStats:
    """Drive ``train_loop(start_step) -> last_step`` with
    checkpoint-restart: ``train_loop`` raises on a failure and is called
    again from the step ``on_failure(error, restarts)`` returns (default:
    the same step).

    Only exceptions raised by ``train_loop`` count as training failures
    (recorded in ``failures``). An exception raised by ``on_failure`` is
    a controller bug: it propagates unwrapped, unrecorded, and without
    implicit chaining (the callback runs outside the except block).
    ``last_resume_step`` is set on every restart, callback or not.

    Raises:
      RuntimeError: more than ``max_restarts`` failures (chained to the
        last one).
    """
    stats = RestartStats()
    start_step = 0
    while True:
        try:
            train_loop(start_step)
            return stats
        except Exception as e:  # noqa: BLE001 - the controller catches all
            err = e
        stats.restarts += 1
        stats.failures.append(f"{type(err).__name__}: {err}")
        if stats.restarts > max_restarts:
            raise RuntimeError(
                f"exceeded {max_restarts} restarts; last: {err}") from err
        if on_failure is not None:
            start_step = on_failure(err, stats.restarts)
        stats.last_resume_step = start_step
