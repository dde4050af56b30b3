"""CUDA-event timing of a kernel call, a frozen copy of ``chip_smoke.Timer``.

No run of a cell uses it: the runs take every number from the host clock
over the served window and from the profiler's trace. It is kept for a
kernel's time outside a run (a check of a roofline reader's arithmetic
against one call at the cell's shapes)."""
from __future__ import annotations

import statistics


class Timer:
    """Median CUDA-event time of a call over ``reps`` runs after warm-up.
    Before each run the L2 is flushed (the serving path finds every
    layer's weights cold) and the stream is held busy with a GPU sleep,
    so the host enqueues the whole call before the first event fires:
    the events then bracket the call's device time, not its host
    overhead."""

    SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's boost clock

    def __init__(self, torch, reps: int = 20, warmup: int = 3):
        self.torch, self.reps, self.warmup = torch, reps, warmup
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.bitwise_not_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)
