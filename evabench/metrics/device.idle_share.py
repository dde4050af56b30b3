"""device.idle_share: the share of a tick's time in which no operation
runs on the device, %. Over the traced decode ticks whose trace holds
B1's four launches a layer (``trace.complete``: the tracer can lose
events at the edges of a stretch): their busy time (the union of the
profiler's device intervals) over the time the untraced window took for
ticks of the same kind, a kind being the number of prefills a tick ran.
A tick's time runs from its ``step()`` to the next, the harness's work
between them included. The traced stretch's own length is not the
denominator: the profiler's instrumentation of a CUDA graph launch
costs the host about 2 us a node, which doubles a traced tick of the
chat cells."""
from statistics import fmean

from bench.trace import complete


def kind(tick) -> int:
    return len(tick.prefills)


def read(run):
    if run.trace is None or not run.ticks:
        return None
    L = run.cfg["num_hidden_layers"]
    ticks = complete([t for t in run.trace.ticks if t.info.attended],
                     "fused_vq_matmul", lambda t: 4 * L)
    starts = [t.t0 for t in run.ticks] + [run.t_close]
    walls = {}
    for t, a, b in zip(run.ticks, starts, starts[1:]):
        if t.attended:
            walls.setdefault(kind(t), []).append(b - a)
    ticks = [t for t in ticks if kind(t.info) in walls]
    if not ticks:
        return None
    busy = sum(t.busy() for t in ticks)
    wall = sum(fmean(walls[kind(t.info)]) for t in ticks)
    return (1.0 - busy / wall) * 100.0
