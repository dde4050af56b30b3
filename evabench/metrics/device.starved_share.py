"""device.starved_share: the share of the program-traced stretch's wall
time, from its first ``step()`` to the return of its last, in which the
device had none of the engine's work in flight, %: one less the union of
the engine's device segments (its own CUDA events around the graph calls
and the eager epilogues, ``bench.spans``) over that time. No profiler.
Gaps inside one segment count as work in flight, so this is the host's
starving of the device, not the packing of its kernels. Silent without
the stretch (``run.spans``, which a program with no tracer leaves out)."""
from bench import spans


def read(run):
    return spans.starved_share(getattr(run, "spans", None))
