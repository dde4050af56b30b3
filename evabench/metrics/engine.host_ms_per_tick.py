"""engine.host_ms_per_tick: mean host ms a tick inside ``step()`` over the
program-traced stretch: the engine's ``engine.step`` span less its
``wait`` spans (the readbacks, where the host is blocked on the device).
Silent without the stretch (``run.spans``)."""
from bench import spans


def read(run):
    return spans.host_ms_per_tick(getattr(run, "spans", None))
