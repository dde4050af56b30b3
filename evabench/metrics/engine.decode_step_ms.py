"""engine.decode_step_ms: the engine's own decode time over its decode
steps in the window (``EngineMetrics.decode_s`` / ``decode_steps``,
host clock inside ``Engine.step``, synchronized by the token readback)."""


def read(run):
    a, b = run.counters_open, run.counters_close
    n = b["decode_steps"] - a["decode_steps"]
    return (b["decode_s"] - a["decode_s"]) / n * 1e3 if n else None
