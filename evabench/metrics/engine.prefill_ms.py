"""engine.prefill_ms: the engine's own prefill time over its prefills in
the window (``EngineMetrics.prefill_s`` / ``prefills``: admission,
the bucket's graph, the first token's sample and the slot insertion)."""


def read(run):
    a, b = run.counters_open, run.counters_close
    n = b["prefills"] - a["prefills"]
    return (b["prefill_s"] - a["prefill_s"]) / n * 1e3 if n else None
