"""model.plain_ms_per_step: device ms a decode step in operations that are
not the port's kernels (norms, rope, cache writes, SwiGLU, the head,
sampling, copies), over the traced ticks that prefilled nothing."""


def read(run):
    if run.trace is None:
        return None
    ticks = [t for t in run.trace.ticks
             if not t.info.prefills and t.info.attended]
    if not ticks:
        return None
    s = sum(t.seconds(lambda o: o.label == "other") for t in ticks)
    return s / len(ticks) * 1e3
