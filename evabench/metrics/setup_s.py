"""setup_s: seconds from the start of the run's process to the opening of
the window: imports, the weights drawn, the engine built (the decode
graph captured), the cell's prefill buckets built and replayed once, and
every slot filled (host clock)."""


def read(run):
    return run.setup_s
