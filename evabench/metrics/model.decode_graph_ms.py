"""model.decode_graph_ms: mean device ms of the decode step's graph call
(its input copies and its replay, the engine's ``decode.graph`` segment
of CUDA events) over the program-traced stretch's decode ticks, with no
profiler: the untraced counterpart of the profiler's busy time a tick.
Silent without the stretch (``run.spans``)."""
from bench import spans


def read(run):
    return spans.segment_ms(getattr(run, "spans", None), "decode.graph")
