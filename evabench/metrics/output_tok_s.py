"""output_tok_s: every token the window emitted, over the window's
seconds (host clock; a token counts at the return of the ``step()`` that
brought it)."""
from bench import stats


def read(run):
    return stats.output_tok_s([s.stamps for s in run.streams], run.t_open,
                              run.t_close)
