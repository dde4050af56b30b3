"""itl_p95_ms: the 95th percentile of every gap between two consecutive
tokens of one request, over all requests, both tokens in the window
(host clock)."""
from bench import stats


def read(run):
    return stats.itl_ms([s.stamps for s in run.streams], run.t_open,
                        run.t_close, 95)
