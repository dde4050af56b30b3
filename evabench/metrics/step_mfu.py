"""step_mfu: the window's least time at the chip's published peaks over
the window's seconds, %. A tick's least time is its prefills' and its
decode step's, each the larger of its operations at 989 TFLOP/s and its
bytes at 3.35 TB/s (``bench.counts``: weights as stored read once a
step, the cache rows attended and written), counted from the
configuration's shapes and the true lengths of the window's requests."""
from bench import counts


def read(run):
    least = counts.ticks_least_s(run.cfg, run.ticks)
    return least / (run.t_close - run.t_open) * 100.0
