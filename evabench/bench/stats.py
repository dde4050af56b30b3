"""End-to-end statistics over host-stamped token streams.

A request's stream is the host times at which ``Engine.step()`` returned
each of its tokens (one stamp a token), beside its submit time. A window
is (t_open, t_close]: a token counts when its stamp lies inside it.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile, linear between order statistics (numpy's
    default); None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def in_window(t: float, t_open: float, t_close: float) -> bool:
    return t_open < t <= t_close


def window_tokens(streams: Iterable[Sequence[float]], t_open: float,
                  t_close: float) -> int:
    return sum(1 for s in streams for t in s if in_window(t, t_open, t_close))


def output_tok_s(streams: Iterable[Sequence[float]], t_open: float,
                 t_close: float) -> float:
    """Every token the window emitted, over the window's seconds."""
    return window_tokens(streams, t_open, t_close) / (t_close - t_open)


def gaps(streams: Iterable[Sequence[float]], t_open: float,
         t_close: float) -> List[float]:
    """Seconds between consecutive tokens of one request, for every pair
    whose two stamps lie in [t_open, t_close] (the window and its
    opening stamp)."""
    out: List[float] = []
    for s in streams:
        inside = [t for t in s if t_open <= t <= t_close]
        out.extend(b - a for a, b in zip(inside, inside[1:]))
    return out


def itl_ms(streams, t_open, t_close, q: float) -> Optional[float]:
    g = gaps(streams, t_open, t_close)
    v = percentile(g, q)
    return None if v is None else v * 1e3
