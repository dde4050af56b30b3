"""The program-traced stretch: the closed loop's ticks with the engine's
own tracer on (``repro_torch.serve.tracing``) and no profiler, and what
its records say. The tracer keeps host spans of every phase of
``Engine.step`` and, on CUDA, device segments bracketed by the engine's
CUDA events, placed on the host's clock (the program's docstring); so
the device's idle time is read without the profiler's cost per graph
node, and named by the engine's phase running at its middle.

A program with no tracer (one older than it) gives no stretch, and every
reading here is then None."""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

PROGRAM_TRACE_S = 5.0
ROOT = "engine.step"
GAP_US = 5.0


@dataclasses.dataclass
class Spans:
    """The tracer's records (``Tracer.records()``) and the stretch's
    ticks (``loop.Tick``)."""

    records: List[Dict]
    ticks: List[object]

    def roots(self) -> List[Dict]:
        return sorted((r for r in self.records
                       if r["name"] == ROOT and not r["device"]),
                      key=lambda r: r["start_ns"])

    def segments(self) -> List[Dict]:
        return [r for r in self.records if r["device"]]


def program_trace(eng, tick: Callable[[], object],
                  seconds: float = PROGRAM_TRACE_S) -> Optional[Spans]:
    """Run ``tick`` (the closed loop's) for ``seconds`` with ``eng``'s
    tracer on; None where the program has no tracer."""
    try:
        from repro_torch.serve.tracing import OFF, Tracer
    except ImportError:
        return None
    tracer = eng.tracer = Tracer(eng.device)
    ticks = []
    t_end = time.perf_counter() + seconds
    try:
        while not ticks or ticks[-1].t1 < t_end:
            ticks.append(tick())
    finally:
        eng.tracer = OFF
    return Spans(tracer.records(), ticks)


def _union(intervals: List[Tuple[int, int]], lo: int, hi: int
           ) -> List[Tuple[int, int]]:
    """The union of ``intervals`` clipped to [lo, hi], in order."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _window(spans: Spans) -> Optional[Tuple[int, int, List[Tuple[int, int]]]]:
    """(first step's start, last step's return, the union of the device
    segments between them), or None without steps or segments."""
    roots, segs = spans.roots(), spans.segments()
    if not roots or not segs:
        return None
    lo, hi = roots[0]["start_ns"], roots[-1]["end_ns"]
    return lo, hi, _union([(s["start_ns"], s["end_ns"]) for s in segs],
                          lo, hi)


def starved_share(spans: Optional[Spans]) -> Optional[float]:
    """The share of the stretch's wall time in which the device had none
    of the engine's work in flight, %."""
    w = None if spans is None else _window(spans)
    if w is None:
        return None
    lo, hi, busy = w
    return (1.0 - sum(b - a for a, b in busy) / (hi - lo)) * 100.0


def segment_ms(spans: Optional[Spans], name: str) -> Optional[float]:
    """Mean device ms of the segments called ``name``."""
    if spans is None:
        return None
    ms = [(s["end_ns"] - s["start_ns"]) * 1e-6 for s in spans.segments()
          if s["name"] == name]
    return sum(ms) / len(ms) if ms else None


def _children(records: List[Dict]) -> Dict[int, List[Dict]]:
    kids: Dict[int, List[Dict]] = {}
    for r in records:
        if not r["device"] and r["parent"] is not None:
            kids.setdefault(r["parent"], []).append(r)
    return kids


def host_ms_per_tick(spans: Optional[Spans]) -> Optional[float]:
    """Mean over the ticks of the ``engine.step`` span less its ``wait``
    descendants (a wait inside a wait counted once): host work inside
    ``step()``."""
    roots = [] if spans is None else spans.roots()
    if not roots:
        return None
    kids = _children(spans.records)

    def waited(r: Dict) -> int:
        if r["wait"]:
            return r["end_ns"] - r["start_ns"]
        return sum(waited(k) for k in kids.get(r["id"], ()))

    host = [r["end_ns"] - r["start_ns"] - waited(r) for r in roots]
    return sum(host) / len(host) * 1e-6


def gaps_by_span(spans: Optional[Spans], top: int = 10
                 ) -> List[Tuple[str, float]]:
    """The stretch's stretches with no device segment, in seconds by the
    innermost host span at each one's middle ("between steps" where no
    step runs; gaps under ``GAP_US`` together), the longest first."""
    w = None if spans is None else _window(spans)
    if w is None:
        return []
    lo, hi, busy = w
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    host = sorted((r for r in spans.records if not r["device"]),
                  key=lambda r: r["start_ns"])
    starts = [r["start_ns"] for r in host]
    out: Dict[str, float] = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        key = f"gaps under {GAP_US:g} us"
        if b - a >= GAP_US * 1e3:
            mid, key = (a + b) // 2, "between steps"
            # spans nest: the latest started that runs at ``mid`` is the
            # innermost; none started before an ended step holds mid
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                r = host[j]
                if r["end_ns"] >= mid:
                    key = r["name"]
                    break
                if r["name"] == ROOT:
                    break
        out[key] = out.get(key, 0.0) + (b - a) * 1e-9
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]
