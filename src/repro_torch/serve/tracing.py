"""Spans and device marks of the serving engine (``Engine.step``), kept in
memory until the caller asks for them.

    eng.tracer = Tracer(eng.device)     # on; ``tracing.OFF`` turns it off
    for _ in range(n):
        eng.step()
    recs = eng.tracer.records()

A span records its name, its parent span, its start and end on the
host's ``perf_counter_ns`` clock, the request's ``uid`` where it has one
and a few attributes. ``wait=True`` marks the host blocked on the device
(a readback). ``device=True`` on a CUDA device also brackets the span's
device work with a pair of pooled ``torch.cuda.Event``s recorded on the
current stream: a device segment. Its marks are resolved when the next
wait span ends, once that readback has synchronized them, so the tracer
adds no synchronization. The segment is placed on the host's clock by
anchoring the last mark recorded before that wait at the wait's return;
the anchor's error is the readback's own copy and the host's wake-up. A
segment that no wait span has followed yet is not in ``records()``.

``records()`` gives the closed spans and the resolved device segments on
the Unix-epoch clock, the clock of ``torch.profiler``'s events (the
offset from ``perf_counter_ns`` is read once, at construction).

Off (``OFF``, the tracer an engine holds unless its caller sets one), a
span is one shared no-op context: it reads no clock, makes no record and
records no event. Under an outside ``torch.profiler``, on or off, a span
is also a ``record_function`` range, so the profiler's trace names the
engine's phases.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

_profiling = torch.autograd._profiler_enabled


class _Noop:
    """The span of an off tracer."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs: Any) -> None:
        """Attributes known only inside the span; dropped when off."""


_NOOP = _Noop()


class _Annotated(_Noop):
    """The span of an off tracer under an outside profiler: a
    ``record_function`` range and nothing else."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = torch.autograd.profiler.record_function(name)

    def __enter__(self) -> "_Annotated":
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)


def _epoch_offset_ns(tries: int = 5) -> int:
    """``time.time_ns()`` less ``perf_counter_ns()``, from the tightest of
    a few read pairs: a pair split by a preemption is off by its length."""
    best = None
    for _ in range(tries):
        a, t, b = time.perf_counter_ns(), time.time_ns(), time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


class Off:
    """Records nothing (module docstring)."""

    def span(self, name: str, uid: Optional[int] = None, *,
             wait: bool = False, device: bool = False, **attrs: Any):
        return _Annotated(name) if _profiling() else _NOOP


OFF = Off()


class Span:
    """One host span of a ``Tracer``, and the context that records it."""

    __slots__ = ("_tracer", "id", "name", "parent", "uid", "wait", "attrs",
                 "start", "end", "_device", "_marks", "_rf")

    def __init__(self, tracer: "Tracer", name: str, uid: Optional[int],
                 wait: bool, device: bool, attrs: Dict[str, Any]):
        self._tracer, self.name, self.uid = tracer, name, uid
        self.wait, self._device, self.attrs = wait, device, attrs
        self.id = self.parent = self.start = self.end = None
        self._marks = self._rf = None

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tr = self._tracer
        self.id = len(tr.spans)
        self.parent = tr._stack[-1] if tr._stack else None
        tr.spans.append(self)
        tr._stack.append(self.id)
        if _profiling():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        if self._device and tr.cuda:
            self._marks = tr._mark()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        if self._marks is not None:
            tr._pending.append((self, self._marks, tr._mark()))
            self._marks = None
        self.end = time.perf_counter_ns()
        tr._stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self.wait and tr._pending:
            tr._resolve(self.end)


class Tracer:
    """Spans and device segments in memory (module docstring).

    Attributes:
      spans: every span opened, in the order opened.
      segments: resolved device segments, (name, host span id, start ns,
        end ns) on the ``perf_counter_ns`` clock.
      epoch_offset_ns: ``time.time_ns()`` less ``perf_counter_ns()``.
    """

    def __init__(self, device: Any = None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.spans: List[Span] = []
        self.segments: List[Tuple[str, int, int, int]] = []
        self._stack: List[int] = []
        self._pending: List[Tuple[Span, Any, Any]] = []
        self._free: List[Any] = []          # recorded and resolved events
        self._last: Any = None              # the newest mark recorded
        self.epoch_offset_ns = _epoch_offset_ns()

    def span(self, name: str, uid: Optional[int] = None, *,
             wait: bool = False, device: bool = False, **attrs: Any) -> Span:
        return Span(self, name, uid, wait, device, attrs)

    def _mark(self):
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record()
        self._last = ev
        return ev

    def _resolve(self, anchor_ns: int) -> None:
        """Place every pending segment on the host clock: the newest mark
        (recorded before the wait that just returned at ``anchor_ns``,
        so complete) is put at ``anchor_ns``."""
        anchor = self._last
        for sp, a, b in self._pending:
            end = anchor_ns - round(b.elapsed_time(anchor) * 1e6)
            start = end - round(a.elapsed_time(b) * 1e6)
            self.segments.append((sp.name, sp.id, start, end))
            self._free += (a, b)
        self._pending.clear()

    def records(self) -> List[Dict[str, Any]]:
        """The closed spans, then the resolved device segments, as dicts
        on the Unix-epoch clock (ns): ``name``, ``id`` (None for a
        segment), ``parent`` (a segment's: the span that launched it),
        ``start_ns``, ``end_ns``, ``uid``, ``wait``, ``device``,
        ``attrs``."""
        off = self.epoch_offset_ns
        out = [{"name": s.name, "id": s.id, "parent": s.parent,
                "start_ns": s.start + off, "end_ns": s.end + off,
                "uid": s.uid, "wait": s.wait, "device": False,
                "attrs": dict(s.attrs)}
               for s in self.spans if s.end is not None]
        parents = {s.id: s.uid for s in self.spans}
        out += [{"name": name, "id": None, "parent": parent,
                 "start_ns": a + off, "end_ns": b + off,
                 "uid": parents[parent], "wait": False, "device": True,
                 "attrs": {}}
                for name, parent, a, b in self.segments]
        return out
