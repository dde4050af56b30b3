"""Drive the engine from closed-loop clients and stamp what it returns.

Every ``step()`` is one engine tick; each token it returns is stamped on
the host clock when ``step()`` returns (the engine's readback has
synchronized the device by then), which is when a client would see it.
A client whose request finished submits its next one at once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from bench.traffic import ClosedLoop, Request


@dataclasses.dataclass(eq=False)
class Stream:
    """One request as its client saw it."""

    index: int
    client: int
    prompt: np.ndarray
    max_new: int
    submit_t: float
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    finish: Optional[str] = None
    finish_t: Optional[float] = None

    @property
    def first_t(self) -> Optional[float]:
        return self.stamps[0] if self.stamps else None


@dataclasses.dataclass
class Tick:
    """One ``step()``: its host span, the prompt lengths it prefilled and
    the positions each lane of its decode step attended over."""

    t0: float
    t1: float
    prefills: List[int] = dataclasses.field(default_factory=list)
    attended: List[int] = dataclasses.field(default_factory=list)


class Clients:
    """The closed loop over an engine (``bench.port.Served``)."""

    def __init__(self, served, loop: ClosedLoop):
        self.served, self.loop = served, loop
        self.streams: Dict[int, Stream] = {}
        self.ticks: List[Tick] = []

    def submit(self, req: Request) -> None:
        t = time.perf_counter()
        uid = self.served.submit(req.prompt, req.max_new)
        self.streams[uid] = Stream(req.index, req.client, req.prompt,
                                   req.max_new, t)

    def start(self) -> None:
        for req in self.loop.first():
            self.submit(req)

    def tick(self) -> Tick:
        t0 = time.perf_counter()
        events = self.served.step()
        t1 = time.perf_counter()
        tick = Tick(t0, t1)
        done = []
        for ev in events:
            s = self.streams[ev.uid]
            if ev.token is not None:
                s.stamps.append(t1)
                s.tokens.append(int(ev.token))
                s.logprobs.append(ev.logprob)
                n = len(s.prompt)
                if ev.index == 0:
                    tick.prefills.append(n)
                else:   # token i came from a step over n + i positions
                    tick.attended.append(n + ev.index)
            if ev.finish is not None:
                s.finish, s.finish_t = ev.finish, t1
                done.append(s.client)
        for client in done:
            self.submit(self.loop.next(client))
        self.ticks.append(tick)
        return tick

    def filled(self) -> bool:
        """Every client's newest request has its first token."""
        newest: Dict[int, Stream] = {}
        for s in self.streams.values():
            if s.client not in newest or s.index > newest[s.client].index:
                newest[s.client] = s
        return len(newest) == self.loop.clients and all(
            s.stamps for s in newest.values())

    def run_until(self, stop: Callable[[Tick], bool]) -> Tick:
        while True:
            t = self.tick()
            if stop(t):
                return t

    def finished_in(self, t_open: float, t_close: float) -> List[Stream]:
        return [s for s in self.streams.values()
                if s.finish_t is not None and t_open < s.finish_t <= t_close]
