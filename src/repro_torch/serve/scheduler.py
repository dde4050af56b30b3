"""Request scheduler for continuous batching (``repro/serve/scheduler.py``):
a bounded queue of ``TrackedRequest``s admitted earliest-deadline-first
into free decode slots, behind the paged engine's block budget."""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import torch

from repro_torch.serve.api import GenerationRequest


class QueueFull(Exception):
    """Raised by ``Scheduler.submit`` at ``max_queue``; the engine rejects
    the request instead of queueing it."""


@dataclasses.dataclass
class TrackedRequest:
    """Engine-side runtime record of one submitted request."""

    uid: int
    request: GenerationRequest
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    submit_t: float = dataclasses.field(default_factory=time.perf_counter)
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    decode_t0: float = 0.0
    restored: bool = False           # in flight across a snapshot restore
    # ---- paged engine (serve/paging.py) ----
    # committed prefill positions; > 0 marks a mid-prefill (chunked) slot
    prefill_pos: int = 0
    # evicted by an out-of-blocks decode step; resumes by re-prefilling
    # prompt ++ generated[:-1] with the decode state saved here
    preempted: bool = False
    resume_gen_state: Optional[torch.Tensor] = None   # the slot's generator
    resume_remaining: int = 0                         # decode budget left

    @property
    def prompt_len(self) -> int:
        return self.request.prompt_len

    @property
    def stop_set(self) -> frozenset:
        return self.request.stop_set

    @property
    def deadline_t(self) -> Optional[float]:
        if self.request.deadline_s is None:
            return None
        return self.submit_t + self.request.deadline_s

    def expired(self, now: Optional[float] = None) -> bool:
        dl = self.deadline_t
        if dl is None:
            return False
        return (time.perf_counter() if now is None else now) > dl

    def clone(self) -> "TrackedRequest":
        """A copy for a snapshot: the frozen request shared, the lists and
        the saved generator state copied, so the live record cannot
        change the snapshot's."""
        state = self.resume_gen_state
        return dataclasses.replace(
            self, generated=list(self.generated), logprobs=list(self.logprobs),
            resume_gen_state=None if state is None else state.clone())


class Scheduler:
    def __init__(self, num_slots: int, max_queue: int = 256):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.num_slots = num_slots
        self.max_queue = max_queue
        self.queue: Deque[TrackedRequest] = deque()
        self.slots: List[Optional[TrackedRequest]] = [None] * num_slots
        self._uid = 0

    def next_uid(self) -> int:
        """Allocate a uid without enqueueing (rejections get one too)."""
        self._uid += 1
        return self._uid

    def submit(self, request: GenerationRequest) -> int:
        if len(self.queue) >= self.max_queue:
            raise QueueFull(f"scheduler queue is at max_queue={self.max_queue}")
        uid = self.next_uid()
        self.queue.append(TrackedRequest(uid, request))
        return uid

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def admit(self, can_admit: Optional[Callable[[TrackedRequest], bool]]
              = None) -> List[int]:
        """Move queued requests into free slots, earliest deadline first
        (no-deadline requests behind, FIFO among themselves; a preempted
        request re-enters at the queue's head). ``can_admit`` (the paged
        engine's block budget) gates each candidate, and admission stops
        at the first refusal: no smaller request bypasses a large one.
        Returns the slots to prefill."""
        admitted = []
        for i in self.free_slots():
            if not self.queue:
                break
            best = min(range(len(self.queue)), key=lambda j: (
                self.queue[j].deadline_t if self.queue[j].deadline_t
                is not None else float("inf"), j))
            tr = self.queue[best]
            if can_admit is not None and not can_admit(tr):
                break
            del self.queue[best]
            self.slots[i] = tr
            admitted.append(i)
        return admitted

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def prune_queue(self, predicate) -> List[TrackedRequest]:
        """Remove (and return) queued requests matching ``predicate``."""
        kept: Deque[TrackedRequest] = deque()
        removed: List[TrackedRequest] = []
        for tr in self.queue:
            (removed if predicate(tr) else kept).append(tr)
        self.queue = kept
        return removed

    def drain_queue(self) -> List[TrackedRequest]:
        """Empty the queue and return what it held (the circuit breaker
        rejects it)."""
        out = list(self.queue)
        self.queue.clear()
        return out

    @property
    def last_uid(self) -> int:
        """The highest uid handed out (uids are dense from 1)."""
        return self._uid

    def restore_state(self, uid_counter: int, queue, slots) -> None:
        """Adopt a snapshot's queue and slots (clones of them)."""
        if len(slots) != self.num_slots:
            raise ValueError(
                f"snapshot has {len(slots)} slots, engine has "
                f"{self.num_slots}")
        self._uid = uid_counter
        self.queue = deque(tr.clone() for tr in queue)
        self.slots = [tr.clone() if tr is not None else None for tr in slots]

    def finish(self, slot: int) -> TrackedRequest:
        r = self.slots[slot]
        if r is None:
            raise ValueError(f"slot {slot} is free")
        self.slots[slot] = None
        return r

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active_slots()
