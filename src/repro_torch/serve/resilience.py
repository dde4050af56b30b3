"""Serving fault tolerance (``repro/serve/resilience.py``): scripted fault
injection, the numerics circuit breaker, engine snapshots and the serve
restart controller. The engine (``serve/engine.py``) imports this module,
never the other way round.

  FaultPlan / FaultSpec : a seedable, scripted fault schedule handed to
        the engine through ``EngineConfig.fault_plan``. A spec fires at a
        named engine boundary (``BOUNDARIES``) from a scripted tick on,
        optionally for one request uid, ``times`` polls in all. A plan is
        stateful: share one instance across engine restarts, or a one-shot
        fault fires again in every new engine.
  InjectedFault         : what a scripted raise-fault throws.
  CircuitBreaker        : ``k`` consecutive poisoned engine steps trip it;
        the engine then rejects its queue and refuses new submits.
  EngineSnapshot        : the engine's state on the host. The arrays (every
        cache leaf, the per-slot sampling and stopping state, each slot's
        ``torch.Generator`` state) are path-flattened in the checkpoint
        format of ``checkpoint/manager.py``, so ``save_snapshot`` persists
        them with a ``CheckpointManager``; the request bookkeeping is
        copied Python. Nothing in a snapshot aliases the live engine.
  serve_with_restarts   : drive an engine to idle, snapshotting between
        ticks; when ``step()`` raises, build a fresh engine, restore the
        last snapshot and go on.

Where the reference keeps each slot's PRNG key (``rng_keys``), the port
keeps the state of the slot's generator: ``get_state()`` as a uint8
array, none for a free or greedy slot.
"""
from __future__ import annotations

import dataclasses
import gc
import logging
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

# the engine boundaries a FaultSpec fires at:
#   prefill : raise InjectedFault in place of a request's prefill call
#   decode  : raise InjectedFault before the batched decode step
#   sample  : raise InjectedFault after the decode step's readback, before
#             the host's bookkeeping (a torn state: only a snapshot
#             restore recovers it)
#   poison  : add NaN or Inf ("mode") to one slot's logits before sampling
#             (the numerics quarantine)
#   backend : quarantine a planned backend as if it had failed, and re-plan
#             (core/plan.py's quarantine)
BOUNDARIES = ("prefill", "decode", "sample", "poison", "backend")
POISON_MODES = ("nan", "inf")


class InjectedFault(RuntimeError):
    """A scripted fault fired by a FaultPlan at an engine boundary."""

    def __init__(self, boundary: str, tick: int, uid: Optional[int] = None):
        self.boundary = boundary
        self.tick = tick
        self.uid = uid
        at = f" uid={uid}" if uid is not None else ""
        super().__init__(f"injected {boundary} fault at tick {tick}{at}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault.

    ``tick``    : the first engine tick (0-based count of ``step()``) it
                  is armed at: it fires at the first matching poll with
                  ``tick >= spec.tick``, ``times`` polls in all;
    ``uid``     : the request it targets (None: any request);
    ``mode``    : the poison, "nan" or "inf" (poison boundary only);
    ``backend`` : the backend to fail (backend boundary; None: the
                  decode plan's)."""

    boundary: str
    tick: int
    uid: Optional[int] = None
    mode: str = "nan"
    times: int = 1
    backend: Optional[str] = None

    def __post_init__(self):
        if self.boundary not in BOUNDARIES:
            raise ValueError(
                f"unknown fault boundary {self.boundary!r}; expected one of "
                f"{BOUNDARIES}")
        if self.mode not in POISON_MODES:
            raise ValueError(
                f"unknown poison mode {self.mode!r}; expected one of "
                f"{POISON_MODES}")
        if self.tick < 0 or self.times < 1:
            raise ValueError(
                f"tick must be >= 0 and times >= 1, got tick={self.tick} "
                f"times={self.times}")


class FaultPlan:
    """A deterministic, stateful schedule of FaultSpecs. A poll fires the
    first spec whose boundary matches, whose tick has come, whose
    ``times`` are not used up and whose uid matches (a spec's uid None
    matches any poll, a poll's uid None any spec). The engine polls in a
    fixed order, so a trace of requests fires the same faults every
    run."""

    def __init__(self, faults: Iterable[FaultSpec] = ()):
        self.faults: Tuple[FaultSpec, ...] = tuple(faults)
        self._fired = [0] * len(self.faults)

    @classmethod
    def scripted(cls, *faults: FaultSpec) -> "FaultPlan":
        return cls(faults)

    @classmethod
    def seeded(cls, seed: int, *, boundaries: Sequence[str] = BOUNDARIES,
               n_faults: int = 3, max_tick: int = 8,
               uids: Sequence[int] = ()) -> "FaultPlan":
        """A pseudo-random plan from ``seed``: the same seed gives the same
        specs (the reference's draws from ``np.random.default_rng``, in
        the same order)."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(n_faults):
            boundary = boundaries[int(rng.integers(len(boundaries)))]
            uid = (int(rng.choice(np.asarray(uids)))
                   if len(uids) and boundary in ("poison", "prefill") else None)
            specs.append(FaultSpec(
                boundary=boundary, tick=int(rng.integers(max_tick)),
                uid=uid, mode=POISON_MODES[int(rng.integers(2))]))
        return cls(specs)

    def poll(self, boundary: str, tick: int,
             uid: Optional[int] = None) -> Optional[FaultSpec]:
        """Fire and consume the first matching spec (None if none
        matches)."""
        for i, spec in enumerate(self.faults):
            if spec.boundary != boundary or tick < spec.tick:
                continue
            if self._fired[i] >= spec.times:
                continue
            if spec.uid is not None and uid is not None and spec.uid != uid:
                continue
            self._fired[i] += 1
            log.warning("fault plan fired: %s (tick=%d uid=%s, %d/%d)",
                        spec.boundary, tick, uid, self._fired[i], spec.times)
            return spec
        return None

    @property
    def exhausted(self) -> bool:
        return all(f >= s.times for f, s in zip(self._fired, self.faults))


class CircuitBreaker:
    """Trips after ``k`` consecutive poisoned engine steps. One poisoned
    slot is the request's error; ``k`` poisoned steps in a row mean the
    model or the card emits garbage, and the engine stops taking work."""

    def __init__(self, k: int = 3):
        if k < 1:
            raise ValueError(f"breaker threshold k must be >= 1, got {k}")
        self.k = k
        self.consecutive = 0
        self.tripped = False

    def record(self, poisoned: bool) -> bool:
        """Record one engine step; returns whether the breaker is tripped.
        A clean step resets the count."""
        if not self.tripped:
            self.consecutive = self.consecutive + 1 if poisoned else 0
            if self.consecutive >= self.k:
                self.tripped = True
                log.error("circuit breaker tripped: %d consecutive poisoned "
                          "steps", self.consecutive)
        return self.tripped

    def state(self) -> Tuple[int, int, bool]:
        return (self.k, self.consecutive, self.tripped)

    def restore(self, state: Tuple[int, int, bool]) -> None:
        self.k, self.consecutive, self.tripped = state


@dataclasses.dataclass
class EngineSnapshot:
    """The engine's state on the host (``Engine.snapshot()``).

    ``arrays``: path -> numpy array (None for an absent leaf), in the
    checkpoint format: ``/caches/...`` every cache leaf (a bf16 leaf as
    its bits in a 2-byte void array, as checkpoints store it),
    ``/slots/...`` the per-slot state, each slot's generator state
    included, and under ``speculate_k`` the successor table and opt-in
    flags. The request bookkeeping is copied."""

    tick: int
    arrays: Dict[str, Optional[np.ndarray]]
    uid_counter: int
    queue: List[Any]                  # TrackedRequest clones, in order
    slots: List[Optional[Any]]        # TrackedRequest clones by slot
    outputs: Dict[int, Any]           # uid -> RequestOutput (frozen)
    buffers: Dict[int, List[Any]]     # uid -> undrained StreamEvents
    pending: List[Any]
    retired: List[int]
    metrics: Dict[str, Any]
    breaker: Tuple[int, int, bool]
    num_slots: int
    max_len: int
    # the paged engine's host state (the arenas and device tables are
    # cache leaves)
    paged: bool = False
    block_size: int = 0
    num_blocks: int = 0
    block_tables: Optional[np.ndarray] = None      # (num_slots, W)
    pool_free: Optional[Tuple[int, ...]] = None    # BlockPool free list
    owned: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def nbytes(self) -> int:
        """Bytes of the array state."""
        return sum(a.nbytes for a in self.arrays.values() if a is not None)

    def checkpoint_state(self) -> Dict[str, Any]:
        """The array state as one CheckpointManager group (the Python
        bookkeeping is not persisted)."""
        return {"engine_arrays": dict(self.arrays)}


def save_snapshot(snapshot: EngineSnapshot, manager: Any, step: int) -> None:
    """Persist the snapshot's arrays through a CheckpointManager."""
    manager.save(step, snapshot.checkpoint_state(), block=True)


def load_snapshot_arrays(manager: Any,
                         step: Optional[int] = None
                         ) -> Dict[str, np.ndarray]:
    """A persisted snapshot's arrays, under the keys of
    ``EngineSnapshot.arrays`` (the restored group is nested by path
    segment, so it is flattened again), as the snapshot holds them. The
    group is restored as it is on disk: a cache's ``"groups"`` and
    ``"trail"`` (RecurrentGemma's) are leaves, not param stacks."""
    from repro_torch.checkpoint import manager as ckpt_manager

    _, state = manager.restore(step, device="cpu", unstack=False)
    flat = ckpt_manager.flatten_with_paths(state["engine_arrays"])
    return {path: ckpt_manager.to_host(leaf) for path, leaf in flat
            if leaf is not None}


@dataclasses.dataclass
class ServeRestartStats:
    """What the restart controller did. ``failures`` holds
    ``"<exception type>: <message>"`` for each crash."""

    restarts: int = 0
    snapshots: int = 0
    resumed_tick: int = 0
    failures: List[str] = dataclasses.field(default_factory=list)


def serve_with_restarts(
    engine_factory: Callable[[], Any],
    requests: Sequence[Any],
    *,
    max_restarts: int = 3,
    snapshot_every: int = 1,
) -> Tuple[Any, Dict[int, Any], ServeRestartStats]:
    """Serve ``requests`` to completion under checkpoint-restart: submit
    them all, then step to idle with a snapshot every ``snapshot_every``
    ticks. When ``step()`` raises (anything), the engine is dropped, a
    fresh one from ``engine_factory`` restores the last snapshot and
    serves on; the crashed tick's events were never delivered, so with
    ``snapshot_every=1`` no event is delivered twice. The old engine is
    released before the new one is built, so two engines never hold the
    card's memory at once. Pass the same FaultPlan to every engine the
    factory builds.

    Returns ``(engine, {uid: RequestOutput}, stats)``; RuntimeError past
    ``max_restarts``."""
    if snapshot_every < 1:
        raise ValueError(f"snapshot_every must be >= 1, got {snapshot_every}")
    stats = ServeRestartStats()
    eng = engine_factory()
    uids = [eng.submit(r) for r in requests]
    snap = eng.snapshot()
    stats.snapshots += 1
    since_snapshot = 0
    while not eng.idle:
        try:
            eng.step()
        except Exception as e:  # noqa: BLE001 - the controller catches anything
            stats.restarts += 1
            stats.failures.append(f"{type(e).__name__}: {e}")
            if stats.restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} serve restarts; last: {e}"
                ) from e
            log.warning("engine step crashed (%s); restoring tick-%d "
                        "snapshot (restart %d/%d)", e, snap.tick,
                        stats.restarts, max_restarts)
            crashed = True
        else:
            crashed = False
        if crashed:
            # outside the handler: the exception's frames hold the engine
            eng = None
            gc.collect()
            eng = engine_factory()
            eng.restore(snap)
            stats.resumed_tick = snap.tick
            since_snapshot = 0
            continue
        since_snapshot += 1
        if since_snapshot >= snapshot_every:
            snap = eng.snapshot()
            stats.snapshots += 1
            since_snapshot = 0
    outputs = {uid: eng.output(uid) for uid in uids}
    return eng, outputs, stats
