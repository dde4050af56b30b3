"""Engine counters (``repro/serve/metrics.py``). Invariants the tests pin:

  tokens_generated == prefills + decode_slot_steps - poisoned_slot_steps
                      + extra_decode_tokens
                   == number of token-bearing StreamEvents
  finished         == finished_stop + finished_length + errors + timeouts
  drafted_tokens   == accepted_draft_tokens + rejected_draft_tokens

Every "error" or "timeout" terminal event counts once in ``errors`` or
``timeouts``, and every poisoned lane suppresses one token event.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

_CLOCKS = ("started_at", "first_submit_at")


@dataclasses.dataclass
class EngineMetrics:
    num_slots: int
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    finished: int = 0
    finished_stop: int = 0
    finished_length: int = 0
    errors: int = 0                  # lanes whose logits went non-finite
    timeouts: int = 0                # deadline_s expiries
    prefills: int = 0
    prefill_prompt_tokens: int = 0
    # the tokens prefill steps ran: each step's length bucket (its true
    # length where nothing is bucketed), a poisoned step's too; less
    # prefill_prompt_tokens, the padding
    prefill_bucket_tokens: int = 0
    prefill_chunks: int = 0          # chunked-prefill continuations (paged)
    preemptions: int = 0             # out-of-blocks decode evictions (paged)
    # KV memory gauges: a paged engine updates them at every block alloc
    # and free; a contiguous one sets kv_bytes_in_use (and its peak) once
    kv_bytes_in_use: int = 0
    blocks_in_use: int = 0
    blocks_free: int = 0
    peak_blocks_in_use: int = 0
    peak_kv_bytes_in_use: int = 0
    decode_steps: int = 0
    decode_slot_steps: int = 0       # active lanes summed over decode steps
    poisoned_slot_steps: int = 0
    tokens_generated: int = 0
    # speculative decoding (all zero when speculate_k == 0)
    drafted_tokens: int = 0          # K per speculating lane per decode step
    accepted_draft_tokens: int = 0   # drafts that matched the verify sample
    rejected_draft_tokens: int = 0   # drafted - accepted
    extra_decode_tokens: int = 0     # emissions beyond 1 per lane per step
    # the resilience layer (serve/resilience.py)
    backend_fallbacks: int = 0       # backends quarantined by a fault
    snapshots: int = 0
    restores: int = 0
    straggler_steps: int = 0         # decode steps the watchdog flagged
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    started_at: float = dataclasses.field(default_factory=time.perf_counter)
    first_submit_at: Optional[float] = None

    def count_submit(self) -> None:
        self.submitted += 1
        if self.first_submit_at is None:
            self.first_submit_at = time.perf_counter()

    def count_finish(self, reason: str) -> None:
        self.finished += 1
        # a request in flight across a restore counts as its base reason
        reason = reason.replace("-after-restore", "")
        if reason == "stop":
            self.finished_stop += 1
        elif reason == "length":
            self.finished_length += 1
        elif reason == "error":
            self.errors += 1
        elif reason == "timeout":
            self.timeouts += 1
        else:
            raise ValueError(
                f"not a finish reason for a served request: {reason!r}")

    @property
    def slot_occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        if self.decode_steps == 0:
            return 0.0
        return self.decode_slot_steps / (self.decode_steps * self.num_slots)

    @property
    def draft_acceptance_rate(self) -> float:
        """Share of the drafted tokens the verify pass accepted."""
        if self.drafted_tokens == 0:
            return 0.0
        return self.accepted_draft_tokens / self.drafted_tokens

    @property
    def decode_tokens_per_step(self) -> float:
        """Tokens emitted per active lane per decode step: 1.0 without
        speculation, up to K + 1 with it."""
        useful = self.decode_slot_steps - self.poisoned_slot_steps
        if useful <= 0:
            return 0.0
        return (useful + self.extra_decode_tokens) / useful

    @property
    def decode_tokens_per_s(self) -> float:
        if self.decode_s <= 0.0:
            return 0.0
        return self.decode_slot_steps / self.decode_s

    @property
    def tokens_per_s(self) -> float:
        """Tokens over the seconds since the first submit (since
        construction before one): the engine's set-up does not count."""
        t0 = (self.started_at if self.first_submit_at is None
              else self.first_submit_at)
        dt = time.perf_counter() - t0
        return self.tokens_generated / dt if dt > 0.0 else 0.0

    def state(self) -> Dict[str, float]:
        """Every counter but the wall clocks (``Engine.snapshot``)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name not in _CLOCKS}

    def restore(self, state: Dict[str, float]) -> None:
        for name, value in state.items():
            setattr(self, name, value)

    def snapshot(self) -> Dict[str, float]:
        out = self.state()
        out["uptime_s"] = time.perf_counter() - self.started_at
        out["slot_occupancy"] = self.slot_occupancy
        out["draft_acceptance_rate"] = self.draft_acceptance_rate
        out["decode_tokens_per_step"] = self.decode_tokens_per_step
        out["decode_tokens_per_s"] = self.decode_tokens_per_s
        out["tokens_per_s"] = self.tokens_per_s
        return out
