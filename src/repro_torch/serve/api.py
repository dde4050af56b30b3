"""Typed request-level serving surface (``repro/serve/api.py``).

  SamplingParams     : greedy, or temperature + top-k + top-p, seeded.
  GenerationRequest  : prompt + budget + sampling + stop ids + deadline.
  StreamEvent        : one incremental token (or a terminal event).
  RequestOutput      : the terminal record with per-request timing.

It also owns the batched sampling/stopping math of the decode step.
Greedy rows take the exact argmax of the fp32 logits. A sampled row
draws with the Gumbel-max trick from its slot's own ``torch.Generator``,
seeded from ``SamplingParams.seed`` at admission, so a slot's stream
depends only on its seed and step count. These are NOT the reference's
``jax.random`` threefry bits: seeded sampled streams differ from the JAX
engine's (greedy streams are identical).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# "error": the request's own logits went non-finite (the numerics
# quarantine); "*-after-restore": the request was in flight when the
# engine was restored from a snapshot (serve/resilience.py), its stream
# the uninterrupted one
FINISH_REASONS = ("stop", "length", "rejected", "error", "timeout",
                  "stop-after-restore", "length-after-restore")



class RequestEvicted(KeyError):
    """Raised by ``Engine.stream()`` for a uid that was served but whose
    output and events were evicted past ``EngineConfig.max_retained``;
    a uid never handed out raises a plain KeyError."""


# width of the per-slot stop-token set (eos_ids + stop_token_ids, padded
# with -1); a request needing more raises at submit
MAX_STOP_IDS = 8


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding strategy. ``greedy=True`` is exact argmax;
    otherwise softmax(logits / temperature) restricted to the top_k
    tokens (0 disables) and the top_p nucleus (1.0 disables), drawn from
    a generator seeded with ``seed``. ``logprobs=True`` reports the
    chosen token's log-probability under the unscaled logits."""

    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    logprobs: bool = False

    def __post_init__(self):
        if not self.greedy and self.temperature <= 0.0:
            raise ValueError(
                f"temperature must be > 0 when sampling, got {self.temperature}")
        if isinstance(self.top_k, bool) or not isinstance(self.top_k, int) \
                or self.top_k < 0:
            raise ValueError(f"top_k must be an int >= 0, got {self.top_k!r}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()


@dataclasses.dataclass(frozen=True, eq=False)
class GenerationRequest:
    """One generation request. ``eos_ids``/``stop_token_ids`` finish it
    with "stop" the step the token is emitted (it is included);
    ``max_new_tokens`` finishes it with "length"; ``deadline_s`` (from
    submit) with "timeout". ``speculate=False`` opts it out of
    speculative decoding on an engine with ``speculate_k > 0``: its slot
    emits at most one token a step (data: the batch still runs the one
    multi-token step), and its stream is the same either way."""

    prompt: np.ndarray
    max_new_tokens: int = 16
    sampling: SamplingParams = GREEDY
    eos_ids: Tuple[int, ...] = ()
    stop_token_ids: Tuple[int, ...] = ()
    deadline_s: Optional[float] = None
    speculate: bool = True

    def __post_init__(self):
        prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        object.__setattr__(self, "prompt", prompt)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        object.__setattr__(self, "eos_ids", tuple(int(t) for t in self.eos_ids))
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(
                f"deadline_s must be None or >= 0, got {self.deadline_s}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def stop_set(self) -> frozenset:
        return frozenset(self.eos_ids) | frozenset(self.stop_token_ids)


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One engine event: a token at ``index`` of the generated stream;
    the terminal event also sets ``finish_reason`` (a rejection is a
    tokenless terminal event with index -1)."""

    uid: int
    index: int
    token: Optional[int]
    finish_reason: Optional[str] = None
    logprob: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Terminal record: tokens, finish reason and timing (queue wait,
    prefill wall time, decode wall time)."""

    uid: int
    tokens: Tuple[int, ...]
    finish_reason: str
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    logprobs: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.finish_reason not in FINISH_REASONS:
            raise ValueError(
                f"finish_reason must be one of {FINISH_REASONS}, "
                f"got {self.finish_reason!r}")

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)

    @property
    def decode_tokens_per_s(self) -> float:
        decode_tokens = max(len(self.tokens) - 1, 0)
        if decode_tokens == 0 or self.decode_s <= 0.0:
            return 0.0
        return decode_tokens / self.decode_s


# ---------------------------------------------------------------------------
# Prefill length bucketing
# ---------------------------------------------------------------------------


def prefill_buckets(max_len: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Power-of-two prompt-length buckets up to (and including) max_len."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    out: List[int] = []
    b = min(min_bucket, max_len)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(prompt_len: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket holding ``prompt_len`` (ValueError past the last)."""
    for b in buckets:
        if prompt_len <= b:
            return b
    raise ValueError(
        f"prompt length {prompt_len} exceeds the largest bucket {buckets[-1]}")


# ---------------------------------------------------------------------------
# Batched sampling / stopping
# ---------------------------------------------------------------------------


def _top_k_top_p_mask(scaled: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor) -> torch.Tensor:
    """Keep-mask over temperature-scaled logits (B, V) under per-row
    top_k (0 = disabled) and top_p (1.0 = disabled)."""
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, top_k.clamp(1, V), torch.full_like(top_k, V))
    kth = torch.gather(sorted_desc, 1, (k_eff - 1).long()[:, None])
    keep = scaled >= kth
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    thr = torch.where(keep_sorted, sorted_desc,
                      torch.full_like(sorted_desc, float("inf"))).amin(dim=-1)
    return keep & (scaled >= thr[:, None])


def sample_tokens(logits: torch.Tensor,
                  generators: Sequence[Optional[torch.Generator]],
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, greedy: Sequence[bool]) -> torch.Tensor:
    """Per-row tokens (B,) int32: argmax of the unscaled logits for greedy
    rows; for the others one Gumbel-max draw from the row's generator
    over the top-k/top-p masked, temperature-scaled distribution."""
    lf = logits.float()
    tok = torch.argmax(lf, dim=-1).to(torch.int32)
    rows = [b for b, g in enumerate(greedy) if not g]
    if not rows:
        return tok
    sel = torch.tensor(rows, device=lf.device)
    temp = torch.clamp(temperature[sel].float(), min=1e-6)[:, None]
    scaled = lf[sel] / temp
    keep = _top_k_top_p_mask(scaled, top_k[sel], top_p[sel].float())
    masked = torch.where(keep, scaled, torch.full_like(scaled, float("-inf")))
    noise = torch.stack([
        torch.rand(lf.shape[-1], generator=generators[b], device=lf.device)
        for b in rows])
    gumbel = -torch.log(-torch.log(noise))
    tok[sel] = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return tok


def token_logprobs(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Log-probability of ``tok`` under softmax of the unscaled logits."""
    lf = logits.float()
    gold = torch.gather(lf, 1, tok.long()[:, None])[:, 0]
    return gold - torch.logsumexp(lf, dim=-1)


def sample_and_stop(logits: torch.Tensor, *,
                    generators: Sequence[Optional[torch.Generator]],
                    temperature: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor, greedy: Sequence[bool],
                    stop_ids: torch.Tensor, remaining: torch.Tensor,
                    active: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decode epilogue: (next_tok, done, bad). ``done`` marks a lane
    that emitted a stop id or exhausted its budget; ``bad`` an active
    lane whose logits hold a NaN/Inf (its token is never emitted).
    Inactive lanes emit token 0, not done, not bad."""
    tok = sample_tokens(logits, generators, temperature, top_k, top_p, greedy)
    bad = active & ~torch.isfinite(logits.float()).all(dim=-1)
    hit_stop = (tok[:, None] == stop_ids).any(dim=-1)
    done = active & ~bad & (hit_stop | (remaining <= 1))
    return torch.where(active, tok, torch.zeros_like(tok)), done, bad
