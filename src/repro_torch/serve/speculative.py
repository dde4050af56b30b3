"""Self-drafting speculative decoding (``repro/serve/speculative.py``).

One engine decode step proposes K draft tokens a slot from a per-slot
successor table, feeds ``[t0, d1..dK]`` through ONE ``model.decode``
call (each cache appends all K + 1 rows), samples every logit row as the
non-speculative engine would sample K + 1 consecutive steps, and keeps
the longest prefix the acceptance rule proves equal to what that engine
would have emitted.

Why the streams are the same. Logit row j of the window is conditioned
on ``[context, t0, d1..dj]``, so it is the baseline's step-(j+1) row iff
every draft before it matched the baseline's emission. Row j is sampled
as the baseline samples (argmax for a greedy slot; for a sampled slot
one Gumbel-max draw from the slot's generator, rows in order, one draw
a row); the emit mask keeps the rows whose conditioning matched, plus
the first mismatch row, whose sample is the baseline's correction. Each
sampled slot's generator is then set back to its state after e draws,
e the tokens it emitted, so the next step goes on with the baseline's
stream: a slot's stream still depends only on its seed and the tokens
it has emitted. Acceptance is by token equality, so this holds for
greedy and sampled slots alike.

Rejected drafts are rolled back without a new graph: the model wrote
K + 1 cache rows and advanced every ``len`` leaf by K + 1, and
``truncate_cache_len`` adds ``e - (K + 1)`` in place. Rows past ``len``
are invisible to the attention mask and are overwritten by the next
step's writes.

The drafter is prompt-lookup self-drafting (no second model): a (B, V)
int32 successor table, token -> the token that last followed it in the
slot's own stream, primed from the prompt at activation and updated from
the emitted transitions. -1 means "never seen": the draft chain stops,
and the rows past it verify nothing.

The reference's ``spec_decode_step`` is one jitted function; here it is
two, as the engine's non-speculative step is split:

  ``verify_logits``  the graph part (captured once as a CUDA graph):
                     drafts from the successor table, the feed, the
                     positions and the model's decode, through the
                     (B, K + 1, vocab) fp32 logits;
  ``settle_window``  the eager part: ``sample_window`` with the per-slot
                     generators, ``accept_window``, the ``len`` rollback
                     and the successor update, in place on the device;
                     ``rollback_generators`` then sets each sampled
                     slot's generator once the emitted counts are read
                     back.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve import api


def prime_successors(succ: np.ndarray, slot: int, tokens) -> None:
    """(Re)prime row ``slot`` of the host array ``succ`` (B, V) from a
    token history (prompt and any emitted tokens): ``succ[slot, t_i] =
    t_{i+1}``, later transitions winning (numpy applies a fancy-index
    assignment's repeated targets in order)."""
    toks = np.asarray(tokens, np.int64).ravel()
    vocab = succ.shape[1]
    succ[slot, :] = -1
    if toks.size < 2:
        return
    src, dst = toks[:-1], toks[1:]
    ok = (src >= 0) & (src < vocab) & (dst >= 0) & (dst < vocab)
    succ[slot, src[ok]] = dst[ok].astype(np.int32)


def propose_drafts(succ: torch.Tensor, last_token: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Chain ``k`` successor lookups from each slot's last token: succ
    (B, V) int32, last_token (B,) -> drafts (B, k) int32, -1 past the
    end of the known chain."""
    vocab = succ.shape[1]
    tok = last_token.to(succ.dtype)
    chain = []
    for _ in range(k):
        nxt = torch.gather(succ, 1, tok.clamp(0, vocab - 1).long()[:, None])[:, 0]
        tok = torch.where(tok >= 0, nxt, -1)
        chain.append(tok)
    if not chain:
        return succ.new_zeros((succ.shape[0], 0))
    return torch.stack(chain, dim=1)


def update_successors(succ: torch.Tensor, prevs: torch.Tensor,
                      nexts: torch.Tensor, emit: torch.Tensor) -> torch.Tensor:
    """Record the emitted transitions ``prevs[:, j] -> nexts[:, j]`` for
    every j with ``emit[:, j]`` into ``succ`` in place, j in order, so
    the latest transition of a window wins as in the host priming.
    Returns ``succ``. Each j writes one entry a row, so no write has a
    duplicate target."""
    B, S = prevs.shape
    vocab = succ.shape[1]
    rows = torch.arange(B, device=succ.device)
    for j in range(S):
        pv = prevs[:, j].clamp(0, vocab - 1).long()
        succ[rows, pv] = torch.where(emit[:, j], nexts[:, j].to(succ.dtype),
                                     succ[rows, pv])
    return succ


def truncate_cache_len(caches: Any, delta: torch.Tensor) -> Any:
    """Add ``delta`` (B,) to every ``len`` leaf of a cache tree in place
    (batch on the leaf's last axis: (L, B) for the stacked layers): the
    rejected drafts' rollback. Trees without ``len`` leaves pass
    through; block tables are never changed. Returns ``caches``."""
    if isinstance(caches, dict):
        for key, val in caches.items():
            if key == "len" and isinstance(val, torch.Tensor):
                val.add_(delta.to(val.dtype).reshape(
                    (1,) * (val.dim() - 1) + (-1,)))
            else:
                truncate_cache_len(val, delta)
    return caches


def sample_window(logits: torch.Tensor,
                  generators: Sequence[Optional[torch.Generator]],
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, greedy: Sequence[bool]
                  ) -> Tuple[torch.Tensor, torch.Tensor, List[Optional[list]]]:
    """Sample each of the S logit rows (B, S, V) as the baseline samples S
    consecutive steps: the argmax for greedy slots; for each sampled slot
    one draw a row, rows in order, from its own generator
    (``api.sample_tokens``: one ``rand(V)`` a row, so the draws are the
    baseline's bit for bit). Returns (tokens (B, S) int32, logprobs (B,
    S) fp32, states): ``states[b]`` is None for a greedy slot, else slot
    b's generator state before the window and after each row (S + 1
    states)."""
    B, S, V = logits.shape
    lf = logits.float()
    toks = torch.argmax(lf, dim=-1).to(torch.int32)
    sampled = [b for b, g in enumerate(greedy) if not g]
    states: List[Optional[list]] = [None] * B
    if sampled:
        for b in sampled:
            states[b] = [generators[b].get_state()]
        for j in range(S):
            toks[:, j] = api.sample_tokens(lf[:, j], generators, temperature,
                                           top_k, top_p, greedy)
            for b in sampled:
                states[b].append(generators[b].get_state())
    lps = api.token_logprobs(lf.reshape(B * S, V), toks.reshape(-1))
    return toks, lps.reshape(B, S), states


def accept_window(toks: torch.Tensor, drafts: torch.Tensor,
                  finite: torch.Tensor, stop_ids: torch.Tensor,
                  remaining: torch.Tensor, active: torch.Tensor,
                  spec_on: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """The acceptance rule. Every conjunct of the emit mask is monotone
    non-increasing in j, so the mask is a prefix and ``e = sum(emit)``.
    Emission j (the sample of row j) is kept iff every draft before it
    matched its row's sample, no earlier emission was a stop token, rows
    0..j are finite (a non-finite row 0 marks the slot bad), j <
    remaining, and j == 0 or the slot speculates.

    Returns (emit (B, S) bool, e (B,) int32, accepted (B,) int32 drafts
    kept, done (B,) bool, bad (B,) bool)."""
    B, S = toks.shape
    K = S - 1
    dev = toks.device
    bad = active & ~finite[:, 0]
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    match = drafts == toks[:, :K]
    prefix = torch.cat([ones, torch.cumsum((~match).int(), dim=1) == 0], dim=1)
    hit_stop = (toks[..., None] == stop_ids[:, None, :]).any(dim=-1)
    nostop_before = torch.cat(
        [ones, torch.cumsum(hit_stop[:, :K].int(), dim=1) == 0], dim=1)
    finite_prefix = torch.cumsum((~finite).int(), dim=1) == 0
    j = torch.arange(S, device=dev)[None, :]
    emit = (prefix & nostop_before & finite_prefix & (j < remaining[:, None])
            & (spec_on[:, None] | (j == 0)) & active[:, None] & ~bad[:, None])
    e = emit.sum(dim=1).to(torch.int32)
    accepted = (emit[:, :K] & match).sum(dim=1).to(torch.int32)
    last = (e - 1).clamp(0, S - 1).long()
    stop_last = torch.gather(hit_stop, 1, last[:, None])[:, 0]
    done = active & ~bad & (e > 0) & (stop_last | (e >= remaining))
    return emit, e, accepted, done, bad


def verify_logits(model, params, caches, succ: torch.Tensor,
                  tokens: torch.Tensor, positions: torch.Tensor, rc, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The graph part of a speculative step: ``k`` drafts a slot from the
    successor table, the feed ``[t0, d1..dk]`` (drafts clipped into the
    vocabulary) at positions ``p .. p + k``, and one ``model.decode``
    over it, which writes k + 1 rows into ``caches`` in place. tokens,
    positions (B, 1) int32. Returns (fp32 logits (B, k + 1, vocab), the
    window (B, k + 1) int32: t0 and the unclipped drafts)."""
    vocab = model.cfg.vocab_size
    t0 = tokens[:, 0]
    window = torch.cat([t0[:, None].to(torch.int32),
                        propose_drafts(succ, t0, k)], dim=1)
    pos = positions + torch.arange(k + 1, dtype=positions.dtype,
                                   device=positions.device)[None, :]
    logits, _ = model.decode(params, window.clamp(0, vocab - 1), pos, caches,
                             rc)
    return logits[:, :, :vocab], window


def settle_window(logits: torch.Tensor, window: torch.Tensor, caches: Any,
                  succ: torch.Tensor, *,
                  generators: Sequence[Optional[torch.Generator]],
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, greedy: Sequence[bool],
                  stop_ids: torch.Tensor, remaining: torch.Tensor,
                  active: torch.Tensor, spec_on: torch.Tensor
                  ) -> Tuple[Any, ...]:
    """The eager part of a speculative step, on ``verify_logits``'s
    outputs: sample the rows, apply the acceptance rule, roll every
    ``len`` leaf of ``caches`` back to the emitted tokens and record the
    emitted transitions in ``succ``, both in place.

    Returns (tokens (B, S) int32, 0 where not emitted; logprobs (B, S);
    e (B,) emitted counts; accepted (B,) drafts kept; done; bad; the
    generator states of ``sample_window``), all but the states on the
    device: the caller reads them back once, then calls
    ``rollback_generators``."""
    S = logits.shape[1]
    finite = torch.isfinite(logits).all(dim=-1)
    toks, lps, states = sample_window(logits, generators, temperature, top_k,
                                      top_p, greedy)
    emit, e, accepted, done, bad = accept_window(
        toks, window[:, 1:], finite, stop_ids, remaining, active, spec_on)
    truncate_cache_len(caches, e - S)
    prevs = torch.cat([window[:, :1], toks[:, :S - 1]], dim=1)
    update_successors(succ, prevs, toks, emit)
    return (torch.where(emit, toks, 0), lps, e, accepted, done, bad, states)


def rollback_generators(generators: Sequence[Optional[torch.Generator]],
                        states: Sequence[Optional[list]],
                        emitted: np.ndarray) -> None:
    """Set each sampled slot's generator to its state after ``emitted[b]``
    draws (the state before the window when it emitted nothing): where
    the baseline's generator is after emitting as many tokens."""
    for b, st in enumerate(states):
        if st is not None:
            generators[b].set_state(st[int(emitted[b])])
