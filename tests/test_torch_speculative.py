"""Port of self-drafting speculative decoding
(``repro_torch/serve/speculative.py`` and the engine's ``speculate_k``),
held against the JAX reference (``repro/serve/speculative.py``):

  * the drafter and the acceptance rule (``prime_successors``,
    ``propose_drafts``, ``update_successors`` with repeated sources,
    ``accept_window`` on the reference's seven cases and a random batch,
    ``truncate_cache_len``) bit-equal to the JAX functions on the same
    numpy inputs;
  * the window's sampling: each row drawn as ``api.sample_tokens`` draws
    one step, and ``rollback_generators`` leaves a generator where e
    single-row draws leave it (CPU generators);
  * inside the port, speculative streams equal non-speculative ones:
    a cycling stub (fewer steps, tokens a step > 1, a stop token inside a
    draft window, the ``speculate=False`` opt-out, the metrics
    invariants, ``len`` rolled back to the committed tokens every step),
    and llama2 SMOKE at fp32 with 2-bit VQ weights: greedy over the
    contiguous, paged (parity and preempting pools) and kv_bits=4 caches,
    also with windows running past the cache's capacity, seeded sampling
    over the contiguous and paged caches, a mixed greedy/sampled batch;
    the decode step is built once;
  * greedy speculative streams equal to the JAX engine's at
    ``speculate_k=3``.

Everything here is exact: integer outputs and token streams.
"""
import dataclasses
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import quantize as jq
from repro.models import build_model as jax_build_model
from repro.models.common import RunConfig as JaxRunConfig
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve import speculative as jspec
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models import RunConfig, build_model
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams)
from repro_torch.serve import api
from repro_torch.serve import speculative as spec

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


def _stable_hash(s: str) -> int:
    """A process-independent stand-in for ``hash`` of a string."""
    return zlib.crc32(s.encode())


# ------------------------------------------------- drafter and acceptance


def _histories(rng, vocab, n):
    """Token histories with repeated sources (a small vocab), short and
    long, one of one token."""
    return [rng.integers(0, vocab, size).astype(np.int32)
            for size in (1, 2, 5, 17, 40)[:n]]


def test_prime_successors_equals_reference():
    rng = np.random.default_rng(0)
    vocab = 12
    got = np.full((5, vocab), 7, np.int32)
    want = got.copy()
    for slot, toks in enumerate(_histories(rng, vocab, 5)):
        spec.prime_successors(got, slot, toks)
        jspec.prime_successors(want, slot, toks)
    assert np.array_equal(got, want)
    # later transitions win: 3 -> 4, then 3 -> 7
    spec.prime_successors(got, 0, [3, 4, 5, 3, 7])
    assert got[0, 3] == 7 and got[0, 4] == 5 and got[0, 6] == -1


@pytest.mark.parametrize("k", [1, 3, 5])
def test_propose_drafts_equals_reference(k):
    rng = np.random.default_rng(k)
    vocab = 16
    succ = rng.integers(-1, vocab, (6, vocab)).astype(np.int32)
    last = np.array([0, 3, 15, 7, -1, 9], np.int32)
    want = np.asarray(jspec.propose_drafts(jnp.asarray(succ),
                                           jnp.asarray(last), k))
    got = spec.propose_drafts(torch.from_numpy(succ), torch.from_numpy(last), k)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_update_successors_equals_reference():
    """Repeated sources inside one window (the later transition wins) and
    masked-off transitions, against the reference's in-jit update."""
    rng = np.random.default_rng(1)
    vocab = 10
    succ = rng.integers(-1, vocab, (4, vocab)).astype(np.int32)
    prevs = np.array([[2, 5, 2, 5], [1, 1, 1, 1], [0, 9, 3, 0], [4, 4, 6, 4]],
                     np.int32)
    nexts = rng.integers(0, vocab, prevs.shape).astype(np.int32)
    emit = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0], [0, 0, 0, 0]],
                    bool)
    want = np.asarray(jspec.update_successors(
        jnp.asarray(succ), jnp.asarray(prevs), jnp.asarray(nexts),
        jnp.asarray(emit)))
    got = torch.from_numpy(succ.copy())
    out = spec.update_successors(got, torch.from_numpy(prevs),
                                 torch.from_numpy(nexts), torch.from_numpy(emit))
    assert out is got and np.array_equal(got.numpy(), want)
    # the update equals priming from the same emitted history
    host = np.full((1, 16), -1, np.int32)
    spec.prime_successors(host, 0, [2, 5, 2, 9])
    table = spec.update_successors(
        torch.full((1, 16), -1, dtype=torch.int32),
        torch.tensor([[2, 5, 2]]), torch.tensor([[5, 2, 9]]),
        torch.ones((1, 3), dtype=torch.bool))
    assert np.array_equal(table.numpy(), host)


# the reference's seven cases (tests/test_speculative.py): name, toks,
# drafts, overrides
ACCEPT_CASES = {
    "full_match_bonus": ([[7, 8, 9, 5]], [[7, 8, 9]], {}),
    "first_mismatch_correction": ([[7, 8, 9, 5]], [[7, 3, 9]], {}),
    "stop_cuts_window": ([[7, 6, 9, 5]], [[7, 6, 9]], {"stop_ids": [[6]]}),
    "budget_clips": ([[7, 8, 9, 5]], [[7, 8, 9]], {"remaining": [2]}),
    "nonfinite_row0_bad": ([[7, 8, 9, 5]], [[7, 8, 9]],
                           {"finite": [[False, True, True, True]]}),
    "nonfinite_midwindow": ([[7, 8, 9, 5]], [[7, 8, 9]],
                            {"finite": [[True, True, False, True]]}),
    "opt_out_caps_at_one": ([[7, 8, 9, 5]], [[7, 8, 9]],
                            {"spec_on": [False]}),
}


def _accept_both(toks, drafts, **kw):
    toks, drafts = np.asarray(toks, np.int32), np.asarray(drafts, np.int32)
    B, S = toks.shape
    args = {"finite": np.ones((B, S), bool),
            "stop_ids": np.full((B, 1), -1, np.int32),
            "remaining": np.full((B,), 100, np.int32),
            "active": np.ones((B,), bool), "spec_on": np.ones((B,), bool)}
    args.update({k: np.asarray(v, args[k].dtype) for k, v in kw.items()})
    want = jspec.accept_window(jnp.asarray(toks), jnp.asarray(drafts),
                               **{k: jnp.asarray(v) for k, v in args.items()})
    got = spec.accept_window(torch.from_numpy(toks), torch.from_numpy(drafts),
                             **{k: torch.from_numpy(v) for k, v in args.items()})
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", list(ACCEPT_CASES))
def test_accept_window_equals_reference(case):
    toks, drafts, kw = ACCEPT_CASES[case]
    got, want = _accept_both(toks, drafts, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), case
    emit, e = got[0], got[1]
    assert emit[0].tolist() == [j < e[0] for j in range(4)]  # a prefix


def test_accept_window_random_batch_equals_reference():
    """Random windows where drafts often match, stop ids, budgets,
    non-finite rows, inactive and opted-out slots, at K = 0 and 4."""
    rng = np.random.default_rng(3)
    for K in (0, 4):
        B, S = 64, K + 1
        toks = rng.integers(0, 4, (B, S)).astype(np.int32)
        drafts = np.where(rng.random((B, K)) < 0.7, toks[:, :K],
                          rng.integers(-1, 4, (B, K))).astype(np.int32)
        got, want = _accept_both(
            toks, drafts, finite=rng.random((B, S)) > 0.1,
            stop_ids=rng.integers(-1, 6, (B, 2)),
            remaining=rng.integers(1, 6, B), active=rng.random(B) > 0.2,
            spec_on=rng.random(B) > 0.3)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), K


def test_truncate_cache_len_equals_reference():
    caches = {"body": {"k": np.ones((2, 3, 4), np.float32),
                       "len": np.array([[5, 7, 9], [5, 7, 9]], np.int32),
                       "block_table": np.array([[1, 2]], np.int32)}}
    delta = np.array([-2, 0, -3], np.int32)
    want = jspec.truncate_cache_len(
        jax.tree_util.tree_map(jnp.asarray, caches), jnp.asarray(delta))
    got = {"body": {n: torch.from_numpy(a.copy())
                    for n, a in caches["body"].items()}}
    out = spec.truncate_cache_len(got, torch.from_numpy(delta))
    assert out is got
    for n in caches["body"]:
        assert np.array_equal(got["body"][n].numpy(),
                              np.asarray(want["body"][n])), n
    assert got["body"]["len"].tolist() == [[3, 7, 6], [3, 7, 6]]
    stub = {"state": torch.zeros((1, 2, 1))}
    assert torch.equal(spec.truncate_cache_len(stub, torch.tensor([-1, -1]))[
        "state"], torch.zeros((1, 2, 1)))


def test_sample_window_draws_as_steps_and_rolls_back():
    """Row j of a window is sampled as ``api.sample_tokens`` samples one
    step, with one draw a row from each sampled slot's generator; the
    states recorded are the generator's after 0..S draws, and
    ``rollback_generators`` leaves each generator where e steps would."""
    B, S, V = 4, 4, 50
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((B, S, V), generator=g)
    greedy = [True, False, False, True]
    temp = torch.tensor([1.0, 0.8, 1.3, 1.0])
    top_k = torch.tensor([0, 10, 0, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.9, 1.0, 1.0])
    gens = lambda: [None, torch.Generator().manual_seed(7),
                    torch.Generator().manual_seed(8), None]
    win_gens = gens()
    toks, lps, states = spec.sample_window(logits, win_gens, temp, top_k,
                                           top_p, greedy)
    step_gens = gens()
    for j in range(S):
        want = api.sample_tokens(logits[:, j], step_gens, temp, top_k, top_p,
                                 greedy)
        assert torch.equal(toks[:, j], want), j
        assert torch.equal(lps[:, j], api.token_logprobs(logits[:, j], want))
        for b in (1, 2):
            assert torch.equal(states[b][j + 1], step_gens[b].get_state())
    assert states[0] is None and states[3] is None
    e = np.array([0, 2, 0, 3], np.int32)
    spec.rollback_generators(win_gens, states, e)
    for b in (1, 2):
        fresh = gens()[b]
        for _ in range(int(e[b])):
            torch.rand(V, generator=fresh)
        assert torch.equal(win_gens[b].get_state(), fresh.get_state()), b


# ---------------------------------------------------------------- the stub


class _CyclingModel:
    """next token = (token + 1) % vocab at every position of a window of
    any width. Its decode advances ``len`` by the window, as the model's
    cache does, and checks that every active slot's ``len`` equals its
    position when the step starts (the rollback of the step before)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init_cache(self, slots, max_len, *, device):
        return {"body": {"k": torch.zeros((1, slots, max_len, 1, 1)),
                         "v": torch.zeros((1, slots, max_len, 1, 1)),
                         "len": torch.zeros((1, slots), dtype=torch.int32)}}

    def _logits(self, toks):
        return torch.nn.functional.one_hot(
            (toks.long() + 1) % self.cfg.vocab_size, self.cfg.vocab_size).float()

    def prefill(self, params, batch, rc):
        S = batch["tokens"].shape[1]
        return self._logits(batch["tokens"]), {"body": {
            "k": torch.zeros((1, 1, S, 1, 1)), "v": torch.zeros((1, 1, S, 1, 1)),
            "len": torch.full((1, 1), S, dtype=torch.int32)}}

    def decode(self, params, tokens, positions, caches, rc):
        ln = caches["body"]["len"]
        live = positions[:, 0] > 0
        assert torch.equal(ln[0][live], positions[live, 0])
        ln += tokens.shape[1]
        return self._logits(tokens), caches


PROMPTS = [[3, 4, 5], [1, 2], [0, 1, 2, 3]]


def _stub_run(spec_k, max_new=16, stop=(), speculate=True, vocab=8):
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), vocab_size=vocab)
    eng = Engine(_CyclingModel(cfg), {}, RunConfig(),
                 EngineConfig(num_slots=2, max_len=64, speculate_k=spec_k),
                 device="cpu")
    uids = [eng.submit(GenerationRequest(
        prompt=np.asarray(p, np.int32), max_new_tokens=max_new,
        stop_token_ids=stop, speculate=speculate)) for p in PROMPTS]
    events = []
    while not eng.idle:
        events.extend(eng.step())
        assert len(events) < 500
    return {u: list(eng.output(u).tokens) for u in uids}, eng, events


def test_stub_streams_identical_in_fewer_steps():
    base, be, _ = _stub_run(0)
    got, eng, _ = _stub_run(3)
    assert got == base
    m, mb = eng.metrics(), be.metrics()
    # the cycle is learnt once the table has seen it: speculation then
    # emits K + 1 tokens a step
    assert m["decode_steps"] < mb["decode_steps"]
    assert m["decode_tokens_per_step"] > 1.0 == mb["decode_tokens_per_step"]
    assert m["accepted_draft_tokens"] > 0 and m["draft_acceptance_rate"] > 0
    assert eng.trace_counts["decode"] == 1


def test_stub_stop_token_inside_a_draft_window():
    base, _, _ = _stub_run(0, stop=(6,))
    got, eng, events = _stub_run(3, stop=(6,))
    assert got == base
    for toks in got.values():
        assert toks[-1] == 6 and 6 not in toks[:-1]
    assert eng.metrics()["finished_stop"] == len(PROMPTS)
    done = [e for e in events if e.done]
    assert len(done) == len(PROMPTS) and all(e.token == 6 for e in done)


def test_stub_per_request_opt_out():
    base, _, _ = _stub_run(0)
    got, eng, _ = _stub_run(3, speculate=False)
    assert got == base
    m = eng.metrics()
    assert m["extra_decode_tokens"] == 0 and m["accepted_draft_tokens"] == 0
    assert m["drafted_tokens"] == 0 and eng.trace_counts["decode"] == 1


def test_stub_metrics_invariants_and_event_indices():
    _, eng, events = _stub_run(3)
    m = eng.metrics()
    emitted = [e for e in events if e.token is not None]
    assert len(emitted) == m["tokens_generated"] == (
        m["prefills"] + m["decode_slot_steps"] - m["poisoned_slot_steps"]
        + m["extra_decode_tokens"])
    assert m["drafted_tokens"] == (m["accepted_draft_tokens"]
                                   + m["rejected_draft_tokens"])
    for uid in {e.uid for e in emitted}:
        idx = [e.index for e in emitted if e.uid == uid]
        assert idx == list(range(len(idx)))


def test_spec_requires_dense_full_attention_and_k_nonnegative():
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), vocab_size=8)
    mk = lambda c, k: Engine(_CyclingModel(c), {}, RunConfig(),
                             EngineConfig(num_slots=2, max_len=64,
                                          speculate_k=k), device="cpu")
    with pytest.raises(ValueError, match="speculat"):
        mk(dataclasses.replace(cfg, sliding_window=8), 3)
    with pytest.raises(ValueError, match="family"):
        mk(dataclasses.replace(cfg, family="moe"), 3)
    with pytest.raises(ValueError, match="speculate_k"):
        mk(cfg, -1)
    assert mk(dataclasses.replace(cfg, sliding_window=8), 0).spec_k == 0


# ---------------------------------------------------------- the real model


@pytest.fixture(scope="module")
def setup():
    """llama2 SMOKE at fp32 with the reference's synthetic 2-bit VQ
    weights (the quantization salt pinned), converted."""
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        jp = jm.quantize(jm.init(KEY), method="synthetic", key=KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (5, 9, 7)]
    return {"jm": jm, "jp": jp, "m": build_model(cfg), "tp": tp,
            "prompts": prompts}


def _run(setup, spec_k, ecfg_kw, sampling=None, max_new=10):
    eng = Engine(setup["m"], setup["tp"], RunConfig(attn_chunk=16),
                 EngineConfig(num_slots=2, max_len=48, speculate_k=spec_k,
                              **ecfg_kw), device="cpu")
    uids = [eng.submit(GenerationRequest(
        prompt=p, max_new_tokens=max_new,
        sampling=sampling(i) if sampling else SamplingParams()))
        for i, p in enumerate(setup["prompts"])]
    while not eng.idle:
        eng.step()
    return {u: list(eng.output(u).tokens) for u in uids}, eng


MAX_NEW = 20
LAYOUTS = {
    "contig": {},
    "paged": dict(paged=True, num_blocks=24, block_size=8),
    # 12 blocks of 4 (one slot's worth) for 2 slots of requests reaching
    # 28 positions (7 blocks each): a decode step runs out and preempts
    "paged_tight": dict(paged=True, num_blocks=12, block_size=4),
    "kvq4": dict(kv_bits=4),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_streams_identical_to_non_speculative(setup, layout):
    kw = LAYOUTS[layout]
    base, be = _run(setup, 0, kw, max_new=MAX_NEW)
    got, eng = _run(setup, 3, kw, max_new=MAX_NEW)
    assert got == base
    assert eng.trace_counts["decode"] == 1
    m = eng.metrics()
    assert m["drafted_tokens"] == (m["accepted_draft_tokens"]
                                   + m["rejected_draft_tokens"]) > 0
    assert m["tokens_generated"] == MAX_NEW * len(setup["prompts"])
    if layout == "paged_tight":
        assert m["preemptions"] >= 1
        assert be.metrics()["preemptions"] >= 1
    if kw.get("paged"):
        assert m["blocks_in_use"] == 0


def _sampled(i):
    return SamplingParams(greedy=False, temperature=0.9, top_k=12, top_p=0.95,
                          seed=i * 7)


@pytest.mark.parametrize("layout", ["contig", "paged", "paged_tight"])
def test_seeded_streams_identical_to_non_speculative(setup, layout):
    kw = LAYOUTS[layout]
    base, _ = _run(setup, 0, kw, _sampled, max_new=MAX_NEW)
    got, _ = _run(setup, 3, kw, _sampled, max_new=MAX_NEW)
    assert got == base
    greedy, _ = _run(setup, 0, kw, max_new=MAX_NEW)
    assert got != greedy  # the draws matter


def test_mixed_greedy_and_sampled_batch(setup):
    mk = lambda i: (SamplingParams() if i % 2 == 0 else SamplingParams(
        greedy=False, temperature=0.8, top_k=8, seed=11 + i))
    base, _ = _run(setup, 0, {}, mk)
    got, eng = _run(setup, 3, {}, mk)
    assert got == base and eng.trace_counts["decode"] == 1


def test_greedy_speculative_streams_identical_to_jax_engine(setup):
    jeng = JaxEngine(setup["jm"], setup["jp"],
                     JaxRunConfig(mode="decode", remat=False, attn_chunk=16),
                     JaxEngineConfig(num_slots=2, max_len=48, speculate_k=3))
    want = jeng.generate(setup["prompts"], 10)
    got, eng = _run(setup, 3, {})
    assert got == want
    assert eng.trace_counts["decode"] == 1 == jeng.trace_counts["decode"]
    jm, m = jeng.metrics(), eng.metrics()
    for key in ("decode_steps", "drafted_tokens", "accepted_draft_tokens",
                "extra_decode_tokens", "tokens_generated"):
        assert m[key] == jm[key], key


@pytest.mark.parametrize("layout", ["contig", "paged", "kvq4"])
def test_windows_past_capacity_stream_as_non_speculative(setup, layout):
    """Requests that fill the cache to its last position: the last verify
    windows write rows past the capacity, which are dropped (contiguous,
    ROADMAP C1) or go to the sink (paged), and the streams still equal
    the non-speculative ones."""
    kw = {"paged": dict(paged=True, block_size=4),
          "kvq4": dict(kv_bits=4)}.get(layout, {})

    def run(k):
        eng = Engine(setup["m"], setup["tp"], RunConfig(attn_chunk=16),
                     EngineConfig(num_slots=2, max_len=16, speculate_k=k,
                                  **kw), device="cpu")
        prompts = [p[:n] for p, n in zip(setup["prompts"], (5, 7, 3))]
        out = eng.generate(prompts, 16 - 7 + 1)  # 7 + 10 - 1 = max_len
        return out, eng

    base, _ = run(0)
    got, eng = run(3)
    assert got == base and eng.trace_counts["decode"] == 1
    assert all(len(t) == 10 for t in got.values())
