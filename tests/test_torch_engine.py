"""Port of the serving engine, held against the JAX engine: greedy
``generate()`` streams are IDENTICAL to the reference's (``impl="jnp"``)
on llama2 SMOKE at fp32 with converted params, dense and 2-bit VQ; the
``EngineMetrics`` invariants of tests/test_engine.py hold; and the
engine runs on the CPU only when asked to."""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models.common import RunConfig as JaxRunConfig
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import calibrate
from repro_torch.core import plan as plan_mod
from repro_torch.models import RunConfig, build_model
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams)
from repro_torch.serve.api import prefill_buckets

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    dense = jm.init(KEY)
    vq = jm.quantize(dense, method="synthetic", key=KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    conv = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t),
                                     device="cpu")
    return {"jm": jm, "m": build_model(cfg), "cfg": cfg,
            "params": {"dense": (dense, conv(dense)), "vq": (vq, conv(vq))}}


def _engine(setup, kind="vq", **kw):
    ecfg = EngineConfig(**{"num_slots": 2, "max_len": 32, **kw})
    return Engine(setup["m"], setup["params"][kind][1],
                  RunConfig(attn_chunk=16), ecfg, device="cpu")


def _prompt(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size, n).astype(np.int32)


def _drain(eng):
    events = []
    while not eng.idle:
        events.extend(eng.step())
    return events


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_greedy_streams_identical_to_jax_engine(setup, kind):
    """More requests than slots (queueing), two prefill buckets."""
    rng = np.random.default_rng(0)
    prompts = [_prompt(rng, setup["cfg"], n) for n in (5, 9, 7, 4, 6)]
    jeng = JaxEngine(setup["jm"], setup["params"][kind][0],
                     JaxRunConfig(mode="decode", remat=False, attn_chunk=16),
                     JaxEngineConfig(num_slots=2, max_len=32))
    want = jeng.generate(prompts, 6)
    eng = _engine(setup, kind)
    got = eng.generate(prompts, 6)
    assert got == want
    assert eng.trace_counts == {"decode": 1, "prefill": 2}  # buckets 8, 16


def _vq_backends(eng, phase="decode"):
    return {pl.backend for _, pl in eng.plans[phase] if pl.spec.kind == "vq"}


@pytest.fixture
def split_pinned():
    """The default planner ranks with a calibration that prices
    ``eva_fused`` above ``eva_split``; restored and its cache cleared
    afterwards (the planner is process-global, and a worker runs every
    test of a file)."""
    planner = plan_mod.default_planner()
    before = planner.calibration
    entry = lambda us: calibrate.BackendCalibration(
        overhead_us=us, us_per_mac=0.0, us_per_add=0.0, us_per_byte=0.0,
        rows=calibrate.MIN_FIT_ROWS)
    planner.reload_calibration(calibrate.Calibration(
        calibrate.SCHEMA, "pinned: eva_split below eva_fused",
        {"eva_fused": entry(1e6), "eva_split": entry(1.0)}))
    planner.cache_clear()
    yield planner
    planner.reload_calibration(before)
    planner.cache_clear()


def test_split_backend_streams_identical_to_jax_engine(setup, split_pinned):
    """Decode through the two-kernel split (vq_gemm, then oc_lookup)
    gives the JAX engine's greedy streams."""
    rng = np.random.default_rng(0)
    prompts = [_prompt(rng, setup["cfg"], n) for n in (5, 9, 7, 4, 6)]
    jeng = JaxEngine(setup["jm"], setup["params"]["vq"][0],
                     JaxRunConfig(mode="decode", remat=False, attn_chunk=16),
                     JaxEngineConfig(num_slots=2, max_len=32))
    want = jeng.generate(prompts, 6)
    eng = _engine(setup)
    assert _vq_backends(eng) == {"eva_split"}
    assert _vq_backends(eng, "prefill@8") == {"dequant"}
    assert eng.generate(prompts, 6) == want


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_split_backend_hands_vq_gemm_contiguous_aligned_x(
        setup, split_pinned, monkeypatch, kv_bits):
    """On the card ``vq_gemm`` raises on an x that is not contiguous or
    not 16-byte aligned (it copies none): at every decode VQ site the
    split serves, under every KV cache layout, x arrives as the kernel
    takes it."""
    from repro_torch.kernels.oc_lookup import ops as split_ops

    seen = []
    vq_gemm = split_ops.vq_gemm

    def recording(x, codebooks, **kw):
        seen.append((tuple(x.shape), x.is_contiguous(), x.data_ptr() % 16))
        return vq_gemm(x, codebooks, **kw)

    monkeypatch.setattr(split_ops, "vq_gemm", recording)
    rng = np.random.default_rng(kv_bits)
    prompts = [_prompt(rng, setup["cfg"], n) for n in (5, 9, 3)]
    eng = _engine(setup, kv_bits=kv_bits)
    assert _vq_backends(eng) == {"eva_split"}
    eng.generate(prompts, 4)
    layers = setup["cfg"].num_layers
    assert len(seen) >= 4 * layers * 3  # wqkv, wo, gu, down; 3 steps
    bad = [s for s in seen if not s[1] or s[2]]
    assert not bad, bad


def test_default_ranking_plans_fused_and_logs_it(setup, caplog):
    """With no calibration file the analytic model ranks the fused kernel
    first at every decode site; the engine pre-plans decode and every
    prefill bucket and logs the ranking."""
    with caplog.at_level(logging.INFO, logger="repro_torch.serve.engine"):
        eng = _engine(setup)
    assert sorted(eng.plans) == ["decode", "prefill@16", "prefill@32",
                                 "prefill@8"]
    assert _vq_backends(eng) == {"eva_fused"}
    assert {pl.provenance for _, pl in eng.plans["decode"]} == {"analytic"}
    ranking = [r.message for r in caplog.records if "ranking" in r.message]
    assert any("eva_fused" in m and "eva_split" in m for m in ranking)


def test_metrics_consistent_with_stream_events(setup):
    eng = _engine(setup, max_queue=2)
    rng = np.random.default_rng(4)
    p = lambda n: _prompt(rng, setup["cfg"], n)
    eng.submit(GenerationRequest(prompt=p(5), max_new_tokens=3))
    eng.submit(GenerationRequest(
        prompt=p(6), max_new_tokens=4,
        sampling=SamplingParams(greedy=False, temperature=0.9, seed=5,
                                logprobs=True)))
    eng.submit(GenerationRequest(prompt=p(40), max_new_tokens=3))  # rejected
    events = _drain(eng)
    m = eng.metrics()
    token_events = [e for e in events if e.token is not None]
    terminal = [e for e in events if e.done]
    assert len(token_events) == m["tokens_generated"]
    assert m["finished"] == m["finished_stop"] + m["finished_length"]
    assert len(terminal) == m["finished"] + m["rejected"]
    assert m["submitted"] == 3 and m["admitted"] == 2 and m["rejected"] == 1
    assert m["tokens_generated"] == m["prefills"] + m["decode_slot_steps"]
    assert 0.0 < m["slot_occupancy"] <= 1.0
    out = eng.output(2)
    assert len(out.logprobs) == len(out.tokens) == 4
    assert all(lp <= 0.0 for lp in out.logprobs)
    assert eng.output(3).finish_reason == "rejected"


def test_sampled_streams_seeded(setup):
    """A sampled stream depends only on its seed (torch generators: the
    draws differ from the reference's threefry bits by design)."""
    rng = np.random.default_rng(5)
    prompt = _prompt(rng, setup["cfg"], 7)

    def run(seed, slots):
        eng = _engine(setup, num_slots=slots)
        sp = SamplingParams(greedy=False, temperature=1.5, top_k=50,
                            top_p=0.95, seed=seed)
        uid = eng.submit(GenerationRequest(prompt=prompt, max_new_tokens=8,
                                           sampling=sp))
        if slots > 1:  # a greedy neighbour must not perturb the stream
            eng.submit(GenerationRequest(prompt=prompt[:3], max_new_tokens=8))
        return [e.token for e in eng.stream(uid) if e.token is not None]

    a, b, c = run(7, 1), run(7, 2), run(8, 1)
    assert a == b and len(a) == 8
    assert a != c


def test_stop_ids_and_budget_finish_in_step(setup):
    """A request stops the step its stop id is emitted; the greedy stream
    up to that point is unchanged."""
    rng = np.random.default_rng(6)
    prompt = _prompt(rng, setup["cfg"], 5)
    eng = _engine(setup)
    full = eng.generate([prompt], 6)[1]
    eng2 = _engine(setup)
    uid = eng2.submit(GenerationRequest(prompt=prompt, max_new_tokens=6,
                                        eos_ids=(full[2],)))
    events = _drain(eng2)
    out = eng2.output(uid)
    cut = full.index(full[2]) + 1
    assert list(out.tokens) == full[:cut] and out.finish_reason == "stop"
    assert eng2.metrics()["decode_steps"] == cut - 1
    assert [e.index for e in events if e.token is not None] == list(range(cut))


def test_admission_rejects_and_unported_options(setup):
    eng = _engine(setup, max_len=16)
    long = np.ones(17, np.int32)
    uid = eng.submit(GenerationRequest(prompt=long))
    assert eng.output(uid).finish_reason == "rejected"
    with pytest.raises(ValueError):
        eng.generate([np.ones(10, np.int32)], 10)  # 10 + 10 - 1 > 16
    assert not eng.sched.queue and eng.metrics()["prefills"] == 0
    with pytest.raises(ValueError, match="speculate_k"):
        _engine(setup, speculate_k=-1)
    spec = _engine(setup, speculate_k=2)  # ported: A5
    assert spec.spec_k == 2 and tuple(spec.succ.shape) == (
        2, setup["cfg"].vocab_size)
    assert _engine(setup, paged=True).paging is not None  # ported: A4
    assert prefill_buckets(32, 8) == (8, 16, 32)


def test_engine_needs_explicit_cpu_device(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(setup["m"], setup["params"]["vq"][1], RunConfig(),
               EngineConfig(num_slots=1, max_len=16))


class _CountingModel:
    """Deterministic stub: next token = (last token + 1) % vocab, and NaN
    logits for any slot whose last token is ``poison`` — places stop ids
    and numerics faults exactly."""

    def __init__(self, cfg, poison=-1):
        self.cfg, self.poison = cfg, poison

    def init_cache(self, slots, max_len, *, device):
        return {"body": {"k": torch.zeros((1, slots, max_len, 1, 1)),
                         "v": torch.zeros((1, slots, max_len, 1, 1)),
                         "len": torch.zeros((1, slots), dtype=torch.int32)}}

    def _logits(self, last):
        out = torch.nn.functional.one_hot(
            (last.long() + 1) % self.cfg.vocab_size,
            self.cfg.vocab_size).float()
        out[last == self.poison] = float("nan")
        return out[:, None]

    def prefill(self, params, batch, rc):
        toks = batch["tokens"]
        S = toks.shape[1]
        logits = torch.stack([self._logits(toks[:, i])[:, 0]
                              for i in range(S)], dim=1)
        cache = {"body": {"k": torch.zeros((1, 1, S, 1, 1)),
                          "v": torch.zeros((1, 1, S, 1, 1)),
                          "len": torch.full((1, 1), S, dtype=torch.int32)}}
        return logits, cache

    def decode(self, params, tokens, positions, caches, rc):
        return self._logits(tokens[:, 0]), caches


def _stub_engine(poison=-1, slots=2):
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), vocab_size=32)
    return Engine(_CountingModel(cfg, poison), {}, RunConfig(),
                  EngineConfig(num_slots=slots, max_len=64), device="cpu")


def test_stub_stop_and_error_lanes_finish_in_step():
    """A stop id retires its request in the step it is emitted; a lane
    whose logits go non-finite finishes "error" and its garbage token is
    never streamed, while the other lane streams on untouched."""
    eng = _stub_engine(poison=22)
    ua = eng.submit(GenerationRequest(prompt=np.array([5]), max_new_tokens=10,
                                      eos_ids=(9,)))
    ub = eng.submit(GenerationRequest(prompt=np.array([20]),
                                      max_new_tokens=10))
    events = _drain(eng)
    a, b = eng.output(ua), eng.output(ub)
    assert list(a.tokens) == [6, 7, 8, 9] and a.finish_reason == "stop"
    assert list(b.tokens) == [21, 22] and b.finish_reason == "error"
    m = eng.metrics()
    assert m["errors"] == 1 and m["poisoned_slot_steps"] == 1
    assert m["decode_steps"] == 3
    assert len([e for e in events if e.token is not None]) == \
        m["tokens_generated"] == \
        m["prefills"] + m["decode_slot_steps"] - m["poisoned_slot_steps"]
    assert m["finished"] == m["finished_stop"] + m["errors"]


def test_stub_deadlines_and_edf_admission():
    """Queued requests time out at their deadline before any prefill;
    the earliest deadline is admitted first."""
    eng = _stub_engine(slots=1)
    late = eng.submit(GenerationRequest(prompt=np.array([1]),
                                        max_new_tokens=2, deadline_s=60.0))
    early = eng.submit(GenerationRequest(prompt=np.array([10]),
                                         max_new_tokens=2, deadline_s=30.0))
    dead = eng.submit(GenerationRequest(prompt=np.array([3]),
                                        max_new_tokens=2, deadline_s=0.0))
    first = eng.step()
    assert {e.uid for e in first if e.token is not None} == {early}
    assert eng.output(dead).finish_reason == "timeout"
    _drain(eng)
    assert list(eng.output(late).tokens) == [2, 3]
    m = eng.metrics()
    assert m["timeouts"] == 1 and m["prefills"] == 2
