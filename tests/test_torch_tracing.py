"""The serving engine's tracer (``repro_torch/serve/tracing.py``) and the
counters beside it (``serve/metrics.py``).

On the CPU, on llama2 SMOKE (fp32, dense), contiguous and paged with
chunked prefill: the greedy streams and every ``EngineMetrics`` count
are the same with the tracer on and off; each tick is one
``engine.step`` span whose children nest inside their parents in the
order ``Engine.step`` runs them; off, the tracer reads no clock and makes
no CUDA event; under ``torch.profiler`` the spans are host events of the
same names on the same clock; ``prefill_bucket_tokens`` less
``prefill_prompt_tokens`` is the padding of known prompts and survives
a snapshot; ``tokens_per_s`` starts its clock at the first submit.

On the card (marked ``cuda``, skipped here) the device segments resolve
with no synchronization of the tracer's own, and ``decode.graph``'s
device time is a bare event pair's around the graph.

This file imports no JAX: the engine's streams are held to the JAX
engine's in ``test_torch_engine.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.plan import PlanPolicy
from repro_torch.models import RunConfig, build_model
from repro_torch.serve import Engine, EngineConfig, GenerationRequest
from repro_torch.serve import metrics as metrics_mod
from repro_torch.serve import tracing
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.tracing import OFF, Tracer

torch.set_num_threads(1)
PROMPT_LENS = (5, 9, 7, 3, 20)      # buckets 8, 16, 8, 8, 32
MAX_NEW = 5
ENGINES = {"contiguous": {},
           "paged_chunked": {"paged": True, "block_size": 8,
                             "prefill_chunk": 8}}
# Engine.step's spans, parent first; a child's order among its siblings
# follows this list
ORDER = ["engine.step", "engine.sweep", "engine.admit", "engine.prefill",
         "prefill.replay", "prefill.sync", "prefill.insert",
         "prefill.sample", "engine.decode", "decode.graph",
         "decode.epilogue", "decode.readback", "decode.events",
         "engine.deliver"]
PARENT = {"engine.sweep": "engine.step", "engine.admit": "engine.step",
          "engine.prefill": "engine.step", "engine.decode": "engine.step",
          "engine.deliver": "engine.step",
          "prefill.replay": "engine.prefill",
          "prefill.sync": "engine.prefill",
          "prefill.insert": "engine.prefill",
          "prefill.sample": "engine.prefill",
          "decode.graph": "engine.decode",
          "decode.epilogue": "engine.decode",
          "decode.readback": "engine.decode",
          "decode.events": "engine.decode"}
WAITS = {"prefill.sync", "decode.readback"}


@pytest.fixture(scope="module")
def smoke():
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def _engine(smoke, device="cpu", **kw):
    model, params = smoke
    return Engine(model, params, RunConfig(attn_chunk=16),
                  EngineConfig(**{"num_slots": 2, "max_len": 32, **kw}),
                  device=device)


def _prompts(cfg, lens=PROMPT_LENS):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _counts(eng):
    """Every counter but the timings and the steps the watchdog found
    slow, which a busy host makes."""
    return {k: v for k, v in eng.metrics_counters.state().items()
            if not k.endswith("_s") and k != "straggler_steps"}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_streams_and_counts_same_on_and_off(smoke, kind):
    runs = []
    for on in (False, True):
        eng = _engine(smoke, **ENGINES[kind])
        if on:
            eng.tracer = Tracer(eng.device)
        runs.append((eng.generate(_prompts(smoke[0].cfg), MAX_NEW),
                     _counts(eng)))
    assert runs[0] == runs[1]
    # continuations: 9 = 8 + 1, 20 = 8 + 8 + 4
    assert runs[0][1]["prefill_chunks"] == (kind == "paged_chunked") * 3


@pytest.mark.parametrize("kind", list(ENGINES))
def test_span_tree(smoke, kind):
    eng = _engine(smoke, **ENGINES[kind])
    eng.tracer = tracer = Tracer(eng.device)
    eng.generate(_prompts(smoke[0].cfg), MAX_NEW)
    recs = tracer.records()
    assert recs and not any(r["device"] for r in recs)   # no CUDA here
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["engine.step"] * eng._tick
    assert [r["attrs"]["tick"] for r in roots] == list(range(eng._tick))
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        assert r["wait"] == (r["name"] in WAITS)
        if r["parent"] is None:
            continue
        p = by_id[r["parent"]]
        assert p["name"] == PARENT[r["name"]], r
        assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]
    for p in recs:
        kids = [r for r in recs if r["parent"] == p["id"]]
        assert [r["end_ns"] for r in kids] == sorted(r["end_ns"] for r in kids)
        names = [r["name"] for r in kids]
        if p["name"] == "engine.decode":      # each once, in step()'s order
            ranks = [ORDER.index(n) for n in names]
            assert ranks == sorted(set(ranks))
        elif p["name"] == "engine.prefill":   # a non-final chunk stops early
            assert names[:2] == ["prefill.replay", "prefill.sync"]
            assert names[2:] in ([], ["prefill.sample", "prefill.sync"],
                                 ["prefill.insert", "prefill.sample",
                                  "prefill.sync"])
        elif p["name"] == "engine.step":
            assert names[0] == "engine.sweep" and names[-1] == \
                "engine.deliver"
    prefills = [r for r in recs if r["name"] == "engine.prefill"]
    # one a request, and chunked: 9 in two steps, 20 in three
    assert len(prefills) == {"contiguous": 5, "paged_chunked": 8}[kind]
    for r in prefills:
        a = r["attrs"]
        assert r["uid"] is not None and a["bucket"] >= a["true_len"] > 0
        assert a["chunk"] == (kind == "paged_chunked" and r["uid"] in (2, 5))
    assert sum(r["attrs"]["bucket"] for r in prefills) == \
        eng.metrics_counters.prefill_bucket_tokens
    admits = [r for r in recs if r["name"] == "engine.admit"]
    assert sorted(r["uid"] for r in admits) == [1, 2, 3, 4, 5]
    assert all(r["attrs"]["queue_wait"] >= 0 for r in admits)
    assert sum(r["attrs"]["events"] for r in roots) == \
        eng.metrics_counters.tokens_generated


def test_off_reads_no_clock_and_makes_no_event(smoke, monkeypatch):
    calls = {"clock": 0, "event": 0}
    real_ns, real_event = tracing.time.perf_counter_ns, torch.cuda.Event

    class Clock:
        @staticmethod
        def perf_counter_ns():
            calls["clock"] += 1
            return real_ns()

        time_ns = staticmethod(tracing.time.time_ns)

    def event(*a, **kw):
        calls["event"] += 1
        return real_event(*a, **kw)

    monkeypatch.setattr(tracing, "time", Clock)
    monkeypatch.setattr(torch.cuda, "Event", event)
    eng = _engine(smoke)
    assert eng.tracer is OFF
    eng.generate(_prompts(smoke[0].cfg), MAX_NEW)
    assert calls == {"clock": 0, "event": 0}
    eng.tracer = Tracer(eng.device)     # on, the same counters move
    eng.generate(_prompts(smoke[0].cfg, (4,)), 2)
    assert calls["clock"] > 0 and calls["event"] == 0     # a CPU engine


@pytest.mark.parametrize("on", [False, True])
def test_spans_are_profiler_events(smoke, on):
    from torch.profiler import ProfilerActivity, profile

    eng = _engine(smoke)
    eng.generate(_prompts(smoke[0].cfg, (4,)), 2)        # built outside
    if on:
        eng.tracer = Tracer(eng.device)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.generate(_prompts(smoke[0].cfg), MAX_NEW)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e.start_ns())
    for name in ORDER:
        assert name in events, name
    if not on:
        return
    recs = eng.tracer.records()
    gaps = []
    for name in ORDER:
        mine = sorted(r["start_ns"] for r in recs if r["name"] == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        gaps += [abs(a - b) for a, b in zip(mine, theirs)]
    # one clock: a span starts within 1 ms of its profiler event (the
    # median: a preemption between the two reads parts one pair)
    assert np.median(gaps) < 1_000_000


def test_padding_counter_survives_a_snapshot(smoke):
    lens = (5, 9, 7, 3)                          # buckets 8, 16, 8, 8
    pad = sum(b - n for n, b in zip(lens, (8, 16, 8, 8)))
    eng = _engine(smoke)
    eng.generate(_prompts(smoke[0].cfg, lens), 3)
    m = eng.metrics()
    assert m["prefill_bucket_tokens"] == 40 == sum(lens) + pad
    assert m["prefill_bucket_tokens"] - m["prefill_prompt_tokens"] == pad
    fresh = _engine(smoke)
    fresh.restore(eng.snapshot())
    assert fresh.metrics()["prefill_bucket_tokens"] == 40
    fresh.generate(_prompts(smoke[0].cfg, (20,)), 2)    # bucket 32
    got = fresh.metrics()
    assert got["prefill_bucket_tokens"] - got["prefill_prompt_tokens"] == \
        pad + 12


def test_tokens_per_s_counts_from_the_first_submit(monkeypatch):
    now = [100.0]

    class Clock:
        @staticmethod
        def perf_counter():
            return now[0]

    monkeypatch.setattr(metrics_mod, "time", Clock)
    m = EngineMetrics(num_slots=1, started_at=0.0)   # built at 0
    assert m.tokens_per_s == 0.0
    now[0] = 150.0                                   # set-up took 150 s
    m.count_submit()
    now[0] = 160.0
    m.count_submit()                                 # the clock stays
    m.tokens_generated = 50
    now[0] = 170.0
    assert m.first_submit_at == 150.0 and m.submitted == 2
    assert m.tokens_per_s == pytest.approx(50 / 20)
    snap = m.snapshot()
    assert snap["uptime_s"] == 170.0 and snap["tokens_per_s"] == 2.5
    assert "first_submit_at" not in m.state()


def test_engine_submit_starts_the_clock(smoke):
    eng = _engine(smoke)
    assert eng.metrics_counters.first_submit_at is None
    eng.submit(GenerationRequest(prompt=_prompts(smoke[0].cfg, (4,))[0],
                                 max_new_tokens=2))
    assert eng.metrics_counters.first_submit_at >= \
        eng.metrics_counters.started_at


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device marks are CUDA events")
    return torch.device("cuda")


def _card_engine(smoke, layers):
    """Dense fp32 llama2 SMOKE at ``layers`` layers on the card, through
    plain torch ops (no kernel to build)."""
    model, _ = smoke
    cfg = dataclasses.replace(model.cfg, num_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    rc = RunConfig(attn_chunk=16, plan_policy=PlanPolicy(impl="torch"))
    return Engine(model, params, rc, EngineConfig(num_slots=2, max_len=32),
                  device="cuda")


@pytest.mark.cuda
def test_segments_resolve_without_a_synchronize(smoke, cuda, monkeypatch):
    counts = {}

    def counting(name, fn):
        def wrapped(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    eng = _card_engine(smoke, 2)
    prompts = _prompts(smoke[0].cfg)
    want = eng.generate(prompts, MAX_NEW)                 # builds, off
    seen = []
    for on in (False, True):
        counts.clear()
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "synchronize",
                       counting("sync", torch.cuda.synchronize))
            mp.setattr(torch.cuda.Event, "synchronize",
                       counting("event", torch.cuda.Event.synchronize))
            mp.setattr(torch.cuda.Event, "wait",
                       counting("wait", torch.cuda.Event.wait))
            eng.tracer = Tracer(eng.device) if on else OFF
            got = eng.generate(prompts, MAX_NEW)
        assert list(got.values()) == list(want.values())
        seen.append(dict(counts))
    assert seen[0] == seen[1]
    recs = eng.tracer.records()
    segs = [r for r in recs if r["device"]]
    hosts = {r["id"]: r for r in recs if not r["device"]}
    graphs = [r for r in recs if r["name"] == "decode.graph"
              and not r["device"]]
    assert len([s for s in segs if s["name"] == "decode.graph"]) == \
        len(graphs) > 0
    for s in segs:
        host = hosts[s["parent"]]
        assert s["name"] == host["name"] and s["end_ns"] > s["start_ns"]
        # the device starts a segment after the host asked for it
        assert s["start_ns"] >= host["start_ns"] - 200_000


@pytest.mark.cuda
def test_decode_graph_segment_is_the_replay(smoke, cuda):
    eng = _card_engine(smoke, 16)
    eng.generate(_prompts(smoke[0].cfg, (4,)), 2)         # built, warm
    eng.tracer = tracer = Tracer(eng.device)
    eng.submit(GenerationRequest(prompt=_prompts(smoke[0].cfg, (4,))[0],
                                 max_new_tokens=25))
    while not eng.idle:
        eng.step()
    traced = [(r["end_ns"] - r["start_ns"]) * 1e-6
              for r in tracer.records()
              if r["device"] and r["name"] == "decode.graph"]
    eng.tracer = OFF
    graph = eng.decode_graph.graph
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    bare = []
    for _ in range(len(traced)):
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        bare.append(a.elapsed_time(b))
    got, want = float(np.median(traced)), float(np.median(bare))
    assert abs(got - want) <= 0.1 * want, (got, want)
