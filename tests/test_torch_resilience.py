"""Port of the serving resilience layer (``repro_torch/serve/resilience.py``,
``runtime/fault_tolerance.py``, the engine's fault polls, breaker,
deadlines, snapshot/restore and ``core/plan.py``'s quarantine), after
the reference's tests/test_resilience.py:

  * ``FaultSpec`` / ``FaultPlan`` / ``CircuitBreaker`` as the reference's
    units, and ``FaultPlan.seeded(s)`` spec lists EQUAL to the
    reference's for s in 0..15;
  * the engine's mechanics on a counting stub (next token = last + 1):
    the numerics quarantine and the breaker (TestNumericsQuarantine),
    ``queue_ttl_s``, deadlines and the stall guard (TestDeadlines),
    evicted against unknown uids (TestEvictedVsUnknown), the watchdog
    with a stub clock (TestWatchdogWiring), snapshot/restore and the
    checkpoint round trip (TestSnapshotRestore, through the port's
    ``CheckpointManager``), ``serve_with_restarts`` (TestServeWithRestarts);
  * the planner's quarantine on private planners (TestPlannerQuarantine:
    cool-off release, last resort, reset) and the port's two divergences:
    with both EVA backends quarantined a plan under ``impl="cuda"`` is the
    ``dequant`` kernel with ``impl="cuda"``, never a plain version; and a
    backend's own exception inside ``Engine.step()`` propagates, nothing
    quarantined (the reference's ``_chain_run`` is not ported);
  * on the card (marked ``cuda``, skipped here): a restored engine's
    streams equal the uninterrupted ones bitwise through the graphs.

The real-model half (the JAX engine and the port driven by the same
plans, restores over every cache layout) is
tests/test_torch_resilience_engine.py. Not ported, and why: the
recurrent tests (TestRecurrentRestore and the xlstm half of
TestEveryBoundaryPerFamily) wait for the recurrent families (ROADMAP
A7); TestPlannerQuarantine's test_execute_fallback_quarantines_and_reranks
tests ``_chain_run``, which the port does not have on purpose: its
counterpart here is ``test_backend_exception_propagates_unquarantined``.

No JAX is imported at module level: the ``cuda`` test collects on a
machine without it (``--noconftest``).
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import (LinearSpec, MatmulPlan, PlanCost,
                                   PlanPolicy, Planner, register_backend)
from repro_torch.models import RunConfig, build_model
from repro_torch.runtime import fault_tolerance
from repro_torch.serve import (BOUNDARIES, CircuitBreaker, Engine,
                               EngineConfig, FaultPlan, FaultSpec,
                               GenerationRequest, InjectedFault,
                               RequestEvicted, SamplingParams,
                               load_snapshot_arrays, save_snapshot,
                               serve_with_restarts)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_planner_quarantine():
    yield
    plan_mod.reset_quarantine()


# ------------------------------------------------- FaultPlan and breaker


def test_spec_validation():
    FaultSpec("poison", tick=0, mode="inf", times=2)
    with pytest.raises(ValueError, match="boundary"):
        FaultSpec("gc-pause", tick=0)
    with pytest.raises(ValueError, match="poison mode"):
        FaultSpec("poison", tick=0, mode="zero")
    with pytest.raises(ValueError, match="tick"):
        FaultSpec("decode", tick=-1)
    with pytest.raises(ValueError, match="times"):
        FaultSpec("decode", tick=0, times=0)


def test_poll_fires_and_consumes():
    fp = FaultPlan.scripted(FaultSpec("decode", tick=2, times=2))
    assert fp.poll("decode", 0) is None          # not armed yet
    assert fp.poll("prefill", 3) is None         # another boundary
    assert fp.poll("decode", 3) is not None
    assert fp.poll("decode", 3) is not None      # times=2
    assert fp.poll("decode", 4) is None          # used up
    assert fp.exhausted


def test_uid_targeting():
    fp = FaultPlan.scripted(FaultSpec("poison", tick=0, uid=7))
    assert fp.poll("poison", 0, uid=3) is None
    assert fp.poll("poison", 0, uid=7) is not None
    fp2 = FaultPlan.scripted(FaultSpec("poison", tick=0))
    assert fp2.poll("poison", 0, uid=42) is not None


@pytest.mark.parametrize("seed", range(16))
def test_seeded_plan_equals_reference(seed):
    """The same seed gives the reference's spec list, field for field,
    with the default boundaries and a restricted set."""
    from repro.serve.resilience import FaultPlan as JaxFaultPlan

    for kw in ({"n_faults": 4, "max_tick": 6, "uids": (1, 2, 3)},
               {"boundaries": ("poison", "decode"), "n_faults": 5,
                "max_tick": 9, "uids": (4, 7)}, {}):
        got = FaultPlan.seeded(seed, **kw).faults
        want = JaxFaultPlan.seeded(seed, **kw).faults
        assert [dataclasses.astuple(s) for s in got] == \
            [dataclasses.astuple(s) for s in want], kw
        assert all(s.boundary in BOUNDARIES for s in got)
    assert FaultPlan.seeded(seed).faults != FaultPlan.seeded(seed + 100).faults


def test_breaker_trips_on_consecutive_only():
    br = CircuitBreaker(k=3)
    assert not br.record(True) and not br.record(True)
    assert not br.record(False)                  # a clean step resets
    br.record(True), br.record(True)
    assert br.record(True) and br.tripped


def test_breaker_state_roundtrip_and_validation():
    with pytest.raises(ValueError, match="k must be"):
        CircuitBreaker(k=0)
    br = CircuitBreaker(k=2)
    br.record(True)
    br2 = CircuitBreaker(k=5)
    br2.restore(br.state())
    assert br2.state() == (2, 1, False)
    assert br2.record(True)                      # the streak goes on


# ---------------------------------------------------------------- the stub


class _CountingModel:
    """next token = (token + 1) % vocab at every position; a decode step
    advances ``len`` and checks that each live slot's ``len`` is its
    position (what a restore must carry)."""

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


def _counting_engine(num_slots=2, max_len=64, **kw):
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), vocab_size=64)
    return Engine(_CountingModel(cfg), {}, RunConfig(),
                  EngineConfig(num_slots=num_slots, max_len=max_len, **kw),
                  device="cpu")


def _req(tok, n, eos=(), **kw):
    return GenerationRequest(prompt=np.array([tok], np.int32),
                             max_new_tokens=n, eos_ids=eos, **kw)


def _drain(eng):
    events = []
    while not eng.idle:
        events.extend(eng.step())
    return events


def _slow_decode(eng, s=0.005):
    inner = eng.decode_graph

    def slow(**arrays):
        time.sleep(s)
        return inner(**arrays)

    eng.decode_graph = slow


def _invariants(m):
    assert m["tokens_generated"] == (m["prefills"] + m["decode_slot_steps"]
                                     - m["poisoned_slot_steps"]
                                     + m["extra_decode_tokens"])
    assert m["finished"] == (m["finished_stop"] + m["finished_length"]
                             + m["errors"] + m["timeouts"])


def test_poisoned_request_errors_bystander_unaffected():
    fp = FaultPlan.scripted(FaultSpec("poison", tick=2, uid=1))
    eng = _counting_engine(fault_plan=fp)
    u1, u2 = eng.submit(_req(5, 8)), eng.submit(_req(20, 8))
    events = _drain(eng)
    bad, ok = eng.output(u1), eng.output(u2)
    assert bad.finish_reason == "error" and bad.tokens == (6, 7, 8)
    assert ok.finish_reason == "length"
    assert ok.tokens == (21, 22, 23, 24, 25, 26, 27, 28)
    m = eng.metrics()
    assert m["errors"] == 1 and m["poisoned_slot_steps"] == 1
    _invariants(m)
    term = [e for e in events if e.uid == u1][-1]
    assert term.token is None and term.finish_reason == "error"
    assert sum(e.token is not None
               for e in events if e.uid == u1) == len(bad.tokens)
    assert eng.trace_counts["decode"] == 1       # poison is data


def test_poisoned_prefill_never_activates_slot():
    fp = FaultPlan.scripted(FaultSpec("poison", tick=0, uid=1, mode="inf"))
    eng = _counting_engine(fault_plan=fp)
    v1 = eng.submit(_req(5, 8))
    events = _drain(eng)
    out = eng.output(v1)
    assert out.finish_reason == "error" and out.tokens == ()
    assert eng.metrics()["tokens_generated"] == 0
    assert [(e.token, e.finish_reason) for e in events] == [(None, "error")]
    clean = _counting_engine()
    u1 = clean.submit(_req(5, 8))
    _drain(clean)
    assert clean.output(u1).tokens == (6, 7, 8, 9, 10, 11, 12, 13)


def test_breaker_trips_rejects_pending_and_submits():
    fp = FaultPlan.scripted(FaultSpec("poison", tick=0, times=3))
    eng = _counting_engine(num_slots=1, fault_plan=fp, breaker_k=3)
    uids = [eng.submit(_req(5, 4)) for _ in range(5)]
    _drain(eng)
    assert [eng.output(u).finish_reason for u in uids] == (
        ["error"] * 3 + ["rejected"] * 2)
    assert not eng.healthy
    u6 = eng.submit(_req(5, 4))
    assert eng.output(u6).finish_reason == "rejected"
    m = eng.metrics()
    assert m["errors"] == 3 and m["rejected"] == 3


def test_clean_steps_reset_breaker():
    fp = FaultPlan.scripted(FaultSpec("poison", tick=0, uid=1),
                            FaultSpec("poison", tick=2, uid=3))
    eng = _counting_engine(num_slots=1, fault_plan=fp, breaker_k=2)
    uids = [eng.submit(_req(5, 2)) for _ in range(4)]
    _drain(eng)
    assert eng.healthy
    assert [eng.output(u).finish_reason for u in uids].count("error") == 2


def test_queue_ttl_times_out_before_prefill():
    eng = _counting_engine(num_slots=1, queue_ttl_s=0.0)
    u1 = eng.submit(_req(5, 4))
    time.sleep(0.005)
    _drain(eng)
    out = eng.output(u1)
    assert out.finish_reason == "timeout" and out.tokens == ()
    assert eng.metrics()["prefills"] == 0 and eng.metrics()["timeouts"] == 1


def test_deadline_expires_queued_request():
    eng = _counting_engine(num_slots=1)
    ua = eng.submit(_req(5, 6))
    ub = eng.submit(_req(7, 6, deadline_s=0.0))
    time.sleep(0.005)
    _drain(eng)
    assert eng.output(ua).finish_reason == "length"
    assert eng.output(ub).finish_reason == "timeout"


def test_deadline_frees_active_slot_mid_decode():
    eng = _counting_engine(num_slots=1, max_len=256)
    _slow_decode(eng)
    uid = eng.submit(_req(5, 200, deadline_s=0.05))
    _drain(eng)
    out = eng.output(uid)
    assert out.finish_reason == "timeout"
    assert 0 < len(out.tokens) < 200
    assert eng.metrics()["timeouts"] == 1


def test_stream_delivers_timeout_terminal():
    eng = _counting_engine(num_slots=1, max_len=256)
    _slow_decode(eng)
    eng.submit(_req(5, 200))
    eng.step()
    ub = eng.submit(_req(9, 4, deadline_s=0.02))
    evs = list(eng.stream(ub))
    assert len(evs) == 1 and evs[0].token is None
    assert evs[0].finish_reason == "timeout"


def test_stream_stall_guard_is_wall_clock():
    eng = _counting_engine(num_slots=1, stream_stall_s=0.0)
    eng.submit(_req(5, 50))
    ub = eng.submit(_req(9, 4))                  # queued behind slot 0
    with pytest.raises(RuntimeError, match="stalled"):
        next(iter(eng.stream(ub)))


def test_stream_distinguishes_evicted_from_unknown():
    eng = _counting_engine(num_slots=1)
    eng.ecfg.max_retained = 2
    uids = []
    for _ in range(4):
        uids.append(eng.submit(_req(5, 2)))
        _drain(eng)
    assert eng.evicted(uids[0]) and eng.evicted(uids[1])
    assert not eng.evicted(uids[3]) and not eng.evicted(999)
    with pytest.raises(RequestEvicted):
        next(iter(eng.stream(uids[0])))
    with pytest.raises(KeyError, match="unknown"):
        next(iter(eng.stream(999)))
    assert issubclass(RequestEvicted, KeyError)


def test_drained_stream_is_not_evicted():
    eng = _counting_engine(num_slots=1)
    uid = eng.submit(_req(5, 2))
    list(eng.stream(uid))
    assert not eng.evicted(uid)
    with pytest.raises(KeyError, match="already streamed"):
        next(iter(eng.stream(uid)))


def test_straggler_steps_reach_metrics(monkeypatch):
    """A stub clock: every decode step takes 1 s but the 9th, 10 s."""
    clock = {"t": 0.0, "calls": 0}

    def monotonic():
        clock["calls"] += 1
        step, end = divmod(clock["calls"], 2)    # start, end, start, ...
        if end == 0:
            clock["t"] += 10.0 if step == 9 else 1.0
        return clock["t"]

    monkeypatch.setattr(fault_tolerance.time, "monotonic", monotonic)
    eng = _counting_engine(num_slots=1, straggler_threshold=3.0)
    eng.submit(_req(5, 20))
    _drain(eng)
    m = eng.metrics()
    assert eng.watchdog.straggler_steps == [9]
    assert m["straggler_steps"] == 1
    eng2 = _counting_engine(num_slots=1, straggler_threshold=0.0)
    eng2.submit(_req(5, 30))
    _drain(eng2)
    assert eng2.metrics()["straggler_steps"] == len(
        eng2.watchdog.straggler_steps) > 0


def test_stub_midstream_restore_is_token_identical():
    eng = _counting_engine()
    u1, u2 = eng.submit(_req(5, 10)), eng.submit(_req(20, 10))
    eng.step(), eng.step()
    snap = eng.snapshot()
    _drain(eng)
    eng2 = _counting_engine()
    eng2.restore(snap)
    _drain(eng2)
    for u in (u1, u2):
        assert eng2.output(u).tokens == eng.output(u).tokens
        assert eng2.output(u).finish_reason == "length-after-restore"
    m = eng2.metrics()
    assert m["restores"] == 1 and m["snapshots"] == 1
    assert m["finished_length"] == 2
    _invariants(m)


def test_snapshot_does_not_alias_live_state():
    eng = _counting_engine()
    u1 = eng.submit(_req(5, 10))
    eng.step()
    snap = eng.snapshot()
    frozen = {p: (None if a is None else a.copy())
              for p, a in snap.arrays.items()}
    tick, queue = snap.tick, [tr.generated for tr in snap.slots if tr]
    _drain(eng)
    assert snap.tick == tick
    assert [tr.generated for tr in snap.slots if tr] == queue
    for path, leaf in snap.arrays.items():
        if leaf is not None:
            np.testing.assert_array_equal(leaf, frozen[path])
    eng2 = _counting_engine()
    eng2.restore(snap)
    _drain(eng2)
    assert eng2.output(u1).tokens == eng.output(u1).tokens


def test_snapshot_geometry_mismatch_is_loud():
    snap = _counting_engine(num_slots=2).snapshot()
    with pytest.raises(ValueError, match="geometry"):
        _counting_engine(num_slots=3).restore(snap)
    with pytest.raises(ValueError, match="geometry"):
        _counting_engine(num_slots=2, max_len=32).restore(snap)


def test_snapshot_roundtrips_through_checkpoint_manager(tmp_path):
    eng = _counting_engine()
    eng.submit(_req(5, 8, sampling=SamplingParams(greedy=False, seed=3)))
    eng.step(), eng.step()
    snap = eng.snapshot()
    assert any(p.startswith("/slots/generator/") and a is not None
               for p, a in snap.arrays.items())
    mgr = CheckpointManager(str(tmp_path / "snaps"), keep=2)
    save_snapshot(snap, mgr, step=snap.tick)
    assert mgr.latest_step() == snap.tick
    loaded = load_snapshot_arrays(mgr)
    want = {p: a for p, a in snap.arrays.items() if a is not None}
    assert set(loaded) == set(want)
    for path, arr in want.items():
        assert loaded[path].dtype == arr.dtype, path
        np.testing.assert_array_equal(loaded[path], arr)


@pytest.mark.parametrize("boundary,num_slots,budgets", [
    ("prefill", 1, (3, 8)),
    ("decode", 2, (8, 8)),
    ("sample", 2, (8, 8)),
])
def test_crash_boundary_recovers_token_identically(boundary, num_slots,
                                                   budgets):
    ref = _counting_engine(num_slots=num_slots)
    refs = [ref.submit(_req(5, budgets[0])), ref.submit(_req(20, budgets[1]))]
    _drain(ref)
    fp = FaultPlan.scripted(FaultSpec(boundary, tick=2))
    eng, outs, stats = serve_with_restarts(
        lambda: _counting_engine(num_slots=num_slots, fault_plan=fp),
        [_req(5, budgets[0]), _req(20, budgets[1])])
    assert stats.restarts == 1 and stats.snapshots >= 2
    assert stats.failures[0].startswith("InjectedFault:")
    assert fp.exhausted
    for uid, ruid in zip(sorted(outs), refs):
        assert outs[uid].tokens == ref.output(ruid).tokens
        assert outs[uid].finish_reason.startswith("length")
    if boundary in ("decode", "sample"):
        assert all(o.finish_reason == "length-after-restore"
                   for o in outs.values())


@pytest.mark.parametrize("boundary", ["prefill", "decode", "sample"])
def test_raise_boundaries_raise_injected_fault(boundary):
    fp = FaultPlan.scripted(FaultSpec(boundary, tick=0))
    eng = _counting_engine(fault_plan=fp)
    eng.submit(_req(5, 4))
    with pytest.raises(InjectedFault) as e:
        _drain(eng)
    assert e.value.boundary == boundary and e.value.tick == 0
    assert fp.exhausted


def test_gives_up_past_max_restarts():
    fp = FaultPlan.scripted(FaultSpec("decode", tick=0, times=10))
    with pytest.raises(RuntimeError, match="exceeded"):
        serve_with_restarts(lambda: _counting_engine(fault_plan=fp),
                            [_req(5, 8)], max_restarts=2)


def test_no_event_delivered_twice():
    fp = FaultPlan.scripted(FaultSpec("sample", tick=3))
    seen = []

    def factory():
        eng = _counting_engine(fault_plan=fp)
        inner = eng.step

        def step():
            evs = inner()
            seen.extend((e.uid, e.index, e.token) for e in evs)
            return evs

        eng.step = step
        return eng

    _eng, outs, stats = serve_with_restarts(factory, [_req(5, 8)])
    assert stats.restarts == 1
    assert len(seen) == len(set(seen))
    assert outs[1].tokens == (6, 7, 8, 9, 10, 11, 12, 13)


# ------------------------------------------------------------- the planner

_SENTINEL_N = 9973  # prime; no real layer width


def _synthetic_backend(name, us):
    def matcher(s, p):
        return s.kind == "dense" and s.N == _SENTINEL_N

    def planner_fn(s, p):
        return MatmulPlan(name, s, p, (), PlanCost(
            macs=us, lookup_adds=0, weight_bytes=1), lambda x, w: x @ w)

    return matcher, planner_fn


@pytest.fixture
def synthetic_backends():
    names = ("t_cheap", "t_pricey")
    register_backend("t_cheap", *_synthetic_backend("t_cheap", 1))
    register_backend("t_pricey", *_synthetic_backend("t_pricey", 10 ** 12))
    yield LinearSpec(M=4, K=8, N=_SENTINEL_N, kind="dense",
                     x_dtype="float32", out_dtype="float32")
    with plan_mod._REGISTRY_LOCK:
        for n in names:
            plan_mod._REGISTRY.pop(n, None)


def test_quarantine_skips_and_cooloff_releases(synthetic_backends):
    spec = synthetic_backends
    pl = Planner(calibration=None, cooloff_s=0.05)
    assert pl.plan(spec, PlanPolicy()).backend == "t_cheap"
    pl.record_backend_failure("t_cheap")
    assert pl.plan(spec, PlanPolicy()).backend != "t_cheap"
    assert pl.backend_stats() == {"failures": {"t_cheap": 1},
                                  "quarantined": ("t_cheap",)}
    time.sleep(0.06)
    # the expiry releases it and clears the cache: it is ranked again
    assert pl.plan(spec, PlanPolicy()).backend == "t_cheap"
    assert pl.backend_stats()["quarantined"] == ()


def test_all_quarantined_serves_as_last_resort(synthetic_backends):
    spec = synthetic_backends
    pl = Planner(calibration=None, cooloff_s=60.0)
    matched = {be.name for be in Planner._match_all(spec, PlanPolicy())}
    assert {"t_cheap", "t_pricey", "fp"} <= matched
    for b in matched:
        pl.record_backend_failure(b)
    assert pl.plan(spec, PlanPolicy()).backend in matched


def test_reset_quarantine_clears_everything(synthetic_backends):
    spec = synthetic_backends
    pl = Planner(calibration=None, cooloff_s=60.0)
    pl.record_backend_failure("t_cheap")
    pl.reset_quarantine()
    assert pl.backend_stats() == {"failures": {}, "quarantined": ()}
    assert pl.plan(spec, PlanPolicy()).backend == "t_cheap"
    # the default planner's, through the module function
    plan_mod.default_planner().record_backend_failure("t_cheap")
    plan_mod.reset_quarantine()
    assert plan_mod.default_planner().backend_stats() == {
        "failures": {}, "quarantined": ()}


def _vq_spec():
    from repro_torch.core.vq import synthetic_vq

    vq = synthetic_vq(torch.Generator().manual_seed(0), 128, 256, C=2,
                      device="cpu")
    return LinearSpec.for_vq(vq, M=4, x_dtype=torch.bfloat16,
                             out_dtype=torch.bfloat16)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_all_eva_quarantined_degrades_to_dequant_same_impl(impl):
    """The port's divergence: no plain degrade step. Every matched EVA
    backend quarantined (under ``impl="cuda"`` both kernels, under
    ``impl="torch"`` the plain epilogue the site resolves to), an eva plan
    is ``dequant`` under the SAME impl (under ``impl="cuda"`` the B3
    kernel); with ``dequant`` quarantined too, the quarantine is ignored
    and the EVA backends re-ranked."""
    spec = _vq_spec()
    policy = PlanPolicy(vq_mode="eva", impl=impl)
    pl = Planner(calibration=None, cooloff_s=60.0)
    matched = {be.name for be in Planner._match_all(spec, policy)}
    evas = ["eva_fused", "eva_split"] if impl == "cuda" else ["eva_direct"]
    assert matched == set(evas)
    for name, nxt in zip(evas, evas[1:]):
        pl.record_backend_failure(name)
        assert pl.plan(spec, policy).backend == nxt
    pl.record_backend_failure(evas[-1])
    got = pl.plan(spec, policy)
    assert got.backend == "dequant" and got.policy.impl == impl
    assert got.policy.vq_mode == "dequant"
    assert pl.plan(spec, policy) is got          # cached until a change
    pl.record_backend_failure("dequant")
    last = pl.plan(spec, policy)
    assert last.backend == "dequant" and last.policy.impl == impl
    pl.reset_quarantine()
    assert pl.plan(spec, policy).backend == evas[0]


def test_backend_exception_propagates_unquarantined(monkeypatch):
    """The port's divergence: no ``_chain_run``. A backend that raises
    inside ``Engine.step()`` propagates; nothing is quarantined and no
    fallback is counted."""
    from repro_torch.kernels.fused_vq_matmul import ops as fused_ops

    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.quantize(model.init(gen, device="cpu"), method="synthetic",
                            generator=gen,
                            device="cpu")
    eng = Engine(model, params, RunConfig(attn_chunk=16),
                 EngineConfig(num_slots=2, max_len=32), device="cpu")
    assert {pl.backend for _, pl in eng.plans["decode"]
            if pl.spec.kind == "vq"} == {"eva_fused"}

    def boom(*a, **kw):
        raise RuntimeError("kernel launch failed")

    boom.launches = 0  # kernels.launch_counts() reads it
    monkeypatch.setattr(fused_ops, "fused_vq_matmul", boom)
    eng.submit(GenerationRequest(prompt=np.arange(5, dtype=np.int32),
                                 max_new_tokens=4))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _drain(eng)
    assert plan_mod.default_planner().backend_stats() == {
        "failures": {}, "quarantined": ()}
    assert eng.metrics()["backend_fallbacks"] == 0


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_restore_equals_uninterrupted_on_card():
    """Smoke size on the card, bf16, through the captured graphs: a fresh
    engine restored from a mid-run snapshot gives the uninterrupted
    streams (greedy and seeded), every graph-read buffer keeps its
    address, and the decode graph is built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = get_smoke_config("llama2_7b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.quantize(model.init(gen, device="cuda"), method="synthetic",
                            generator=gen,
                            device="cuda")
    rng = np.random.default_rng(0)
    reqs = [GenerationRequest(
        prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
        max_new_tokens=12,
        sampling=SamplingParams(greedy=False, temperature=0.9, seed=i)
        if i % 2 else SamplingParams()) for i, n in enumerate((5, 19, 9))]
    for kw in ({}, {"paged": True, "block_size": 4}, {"speculate_k": 2}):
        mk = lambda: Engine(model, params, RunConfig(attn_chunk=16),
                            EngineConfig(num_slots=2, max_len=48, **kw),
                            device="cuda")
        eng = mk()
        uids = [eng.submit(r) for r in reqs]
        for _ in range(4):
            eng.step()
        snap = eng.snapshot()
        _drain(eng)
        eng2 = mk()
        ptrs = [t.data_ptr() for t in _leaves(eng2)]
        eng2.restore(snap)
        assert [t.data_ptr() for t in _leaves(eng2)] == ptrs, kw
        _drain(eng2)
        for u in uids:
            assert eng2.output(u).tokens == eng.output(u).tokens, kw
        assert eng2.trace_counts["decode"] == 1, kw


def _leaves(eng):
    from repro_torch.serve.graphs import tensor_leaves

    out = list(tensor_leaves(eng.caches)) + list(eng._knobs.dev.values())
    out += list(eng.decode_graph.inputs.dev.values())
    return out + ([eng.succ] if eng.succ is not None else [])
