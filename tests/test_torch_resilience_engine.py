"""The resilience layer on the real model (llama2 SMOKE at fp32, 2-bit VQ
weights, the synthetic-quantization salt pinned), after the dense half of
the reference's tests/test_resilience.py:

  * the SAME scripted plan (the same specs, one ``FaultPlan`` each) drives
    the JAX engine and the port's, both under ``serve_with_restarts``,
    at every boundary (poison at prefill and at decode, prefill, decode
    and sample crashes, a backend fault, the breaker) and on the
    reference's mixed batch (error, timeout, stop after a restore): the
    greedy streams, finish reasons, the order of the delivered events and
    the counters ``poisoned_slot_steps``, ``backend_fallbacks``,
    ``snapshots`` and ``restores`` are EQUAL;
  * a poisoned prefill never activates its slot, and the bystanders'
    streams are bit-identical to a fault-free run (greedy and seeded);
  * inside the port, restored == uninterrupted EXACTLY: a fresh engine
    restored from a mid-run snapshot over the contiguous fp cache,
    kv_bits 8 and 4, the paged cache mid-chunk and after a preemption
    (its prefill and chunk buckets first built after the restore, over
    the live arenas), and ``speculate_k=3``, greedy and seeded; the
    restore writes in place (every cache leaf, ``succ``, the step inputs
    and the knob buffers keep their ``data_ptr()``); a bf16 snapshot
    (kv_bits=8 scales) round-trips bitwise through the port's
    ``CheckpointManager``;
  * a ``backend`` fault mid-run rebuilds the decode graph over the live
    caches, kept bit for bit, and switches ``eva_fused`` to ``eva_split``
    (a second fault: to ``dequant``) with the same greedy streams.

Sampled streams are compared inside the port only: the port's
generators are not the reference's threefry keys.
"""
import dataclasses
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import plan as jax_plan
from repro.core import quantize as jq
from repro.models import build_model as jax_build_model
from repro.models.common import RunConfig as JaxRunConfig
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve import GenerationRequest as JaxGenerationRequest
from repro.serve import resilience as jres
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import plan as plan_mod
from repro_torch.models import RunConfig, build_model
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams, load_snapshot_arrays,
                               save_snapshot)
from repro_torch.serve import resilience as tres
from repro_torch.serve.graphs import tensor_leaves

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
COUNTERS = ("poisoned_slot_steps", "backend_fallbacks", "snapshots",
            "restores", "errors", "timeouts", "rejected", "tokens_generated")


def _stable_hash(s: str) -> int:
    """A process-independent stand-in for ``hash`` of a string."""
    return zlib.crc32(s.encode())


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        jp = jm.quantize(jm.init(KEY), method="synthetic", key=KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 6, 4, 7, 5)]
    return {"jm": jm, "jp": jp, "m": build_model(cfg), "tp": tp, "cfg": cfg,
            "prompts": prompts}


@pytest.fixture(autouse=True)
def _clean_quarantines():
    yield
    plan_mod.reset_quarantine()
    jax_plan.reset_quarantine()


def _drain(eng):
    events = []
    while not eng.idle:
        events.extend(eng.step())
    return events


def _port_engine(setup, fault_plan=None, **kw):
    ecfg = {"num_slots": 2, "max_len": 32, **kw}
    return Engine(setup["m"], setup["tp"], RunConfig(attn_chunk=16),
                  EngineConfig(fault_plan=fault_plan, **ecfg), device="cpu")


def _jax_engine(setup, fault_plan=None, **kw):
    ecfg = {"num_slots": 2, "max_len": 32, **kw}
    return JaxEngine(setup["jm"], setup["jp"],
                     JaxRunConfig(mode="decode", remat=False, attn_chunk=16),
                     JaxEngineConfig(fault_plan=fault_plan, **ecfg))


def _serve(side, setup, specs, requests, **kw):
    """Serve ``requests`` (GenerationRequest kwargs, greedy) on one side
    under ``serve_with_restarts`` with the plan of ``specs``: (tokens,
    reasons, delivered events, counters, restarts)."""
    mod, make, req = ((jres, _jax_engine, JaxGenerationRequest)
                      if side == "jax"
                      else (tres, _port_engine, GenerationRequest))
    requests = [req(**r) for r in requests]
    plan = mod.FaultPlan([mod.FaultSpec(**s) for s in specs])
    seen = []

    def factory():
        eng = make(setup, plan, **kw)
        inner = eng.step

        def step():
            evs = inner()
            seen.extend((e.uid, e.index, e.token, e.finish_reason)
                        for e in evs)
            return evs

        eng.step = step
        return eng

    eng, outs, stats = mod.serve_with_restarts(factory, requests)
    m = eng.metrics()
    return ({u: o.tokens for u, o in outs.items()},
            {u: o.finish_reason for u, o in outs.items()}, seen,
            {k: m[k] for k in COUNTERS}, stats.restarts)


def _both(setup, specs, requests, **kw):
    got = _serve("port", setup, specs, requests, **kw)
    want = _serve("jax", setup, specs, requests, **kw)
    for name, g, w in zip(("tokens", "reasons", "events", "counters",
                           "restarts"), got, want):
        assert g == w, name
    return got


def _reqs(setup, n=3, max_new=6):
    return [dict(prompt=p, max_new_tokens=max_new)
            for p in setup["prompts"][:n]]


SCENARIOS = {
    "poison_decode": ([dict(boundary="poison", tick=2, uid=1)], {}),
    "poison_prefill": ([dict(boundary="poison", tick=0, uid=2, mode="inf")],
                       {}),
    "prefill_crash": ([dict(boundary="prefill", tick=2)], {}),
    "decode_crash": ([dict(boundary="decode", tick=2)], {}),
    "sample_crash": ([dict(boundary="sample", tick=3)], {}),
    "backend": ([dict(boundary="backend", tick=2)], {}),
    "breaker": ([dict(boundary="poison", tick=0, times=3)],
                {"num_slots": 1, "breaker_k": 3}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_plan_same_outcome_as_jax_engine(setup, name):
    specs, kw = SCENARIOS[name]
    n = 5 if name == "breaker" else 3
    toks, reasons, events, counters, restarts = _both(
        setup, specs, _reqs(setup, n), **kw)
    if name.endswith("crash"):
        assert restarts == 1
    if name.startswith("poison"):
        assert list(reasons.values()).count("error") == 1
    if name == "backend":
        assert counters["backend_fallbacks"] == 1
        assert set(reasons.values()) == {"length"}
    if name == "breaker":
        assert list(reasons.values()) == ["error"] * 3 + ["rejected"] * 2


def test_mixed_batch_same_as_jax_engine(setup):
    """The reference's acceptance scenario, every lane greedy: A poisoned
    (error), C past its deadline (timeout), a decode crash while only B
    is active, B stopping on a token first seen after the crash
    (stop-after-restore), D and E bit-identical to a fault-free run."""
    pa, pb, pc, pd, pe = setup["prompts"]
    ref = _port_engine(setup, num_slots=4)
    rb = ref.submit(GenerationRequest(prompt=pb, max_new_tokens=12))
    _drain(ref)
    b_ref = ref.output(rb).tokens
    b_idx = next(i for i in range(8, 12) if b_ref[i] not in b_ref[:i])
    reqs = [dict(prompt=pa, max_new_tokens=6),
            dict(prompt=pb, max_new_tokens=12, eos_ids=(int(b_ref[b_idx]),)),
            dict(prompt=pc, max_new_tokens=6, deadline_s=0.0),
            dict(prompt=pd, max_new_tokens=4),
            dict(prompt=pe, max_new_tokens=4)]
    specs = [dict(boundary="poison", tick=1, uid=1),
             dict(boundary="decode", tick=6)]
    toks, reasons, _, counters, restarts = _both(setup, specs, reqs,
                                                 num_slots=4)
    ua, ub, uc, ud, ue = sorted(toks)
    assert restarts == 1
    assert (reasons[ua], reasons[uc], reasons[ub]) == (
        "error", "timeout", "stop-after-restore")
    assert toks[ub] == b_ref[:b_idx + 1]
    assert counters["errors"] == counters["timeouts"] == 1
    assert counters["restores"] == 1


def _sampled(i):
    return (SamplingParams(greedy=False, temperature=0.9, top_k=12, seed=i)
            if i % 2 else SamplingParams())


def test_poisoned_prefill_bystanders_bit_identical(setup):
    reqs = [GenerationRequest(prompt=p, max_new_tokens=6, sampling=_sampled(i))
            for i, p in enumerate(setup["prompts"][:3])]
    ref = _port_engine(setup)
    ruids = [ref.submit(r) for r in reqs]
    _drain(ref)
    plan = tres.FaultPlan.scripted(tres.FaultSpec("poison", tick=0, uid=1))
    eng = _port_engine(setup, plan)
    uids = [eng.submit(r) for r in reqs]
    events = _drain(eng)
    assert eng.output(uids[0]).finish_reason == "error"
    assert eng.output(uids[0]).tokens == ()
    assert [e for e in events if e.uid == uids[0]][0].token is None
    for u, ru in zip(uids[1:], ruids[1:]):
        assert eng.output(u).tokens == ref.output(ru).tokens
    assert eng.metrics()["poisoned_slot_steps"] == 1
    assert eng.trace_counts["decode"] == 1


# ---------------------------------------------------- restore == uninterrupted


def _own_params(setup):
    return setup["tp"]


LAYOUTS = {
    "contig": ({}, lambda eng, t: t == 3),
    "kv8": ({"kv_bits": 8}, lambda eng, t: t == 3),
    "kv4": ({"kv_bits": 4}, lambda eng, t: t == 3),
    # a chunked prefill in flight: a slot occupied but not active
    "paged_mid_chunk": (
        {"paged": True, "block_size": 4, "prefill_chunk": 8, "max_len": 48},
        lambda eng, t: any(tr is not None and not eng.active[b]
                           and tr.prefill_pos > 0
                           for b, tr in enumerate(eng.sched.slots))),
    # 12 blocks of 4 for two slots reaching 28 positions: it preempts
    "paged_after_preemption": (
        {"paged": True, "block_size": 4, "num_blocks": 12, "max_len": 48},
        lambda eng, t: eng.metrics()["preemptions"] >= 1),
    "spec": ({"speculate_k": 3, "max_len": 48}, lambda eng, t: t == 3),
    "spec_paged": ({"speculate_k": 3, "paged": True, "block_size": 4,
                    "max_len": 48}, lambda eng, t: t == 3),
}


def _graph_buffers(eng):
    bufs = list(tensor_leaves(eng.caches)) + list(eng._knobs.dev.values())
    bufs += list(eng.decode_graph.inputs.dev.values())
    return bufs + ([eng.succ] if eng.succ is not None else [])


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_restored_equals_uninterrupted(setup, layout, sampled):
    kw, when = LAYOUTS[layout]
    prompts = setup["prompts"][:3]
    if layout.startswith("paged_mid"):
        prompts = [np.resize(p, 21) for p in prompts]   # > 2 chunks each
    reqs = [GenerationRequest(prompt=p, max_new_tokens=20 if "paged" in
                              layout else 10,
                              sampling=_sampled(i) if sampled else
                              SamplingParams())
            for i, p in enumerate(prompts)]
    eng = _port_engine(setup, **kw)
    uids = [eng.submit(r) for r in reqs]
    snap, t = None, 0
    while not eng.idle:
        eng.step()
        t += 1
        if snap is None and when(eng, t):
            snap = eng.snapshot()
    assert snap is not None, "the snapshot's condition never held"
    want = {u: eng.output(u).tokens for u in uids}

    eng2 = _port_engine(setup, **kw)
    ptrs = [b.data_ptr() for b in _graph_buffers(eng2)]
    builds = dict(eng2.trace_counts)
    eng2.restore(snap)
    assert [b.data_ptr() for b in _graph_buffers(eng2)] == ptrs
    _drain(eng2)
    assert {u: eng2.output(u).tokens for u in uids} == want
    assert eng2.trace_counts["decode"] == 1
    in_flight = [tr.uid for tr in snap.slots if tr is not None]
    if layout == "paged_after_preemption":  # it waits, preempted, queued
        assert any(tr.preempted for tr in snap.queue)
    else:
        assert in_flight
    for u in in_flight:
        assert eng2.output(u).finish_reason.endswith("-after-restore")
    if "paged" in layout:  # buckets built after the restore, live arenas
        assert eng2.trace_counts["prefill"] > builds["prefill"]
        assert eng2.metrics()["blocks_in_use"] == 0


def test_snapshot_geometry_and_layout_mismatch_is_loud(setup):
    snap = _port_engine(setup).snapshot()
    with pytest.raises(ValueError, match="paged"):
        _port_engine(setup, paged=True, block_size=4).restore(snap)
    with pytest.raises(ValueError, match="geometry"):
        _port_engine(setup, kv_bits=8).restore(snap)
    psnap = _port_engine(setup, paged=True, block_size=4).snapshot()
    with pytest.raises(ValueError, match="paging geometry"):
        _port_engine(setup, paged=True, block_size=8).restore(psnap)


def test_bf16_snapshot_roundtrips_through_checkpoint_manager(setup, tmp_path):
    eng = _port_engine(setup, kv_bits=8)
    for r in _reqs(setup, 2):
        eng.submit(GenerationRequest(**r))
    eng.step(), eng.step()
    snap = eng.snapshot()
    v2 = [p for p, a in snap.arrays.items() if a is not None
          and a.dtype.kind == "V"]
    assert v2 and all(p.endswith(("k_s", "v_s")) for p in v2)
    mgr = CheckpointManager(str(tmp_path / "snaps"))
    save_snapshot(snap, mgr, step=snap.tick)
    loaded = load_snapshot_arrays(mgr)
    want = {p: a for p, a in snap.arrays.items() if a is not None}
    assert set(loaded) == set(want)
    for p, a in want.items():
        assert loaded[p].dtype == a.dtype and loaded[p].tobytes() == \
            a.tobytes(), p
    # the loaded arrays restore a fresh engine as the snapshot does
    eng2 = _port_engine(setup, kv_bits=8)
    eng2.restore(dataclasses.replace(snap, arrays={**snap.arrays, **loaded}))
    _drain(eng), _drain(eng2)
    assert [eng2.output(u).tokens for u in (1, 2)] == \
        [eng.output(u).tokens for u in (1, 2)]


# ------------------------------------------------------------ backend faults


def test_backend_fault_rebuilds_over_live_caches(setup):
    """Quarantine the decode plan's backend mid-run: every cache leaf
    comes out of the decode graph's rebuild bit for bit, the prefill
    graphs are dropped, the decode plan moves to the next backend, and
    the streams are the fault-free ones; a second fault moves it to the
    dequant formulation."""
    reqs = [GenerationRequest(**r) for r in _reqs(setup, 3, max_new=10)]
    ref = _port_engine(setup)
    ruids = [ref.submit(r) for r in reqs]
    _drain(ref)
    vq = lambda e: {pl.backend for _, pl in e.plans["decode"]
                    if pl.spec.kind == "vq"}

    eng = _port_engine(setup)
    uids = [eng.submit(r) for r in reqs]
    for _ in range(3):
        eng.step()
    assert vq(eng) == {"eva_fused"} and eng.active.any()
    before = [t.clone() for t in tensor_leaves(eng.caches)]
    ptrs = [t.data_ptr() for t in tensor_leaves(eng.caches)]
    eng._fail_backend(None)
    after = list(tensor_leaves(eng.caches))
    assert [t.data_ptr() for t in after] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert eng.prefill_graphs == {} and eng.trace_counts["decode"] == 2
    assert vq(eng) == {"eva_split"}
    assert eng.metrics()["backend_fallbacks"] == 1
    for _ in range(2):
        eng.step()
    eng._fail_backend(None)
    assert vq(eng) == {"dequant"}
    assert all(pl.policy.impl == "cuda" for _, pl in eng.plans["decode"])
    _drain(eng)
    assert [eng.output(u).tokens for u in uids] == \
        [ref.output(u).tokens for u in ruids]
    assert plan_mod.default_planner().backend_stats()["quarantined"] == (
        "eva_fused", "eva_split")


def test_backend_fault_on_speculative_paged_engine(setup):
    """The rebuild keeps ``succ`` and the paged tables too."""
    kw = {"speculate_k": 3, "paged": True, "block_size": 4, "max_len": 48}
    reqs = [GenerationRequest(**r) for r in _reqs(setup, 3, max_new=12)]
    ref = _port_engine(setup, **kw)
    ruids = [ref.submit(r) for r in reqs]
    _drain(ref)
    plan = tres.FaultPlan.scripted(tres.FaultSpec("backend", tick=3))
    eng = _port_engine(setup, plan, **kw)
    uids = [eng.submit(r) for r in reqs]
    _drain(eng)
    assert [eng.output(u).tokens for u in uids] == \
        [ref.output(u).tokens for u in ruids]
    assert eng.trace_counts["decode"] == 2
    assert eng.metrics()["backend_fallbacks"] == 1
