"""xLSTM-125M served by the port's engine (``repro_torch/serve/engine.py``)
held against the JAX engine on the CPU, on its SMOKE config at fp32 with
the reference's 2-bit VQ params converted (the synthetic quantization's
salt pinned):

  * greedy streams identical to the JAX engine's: the contiguous engine,
    the paged engine (pass-through state: nothing paged, ``bytes_per_block``
    0; also a pool small enough to preempt, its preemptions the
    reference's), the planner pinned to the two-kernel split and INT8
    prefill (sLSTM's N = 4 gates and the head); the exact-length eager
    prefill, decode planned at M = slots;
  * the reference's gates: ``kv_bits`` 8/4/2 raise its "attention-cache
    family" message, ``speculate_k`` its family
    message, and chunked prefill stays off;
  * paging's pass-through state: the paged tree, a paged prefill's commit
    and a chunk merge into a slot equal to the reference's; a chunked
    view of it raises (not ported: no such family chunks its prefill);
  * after construction the cache holds what ``init_cache`` made (sLSTM's
    ``n`` = 1e-6, not the zeros the decode build's warm-up was once reset
    to), equal to the JAX engine's, contiguous and paged;
  * the same scripted fault plans give the JAX engine's streams, finish
    reasons, delivered events and counters (``tests/test_resilience.py``'s
    ``recurrent_setup``, here through ``test_torch_resilience_engine``'s
    harness);
  * restored == uninterrupted over the recurrent tree
    (``TestRecurrentRestore``), contiguous and paged, greedy and seeded,
    every cache leaf keeping its ``data_ptr()``; a backend fault rebuilds
    the decode graph over the live recurrent state, kept bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import plan as jax_plan
from repro.core.plan import PlanPolicy as JaxPlanPolicy
from repro.models import common as jcm
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve import paging as jpaging
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import PlanPolicy
from repro_torch.models import RunConfig
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams)
from repro_torch.serve import paging as tpaging

from test_torch_graphs import _leaves, _pin_split
from test_torch_resilience_engine import SCENARIOS, _both, _reqs
from test_torch_xlstm import setup

torch.set_num_threads(1)
MAX_LEN, SLOTS, NEW = 48, 2, 8
PROMPTS = (13, 5, 30, 9, 21)


@pytest.fixture(autouse=True)
def _clean_quarantines():
    yield
    plan_mod.reset_quarantine()
    jax_plan.reset_quarantine()


@functools.lru_cache(maxsize=None)
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32) for n in PROMPTS]


def _jax_engine(int8_prefill=False, **kw):
    s = setup()
    return JaxEngine(s["jm"], s["params"]["vq"][0],
                     jcm.RunConfig(mode="decode", remat=False, attn_chunk=16,
                                   plan_policy=JaxPlanPolicy(
                                       int8_prefill=int8_prefill)),
                     JaxEngineConfig(**{"num_slots": SLOTS,
                                        "max_len": MAX_LEN, **kw}))


def _engine(int8_prefill=False, **kw):
    s = setup()
    return Engine(s["m"], s["params"]["vq"][1], RunConfig(
        attn_chunk=16, plan_policy=PlanPolicy(int8_prefill=int8_prefill)),
        EngineConfig(**{"num_slots": SLOTS, "max_len": MAX_LEN, **kw}),
        device="cpu")


PAGED = {"paged": True, "block_size": 8}
# the dense prefill linears (sLSTM's N = 4 gates and the head) through the
# INT8 GEMM's wrapper (its plain version here)
INT8 = {"int8_prefill": True}
TIGHT = {"paged": True, "block_size": 4, "num_blocks": 12}


@functools.lru_cache(maxsize=None)
def _jax_run(layout):
    """The JAX engine's greedy streams, pool metrics and prefill traces of
    ``layout``."""
    kw = {"contiguous": {}, "paged": PAGED, "tight": TIGHT,
          "int8": INT8}[layout]
    eng = _jax_engine(**kw)
    out = eng.generate(prompts(), NEW)
    m = eng.metrics()
    return out, {k: m[k] for k in ("preemptions", "peak_blocks_in_use",
                                   "blocks_in_use")}, \
        eng.trace_counts["prefill"]


@pytest.mark.parametrize("layout", ["contiguous", "paged", "tight", "split",
                                    "int8"])
def test_greedy_streams_identical_to_jax_engine(layout):
    planner = plan_mod.default_planner()
    before = planner.calibration
    try:
        if layout == "split":
            _pin_split(planner)
        kw = {"paged": PAGED, "tight": TIGHT, "int8": INT8}.get(layout, {})
        eng = _engine(**kw)
        got = eng.generate(prompts(), NEW)
    finally:
        planner.reload_calibration(before)
        planner.cache_clear()
    want, jm, traces = _jax_run("contiguous" if layout == "split" else layout)
    assert got == want
    # exact-length prefill: one eager step a distinct prompt length (a
    # preempted request's re-prefill adds its own), as the reference
    # retraces
    assert eng.trace_counts == {"decode": 1, "prefill": traces}
    assert traces == len(set(PROMPTS)) + (layout == "tight")
    backend = "eva_split" if layout == "split" else "eva_fused"
    rows = {pl.spec.M for _, pl in eng.plans["decode"]
            if pl.spec.kind == "vq"}
    assert rows == {SLOTS} and {pl.backend for _, pl in eng.plans["decode"]
                                if pl.spec.kind == "vq"} == {backend}
    assert set(eng.plans) == {"decode", "prefill@cap"}
    if eng.paging is not None:
        assert eng.paging.bytes_per_block == 0 and eng._len_leaves() == []
        m = eng.metrics()
        assert {k: m[k] for k in jm} == jm
        assert layout != "tight" or m["preemptions"] >= 1


def test_refusals_as_reference():
    """kv_bits 8/4/2 (recurrent state is no KV cache) and speculation
    raise the reference's messages in both engines; chunked prefill
    stays off (the streams are the unchunked ones)."""
    for kw, match in ([({"kv_bits": b}, "requires an attention-cache family "
                        r"\(dense/moe\), got 'xlstm'") for b in (8, 4, 2)]
                      + [({"speculate_k": 2},
                          "speculate_k > 0 requires family='dense'")]):
        with pytest.raises(ValueError, match=match):
            _jax_engine(**kw)
        with pytest.raises(ValueError, match=match):
            _engine(**kw)
    eng = _engine(prefill_chunk=8, **PAGED)
    assert not eng._chunked and "prefill_chunk" not in eng.trace_counts
    assert eng.generate(prompts()[:3], 4) == \
        _engine(**PAGED).generate(prompts()[:3], 4)
    assert eng.metrics()["prefill_chunks"] == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_construction_leaves_the_cache_as_init_cache_made_it(layout):
    """The decode graph's warm-up steps every slot; the engine puts back
    what init_cache made: the JAX engine's state after its construction,
    leaf for leaf (contiguous: sLSTM's ``n`` = 1e-6; paged: zeros, as
    the reference's ``init_paged_cache`` makes pass-through state)."""
    kw = PAGED if layout == "paged" else {}
    eng, jeng = _engine(**kw), _jax_engine(**kw)
    got = dict(ckpt_manager.flatten_with_paths({"c": eng.caches}))
    want = dict(ckpt_manager.flatten_with_paths(
        {"c": {k: {n: np.asarray(a) for n, a in node.items()}
               for k, node in jeng.caches.items()}}))
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].dtype == torch.float32
        np.testing.assert_array_equal(got[path].numpy(), a, err_msg=path)
    n = got["/c/b1_slstm/n"]
    assert (n == (0.0 if layout == "paged" else np.float32(1e-6))).all()


@pytest.mark.parametrize("op", ["write_prefill_into_blocks", "merge_slot"])
def test_paged_pass_through_state_as_reference(op):
    """The paged tree of xlstm (pass-through leaves only, zeros) and a
    one-slot state written into slot 1 by each package's paged prefill
    commit and chunk merge: every leaf equal to the reference's; a
    chunk's view of slot 1 holds its column of every leaf, as the
    reference's."""
    s = setup()
    jmeta = jpaging.make_paging_config(s["jm"], SLOTS, MAX_LEN, block_size=8)
    tmeta = tpaging.make_paging_config(s["m"], SLOTS, MAX_LEN, block_size=8)
    assert (tmeta.bytes_per_block, tmeta.blocks_per_slot) == \
        (jmeta.bytes_per_block, jmeta.blocks_per_slot) == (0, 6)
    jc = jpaging.init_paged_cache(s["jm"], SLOTS, MAX_LEN, jmeta)
    tc = tpaging.init_paged_cache(s["m"], SLOTS, MAX_LEN, tmeta, device="cpu")
    rng = np.random.default_rng(17)
    one = {k: {n: rng.standard_normal((a.shape[0], 1) + a.shape[2:])
               .astype(np.float32) for n, a in node.items()}
           for k, node in jc.items()}
    slot, row = 1, np.arange(6, dtype=np.int32)
    if op == "merge_slot":
        jc = jpaging.merge_slot(jc, one, slot)
        tpaging.merge_slot(tc, {k: {n: torch.from_numpy(a) for n, a in
                                    node.items()} for k, node in one.items()},
                           torch.tensor([slot]))
    else:
        jc = jpaging.write_prefill_into_blocks(jc, one, slot, row, 9, jmeta)
        tpaging.write_prefill_into_blocks(
            tc, {k: {n: torch.from_numpy(a) for n, a in node.items()}
                 for k, node in one.items()}, torch.tensor([slot]),
            torch.from_numpy(row), torch.tensor([9], dtype=torch.int32), tmeta)
    assert tpaging.attn_nodes(tc) == [] and not tpaging.is_paged(tc)
    for k, node in jc.items():
        for n, a in node.items():
            np.testing.assert_array_equal(tc[k][n].numpy(), np.asarray(a))
            assert tc[k][n][:, slot].abs().sum() > 0
            assert not tc[k][n][:, 0].any()
    jv = jpaging.slot_view(jc, slot, row, 0, 4)
    tv = tpaging.slot_view(tc, torch.tensor([slot]), torch.from_numpy(row),
                           torch.tensor([0], dtype=torch.int32),
                           torch.tensor([4], dtype=torch.int32))
    for k, node in jv.items():
        for n, a in node.items():
            assert tuple(tv[k][n].shape) == (a.shape[0], 1) + a.shape[2:]
            np.testing.assert_array_equal(tv[k][n].numpy(), np.asarray(a))
            assert tv[k][n].abs().sum() > 0


# ----------------------------------------------------------------- resilience


@functools.lru_cache(maxsize=None)
def _fault_setup():
    """``test_torch_resilience_engine``'s harness inputs for xlstm SMOKE:
    both models and params, and five short prompts (max_len 32)."""
    s = setup()
    rng = np.random.default_rng(41)
    return {"jm": s["jm"], "jp": s["params"]["vq"][0], "m": s["m"],
            "tp": s["params"]["vq"][1], "cfg": s["cfg"],
            "prompts": [rng.integers(0, 512, n).astype(np.int32)
                        for n in (5, 6, 4, 7, 5)]}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_fault_plan_same_outcome_as_jax_engine(name):
    specs, kw = SCENARIOS[name]
    fs = _fault_setup()
    toks, reasons, _, counters, restarts = _both(
        fs, specs, _reqs(fs, 5 if name == "breaker" else 3), **kw)
    if name.endswith("crash"):
        assert restarts == 1
    if name.startswith("poison"):
        assert list(reasons.values()).count("error") == 1
    if name == "backend":
        assert counters["backend_fallbacks"] == 1


def _sampling(i, sampled):
    if not sampled or i % 2:
        return SamplingParams()
    return SamplingParams(greedy=False, temperature=0.8, top_k=20, seed=i)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("layout", ["contiguous", "paged", "tight"])
def test_restored_equals_uninterrupted(layout, sampled):
    """A snapshot mid-run restored into a fresh engine: its streams are
    the uninterrupted run's, and the restore writes every cache leaf in
    place (the decode graph reads them at fixed addresses)."""
    kw = {"paged": PAGED, "tight": TIGHT}.get(layout, {})
    reqs = [GenerationRequest(prompt=p, max_new_tokens=NEW,
                              sampling=_sampling(i, sampled))
            for i, p in enumerate(prompts()[:4])]
    eng = _engine(**kw)
    uids = [eng.submit(r) for r in reqs]
    snap, t = None, 0
    while not eng.idle:
        eng.step()
        t += 1
        if t == 4:
            snap = eng.snapshot()
    want = {u: eng.output(u).tokens for u in uids}
    assert {p for p in snap.arrays if p.startswith("/caches/")} == {
        f"/caches/{b}/{n}" for b, ns in (("b0_mlstm", "Cnm"),
                                         ("b1_slstm", "cnhm")) for n in ns}
    eng2 = _engine(**kw)
    ptrs = [t.data_ptr() for t in _leaves(eng2.caches)]
    eng2.restore(snap)
    assert [t.data_ptr() for t in _leaves(eng2.caches)] == ptrs
    while not eng2.idle:
        eng2.step()
    assert {u: eng2.output(u).tokens for u in uids} == want


def test_backend_fault_rebuilds_over_live_recurrent_state():
    """A backend fault mid-run: every state leaf comes out of the decode
    graph's rebuild bit for bit and in place, the decode plans move to
    the split, and the streams are the JAX engine's."""
    eng = _engine(**PAGED)
    uids = [eng.submit(GenerationRequest(prompt=p, max_new_tokens=NEW))
            for p in prompts()]
    for _ in range(3):
        eng.step()
    before = [t.clone() for t in _leaves(eng.caches)]
    ptrs = [t.data_ptr() for t in _leaves(eng.caches)]
    eng._fail_backend(None)
    after = list(_leaves(eng.caches))
    assert [t.data_ptr() for t in after] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert {pl.backend for _, pl in eng.plans["decode"]
            if pl.spec.kind == "vq"} == {"eva_split"}
    while not eng.idle:
        eng.step()
    want = _jax_run("paged")[0]
    assert {u: list(eng.output(u).tokens) for u in uids} == want
