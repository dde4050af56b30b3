"""RecurrentGemma-2B served by the port's engine
(``repro_torch/serve/engine.py``) held against the JAX engine on the
CPU, on its SMOKE config at fp32 (a 32-position local window) with the
reference's 2-bit VQ params converted (the synthetic quantization's salt
pinned). Its cache is one tree of rings (the attention layers) and
pass-through recurrent state (``h``, ``conv``):

  * greedy streams identical to the JAX engine's, over prompts that wrap
    the ring in prefill (40 tokens) and in decode (30 + 8): the
    contiguous engine, the paged engine (the rings through the block
    table, ``h``/``conv`` pass-through; also a pool small enough to
    preempt, its preemptions the reference's), the planner pinned to
    the two-kernel split and INT8 prefill; the exact-length eager
    prefill, decode planned at M = slots;
  * ``tests/test_paging.py``'s ring-wrap case: a 40-token prompt's cache
    committed into blocks and 3 paged decode steps equal to the
    contiguous ring's, and to the JAX model's;
  * the paged mixed tree, its geometry and a prefill's commit into it
    equal to the reference's (``bytes_per_block`` counts the rings only);
    a chunked view of it raises (not ported: rglru never chunks);
  * the reference's gates: ``kv_bits`` 8/4/2 its "attention-cache
    family" message, ``speculate_k`` its windowed-cache message, and
    chunked prefill stays off;
  * after construction the cache holds what ``init_cache`` made, equal
    to the JAX engine's, contiguous and paged;
  * the decode step and the eager prefills read nothing from the host
    (``test_torch_graphs``' guard);
  * the same scripted fault plans give the JAX engine's streams, finish
    reasons, delivered events and counters;
  * restored == uninterrupted over the mixed tree, contiguous and paged,
    greedy and seeded, every cache leaf keeping its ``data_ptr()``; a
    backend fault rebuilds the decode graph over the live tree, kept bit
    for bit.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import plan as jax_plan
from repro.core.plan import PlanPolicy as JaxPlanPolicy
from repro.models import common as jcm
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve import kvcache as jkv
from repro.serve import paging as jpaging
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import PlanPolicy
from repro_torch.models import RunConfig
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import paging as tpaging

from test_torch_graphs import (HOST_OPS, _leaves, _pin_split, _recording,
                               _recording_eager)
from test_torch_graphs import \
    test_steps_read_nothing_from_the_host as _reads_nothing_from_the_host
from test_torch_mla import _close, _t
from test_torch_resilience_engine import SCENARIOS, _both, _reqs
from test_torch_rglru import ATTN, setup

torch.set_num_threads(1)
MAX_LEN, SLOTS, NEW = 64, 2, 8
PROMPTS = (13, 5, 40, 9, 30)


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
INT8 = {"int8_prefill": True}
# rings of 32 in blocks of 4: 8 a slot; a pool of 11 preempts (5 times)
TIGHT = {"paged": True, "block_size": 4, "num_blocks": 11}


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
    # preempted request's re-prefill adds its own)
    assert eng.trace_counts == {"decode": 1, "prefill": traces}
    assert traces >= len(set(PROMPTS))
    assert eng.window == 32
    backend = "eva_split" if layout == "split" else "eva_fused"
    rows = {pl.spec.M for _, pl in eng.plans["decode"]
            if pl.spec.kind == "vq"}
    assert rows == {SLOTS} and {pl.backend for _, pl in eng.plans["decode"]
                                if pl.spec.kind == "vq"} == {backend}
    assert set(eng.plans) == {"decode", "prefill@cap"}
    if eng.paging is not None:
        assert eng.paging.page_len == 32
        assert len(eng._len_leaves()) == 1
        m = eng.metrics()
        assert {k: m[k] for k in jm} == jm
        assert layout != "tight" or m["preemptions"] >= 1


def test_paged_ring_wrap_matches_contiguous_and_jax():
    """``tests/test_paging.py``'s ring-wrap case through the port: a
    40-token prompt (window 32) committed into blocks of 4 (ring-converted
    first), then 3 decode steps: the paged logits equal the contiguous
    ring's and are within 1e-5 of the JAX model's; the slot needs
    ceil(32 / 4) blocks, never more."""
    s = setup()
    jp, tp = s["params"]["dense"]
    W, S, N, cap = 32, 40, 3, 64
    toks = np.random.default_rng(2).integers(0, 512, (1, S + N)).astype(
        np.int32)
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=8)
    trc = RunConfig(mode="prefill", attn_chunk=8)
    _, jc = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jrc)
    with torch.no_grad():
        _, fresh = s["m"].prefill(tp, {"tokens": _t(toks[:, :S])}, trc)
    jc = jkv.pad_prefill_cache(jc, cap, window=W)
    cont = tkv.pad_prefill_cache(fresh, cap, window=W)
    meta = tpaging.make_paging_config(s["m"], 1, cap, window=W, block_size=4)
    assert (meta.page_len, meta.blocks_per_slot) == (W, 8)
    assert meta.blocks_for(10 * W) == meta.blocks_per_slot
    paged = s["m"].init_cache(1, cap, device="cpu", paging=meta)
    row = np.random.default_rng(3).permutation(meta.num_blocks)[:8].astype(
        np.int32)
    tpaging.write_prefill_into_blocks(
        paged, fresh, torch.tensor([0]), torch.from_numpy(row),
        torch.tensor([S], dtype=torch.int32), meta, window=W)
    tpaging.set_block_tables(paged, row[None])
    rc = RunConfig(mode="decode", attn_chunk=8)
    for t in range(S, S + N):
        pos = np.full((1, 1), t, np.int32)
        want, jc = s["jm"].decode(jp, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(pos), jc,
                                  jrc.replace(mode="decode"))
        with torch.no_grad():
            lc, cont = s["m"].decode(tp, _t(toks[:, t:t + 1]), _t(pos), cont,
                                     rc)
            lp, paged = s["m"].decode(tp, _t(toks[:, t:t + 1]), _t(pos),
                                      paged, rc)
        assert torch.equal(lp, lc)
        _close(lp.numpy(), want)


def test_paged_mixed_tree_as_reference():
    """The paged tree of rglru: the rings become arenas with a block
    table, ``h``/``conv`` keep their contiguous shapes; its geometry (the
    rings' bytes a block only) and a one-slot prefill cache committed
    into slot 1 equal the reference's, leaf for leaf, and so does a
    chunk's view of slot 1 (its block-table row, ``len``, and its column
    of ``h``/``conv``; the arenas shared)."""
    s = setup()
    W = s["cfg"].local_window
    jmeta = jpaging.make_paging_config(s["jm"], SLOTS, MAX_LEN, window=W,
                                       block_size=8)
    tmeta = tpaging.make_paging_config(s["m"], SLOTS, MAX_LEN, window=W,
                                       block_size=8)
    for f in ("block_size", "num_blocks", "page_len", "blocks_per_slot",
              "bytes_per_block", "sentinel"):
        assert getattr(tmeta, f) == getattr(jmeta, f), f
    assert tmeta.bytes_per_block == 2 * 8 * 64 * 4 and \
        tmeta.page_len == W
    jc = jpaging.init_paged_cache(s["jm"], SLOTS, MAX_LEN, jmeta)
    tc = tpaging.init_paged_cache(s["m"], SLOTS, MAX_LEN, tmeta, device="cpu")
    toks = np.random.default_rng(5).integers(0, 512, (1, 37)).astype(np.int32)
    jp, tp = s["params"]["dense"]
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=8)
    _, jfresh = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks)}, jrc)
    tfresh = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                    jfresh)
    row = np.array([3, 0, 6, 1], np.int32)
    jc = jpaging.write_prefill_into_blocks(jc, jfresh, 1, row, 37, jmeta,
                                           window=W)
    tpaging.write_prefill_into_blocks(
        tc, tfresh, torch.tensor([1]), torch.from_numpy(row),
        torch.tensor([37], dtype=torch.int32), tmeta, window=W)
    want = dict(ckpt_manager.flatten_with_paths(
        {"c": jax.tree_util.tree_map(np.asarray, jc)}))
    got = dict(ckpt_manager.flatten_with_paths({"c": tc}))
    assert set(got) == set(want)
    NB = tmeta.num_blocks
    for path, a in want.items():
        g = got[path]
        if path.split("/")[-1] in ("k", "v"):
            g = g[:, :NB]   # the port's arenas carry a sink past the pool
        np.testing.assert_array_equal(g.numpy(), a, err_msg=path)
    assert tpaging.is_paged(tc) and len(tpaging.attn_nodes(tc)) == 1
    assert tuple(tc["trail"]["h"].shape) == (2, SLOTS, s["cfg"].d_rnn)
    jv = jpaging.slot_view(jc, 1, row, 0, 4)
    tv = tpaging.slot_view(tc, torch.tensor([1]), torch.from_numpy(row),
                           torch.tensor([0], dtype=torch.int32),
                           torch.tensor([4], dtype=torch.int32))
    want = dict(ckpt_manager.flatten_with_paths(
        {"c": jax.tree_util.tree_map(np.asarray, jv)}))
    got = dict(ckpt_manager.flatten_with_paths({"c": tv}))
    assert set(got) == set(want)
    for path, a in want.items():
        g = got[path]
        if path.split("/")[-1] in ("k", "v"):
            assert g is tc["groups"][ATTN][path.split("/")[-1]]
            g = g[:, :NB]
        np.testing.assert_array_equal(g.numpy(), a, err_msg=path)
    assert tv["trail"]["h"].abs().sum() > 0


def test_refusals_as_reference():
    """kv_bits 8/4/2 (the rings stay fp) and speculation (the windowed
    cache's check comes first) raise the reference's messages in both
    engines; chunked prefill stays off (the streams are the unchunked
    ones)."""
    cases = ([({"kv_bits": b}, "requires an attention-cache family "
               r"\(dense/moe\), got 'rglru'") for b in (8, 4, 2)]
             + [({"speculate_k": 2},
                 r"speculate_k > 0 requires a full \(non-windowed\) cache")])
    for kw, match in cases:
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
    what init_cache made (zeros, the paged tables on the sentinel): the
    JAX engine's cache after its construction, leaf for leaf (the port's
    arenas without their sink)."""
    kw = PAGED if layout == "paged" else {}
    eng, jeng = _engine(**kw), _jax_engine(**kw)
    got = dict(ckpt_manager.flatten_with_paths({"c": eng.caches}))
    want = dict(ckpt_manager.flatten_with_paths(
        {"c": jax.tree_util.tree_map(np.asarray, jeng.caches)}))
    assert set(got) == set(want)
    for path, a in want.items():
        g = got[path]
        if layout == "paged" and path.split("/")[-1] in ("k", "v"):
            g = g[:, :eng.paging.num_blocks]
        np.testing.assert_array_equal(g.numpy(), a, err_msg=path)


# ---------------------------------------------------------------- the graphs


@pytest.fixture(scope="module", params=[False, True],
                ids=["contiguous", "paged"])
def rglru_served(request):
    """rglru SMOKE with the reference's 2-bit VQ weights: an engine built
    and driven with its decode StepGraph and its exact-length eager
    prefills recorded."""
    s = setup()
    calls, eager = [], []
    kw = PAGED if request.param else {}
    with mock.patch.object(engine_mod, "StepGraph", _recording(calls)), \
            mock.patch.object(engine_mod, "EagerStep",
                              _recording_eager(eager)):
        eng = _engine(**kw)
        out = eng.generate(prompts(), NEW)
    return {"eng": eng, "calls": calls, "eager": eager, "out": out}


def test_decode_step_reads_nothing_from_the_host(rglru_served):
    """The mixed tree's decode step (rings and state written in place)
    under ``test_torch_graphs``' guard: no host op, and nothing read but
    params, cache leaves and its static inputs; the eager exact-length
    prefills read nothing back to the host either."""
    eng = rglru_served["eng"]
    assert [names for names, _ in rglru_served["calls"]] == [
        ("tokens", "positions")]
    assert len(rglru_served["calls"][0][1]) == \
        1 + eng.metrics()["decode_steps"]
    assert len(rglru_served["eager"]) == len(set(PROMPTS))
    _reads_nothing_from_the_host(rglru_served)
    for names, log in rglru_served["eager"]:
        for call in log:
            assert not {op for op in call["ops"] if op in HOST_OPS}, names
    assert rglru_served["out"] == _jax_run(
        "paged" if eng.paging is not None else "contiguous")[0]


# ----------------------------------------------------------------- resilience


@functools.lru_cache(maxsize=None)
def _fault_setup():
    """``test_torch_resilience_engine``'s harness inputs for rglru SMOKE:
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
    """A snapshot mid-run (past the ring's wrap for the 30-token prompt)
    restored into a fresh engine: its streams are the uninterrupted
    run's, and the restore writes every cache leaf in place (the decode
    graph reads them at fixed addresses)."""
    kw = {"paged": PAGED, "tight": TIGHT}.get(layout, {})
    reqs = [GenerationRequest(prompt=p, max_new_tokens=NEW,
                              sampling=_sampling(i, sampled))
            for i, p in enumerate(prompts()[:5])]
    eng = _engine(**kw)
    uids = [eng.submit(r) for r in reqs]
    snap, t = None, 0
    while not eng.idle:
        eng.step()
        t += 1
        if t == 6:
            snap = eng.snapshot()
    want = {u: eng.output(u).tokens for u in uids}
    paths = {p for p in snap.arrays if p.startswith("/caches/")}
    assert {"/caches/trail/h", "/caches/trail/conv",
            "/caches/groups/b1_rec/h", f"/caches/groups/{ATTN}/len"} <= paths
    assert (f"/caches/groups/{ATTN}/block_table" in paths) == \
        (layout != "contiguous")
    eng2 = _engine(**kw)
    ptrs = [t.data_ptr() for t in _leaves(eng2.caches)]
    eng2.restore(snap)
    assert [t.data_ptr() for t in _leaves(eng2.caches)] == ptrs
    while not eng2.idle:
        eng2.step()
    assert {u: eng2.output(u).tokens for u in uids} == want


def test_backend_fault_rebuilds_over_the_live_tree():
    """A backend fault mid-run: every ring, table and state leaf comes
    out of the decode graph's rebuild bit for bit and in place, the
    decode plans move to the split, and the streams are the JAX
    engine's."""
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


def test_persisted_snapshot_keeps_the_cache_paths(tmp_path):
    """A snapshot saved through a CheckpointManager and read back: the
    cache's ``"groups"`` and ``"trail"`` come back as the leaves they
    are (not unstacked as param segments), every array bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.serve import resilience

    eng = _engine(**PAGED)
    for p in prompts()[:3]:
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=NEW))
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    resilience.save_snapshot(snap, CheckpointManager(str(tmp_path)), 4)
    got = resilience.load_snapshot_arrays(CheckpointManager(str(tmp_path)),
                                          4)
    want = {p: a for p, a in snap.arrays.items() if a is not None}
    assert set(got) == set(want) and "/caches/trail/h" in got
    for p, a in want.items():
        assert got[p].dtype == a.dtype and got[p].shape == a.shape, p
        np.testing.assert_array_equal(got[p], a, err_msg=p)
