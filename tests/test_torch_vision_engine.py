"""Llama-3.2-Vision served by the port's engine (``repro_torch/serve/
engine.py``) held against the JAX engine on the CPU, on its SMOKE config
at fp32 with the reference's 2-bit VQ params converted (the synthetic
quantization's salt pinned; the cross layers' gates set non-zero in the
JAX params before conversion, see ``test_torch_vision.setup``) and one
image of 12 rows given to both engines as ``extras``:

  * greedy streams identical to the JAX engine's: contiguous (bucketed
    prefill graphs, every request's prefill reading the one image), the
    planner pinned to the two-kernel split, INT8 prefill, and paged: a
    parity pool, a pool small enough to preempt, and ``prefill_chunk``
    (each chunk re-projects the image), with the pool metrics
    (``preemptions``, ``prefill_chunks``, peak blocks) equal;
  * the paged tree of vision: its geometry (``bytes_per_block`` counts
    the ``self0`` arenas only), a prefill's commit into it (the image
    memories at rows [0, 12) of the slot), a chunk's ``slot_view`` (the
    pass-through memories sliced at the slot) and ``merge_slot``,
    bit-equal to ``repro.serve.paging``'s (``xlen`` 0 where no prefill
    wrote it);
  * after construction the cache holds what ``init_cache`` made (``xlen``
    N_IMG_TOKENS contiguous, 0 paged), the JAX engine's; a paged bucket's
    warm-up leaves slot 0's memories as they were;
  * the decode step and the prefill graphs read nothing from the host
    and nothing but params, cache leaves, the image and their static
    inputs;
  * restored == uninterrupted (contiguous, paged, mid-chunk), greedy
    and seeded, every cache leaf keeping its ``data_ptr()``;
  * the refusals: ``kv_bits`` 8/4/2 and ``speculate_k`` with the
    reference's messages, and an engine without ``image_embeds``;
  * the CLI: ``serve("llama-3.2-vision-11b", device="cpu")`` prints the
    reference CLI's counters for the same trace.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.plan import PlanPolicy as JaxPlanPolicy
from repro.models import common as jcm
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve import paging as jpaging
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import PlanPolicy
from repro_torch.launch import serve as tserve
from repro_torch.models import RunConfig
from repro_torch.models import vision as tv
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import paging as tpaging

from test_torch_graphs import HOST_OPS, _leaves, _pin_split, _recording
from test_torch_launch import _lines, _reference_main
from test_torch_mla import _t
from test_torch_vision import N_IMG, setup

torch.set_num_threads(1)
MAX_LEN, NEW = 64, 8
PROMPTS = (13, 5, 30, 9, 22, 6)
PAGED = {"paged": True, "block_size": 4}
LAYOUTS = {
    "contiguous": {}, "split": {}, "int8": {},
    "paged": PAGED,
    # 16 blocks a slot, 3 slots on 17 blocks: it preempts
    "tight": {**PAGED, "num_slots": 3, "num_blocks": 17},
    "chunk": {**PAGED, "prefill_chunk": 8},
}


def _extras():
    return {"image_embeds": setup()["image"]}


@functools.lru_cache(maxsize=None)
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32) for n in PROMPTS]


def _kw(layout, **kw):
    return {"num_slots": 2, "max_len": MAX_LEN, **LAYOUTS[layout], **kw}


def _jax_engine(layout="contiguous", **kw):
    s = setup()
    return JaxEngine(s["jm"], s["params"]["vq"][0],
                     jcm.RunConfig(mode="decode", remat=False, attn_chunk=16,
                                   plan_policy=JaxPlanPolicy(
                                       int8_prefill=layout == "int8")),
                     JaxEngineConfig(**_kw(layout, **kw)), extras=_extras())


def _engine(layout="contiguous", **kw):
    s = setup()
    return Engine(s["m"], s["params"]["vq"][1], RunConfig(
        attn_chunk=16, plan_policy=PlanPolicy(int8_prefill=layout == "int8")),
        EngineConfig(**_kw(layout, **kw)), _extras(), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(layout):
    """The JAX engine's greedy streams and pool metrics of ``layout``."""
    eng = _jax_engine(layout)
    out = eng.generate(prompts(), NEW)
    m = eng.metrics()
    return out, {k: m[k] for k in ("preemptions", "prefill_chunks",
                                   "peak_blocks_in_use", "prefills",
                                   "admitted")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_streams_identical_to_jax_engine(layout):
    planner = plan_mod.default_planner()
    before = planner.calibration
    try:
        if layout == "split":
            _pin_split(planner)
        eng = _engine(layout)
        got = eng.generate(prompts(), NEW)
    finally:
        planner.reload_calibration(before)
        planner.cache_clear()
    want, jm = _jax_run("contiguous" if layout == "split" else layout)
    assert got == want
    m = eng.metrics()
    assert {k: m[k] for k in jm} == jm
    assert (jm["preemptions"] >= 1) == (layout == "tight")
    assert (jm["prefill_chunks"] >= 1) == (layout == "chunk")
    assert eng.trace_counts["decode"] == 1
    assert eng._extra_batch["image_embeds"].shape == (1, N_IMG, 128)
    backend = "eva_split" if layout == "split" else "eva_fused"
    assert {pl.backend for _, pl in eng.plans["decode"]
            if pl.spec.kind == "vq"} == {backend}
    if eng.paging is not None:
        assert m["blocks_in_use"] == 0
        assert len(eng._len_leaves()) == 1


# ---------------------------------------------------------------- the paged tree


def _port_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _arena(path):
    """Whether ``path`` names a self-attention arena (k or v)."""
    parts = path.split("/")
    return parts[-1] in ("k", "v") and parts[-2].startswith("self")


def _tree_equal(tc, jc, NB):
    """Every leaf of the port's paged tree bit-equal to the reference's
    (the port's arenas without their sink)."""
    want = dict(ckpt_manager.flatten_with_paths(
        {"c": jax.tree_util.tree_map(np.asarray, jc)}))
    got = dict(ckpt_manager.flatten_with_paths({"c": tc}))
    assert set(got) == set(want)
    for path, a in want.items():
        g = got[path][:, :NB] if _arena(path) else got[path]
        np.testing.assert_array_equal(g.numpy(), a, err_msg=path)


def test_paged_tree_writes_and_views_as_reference():
    """The paged vision tree: ``self0`` paged, the image memories
    pass-through (``xlen`` 0 until a prefill writes it); a prefill
    committed into slot 1 (memories at rows [0, 12)), a chunk's view of
    slot 1 (pass-through leaves sliced at the slot; arenas shared), its
    forward, and the merge of that view: every leaf bit-equal to the
    reference's at each stage."""
    s = setup()
    jmeta = jpaging.make_paging_config(s["jm"], 2, MAX_LEN, block_size=4)
    tmeta = tpaging.make_paging_config(s["m"], 2, MAX_LEN, block_size=4)
    for f in ("block_size", "num_blocks", "page_len", "blocks_per_slot",
              "bytes_per_block", "sentinel"):
        assert getattr(tmeta, f) == getattr(jmeta, f), f
    assert tmeta.bytes_per_block == 2 * 2 * 4 * 2 * 32 * 4  # G k|v bs Hk hd
    NB = tmeta.num_blocks
    jc = jpaging.init_paged_cache(s["jm"], 2, MAX_LEN, jmeta)
    tc = tpaging.init_paged_cache(s["m"], 2, MAX_LEN, tmeta, device="cpu")
    _tree_equal(tc, jc, NB)
    assert tpaging.is_paged(tc) and len(tpaging.attn_nodes(tc)) == 1
    assert [tuple(t.shape) for t in tpaging.passthrough_leaves(tc)] == [
        (2, 2, tv.N_IMG_TOKENS, 2, 32)] * 2 + [(2, 2)]
    assert not tc["cross"]["xlen"].any()
    jp, tp = s["params"]["vq"]
    img = s["image"][None]
    toks = np.random.default_rng(5).integers(0, 512, (1, 11)).astype(np.int32)
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=8)
    _, jfresh = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks),
                                     "image_embeds": jnp.asarray(img)}, jrc)
    row = np.array([9, 2, 31, 0, NB, NB, NB, NB, NB, NB, NB, NB, NB, NB, NB,
                    NB], np.int32)
    slot = 1
    jc = jpaging.write_prefill_into_blocks(jc, jfresh, slot, row, 11, jmeta)
    tpaging.write_prefill_into_blocks(
        tc, _port_tree(jfresh), torch.tensor([slot]), torch.from_numpy(row),
        torch.tensor([11], dtype=torch.int32), tmeta)
    _tree_equal(tc, jc, NB)
    cross = tc["cross"]
    assert cross["xlen"][:, slot].eq(N_IMG).all()
    assert not cross["xlen"][:, 0].any()
    assert cross["xk"][:, slot, :N_IMG].abs().sum() > 0
    assert not cross["xk"][:, slot, N_IMG:].any()
    assert not cross["xk"][:, 0].any()

    hist, true_c = 11, 5
    jv = jpaging.slot_view(jc, slot, row, hist, true_c)
    tvw = tpaging.slot_view(tc, torch.tensor([slot]), torch.from_numpy(row),
                            torch.tensor([hist], dtype=torch.int32),
                            torch.tensor([true_c], dtype=torch.int32))
    assert tvw["self0"]["k"] is tc["self0"]["k"]  # the arenas are shared
    _tree_equal(tvw, jv, NB)
    chunk = np.random.default_rng(6).integers(0, 512, (1, 8)).astype(np.int32)
    pos = hist + np.arange(8, dtype=np.int32)[None]
    _, jnew = s["jm"].forward(jp, {"tokens": jnp.asarray(chunk),
                                   "positions": jnp.asarray(pos),
                                   "image_embeds": jnp.asarray(img)}, jrc,
                              caches=jv)
    with torch.no_grad():
        _, tnew = s["m"].forward(tp, {"tokens": _t(chunk),
                                      "positions": _t(pos),
                                      "image_embeds": _t(img)},
                                 RunConfig(mode="prefill", attn_chunk=8),
                                 caches=tvw)
    assert tnew["cross"]["xk"].shape == (2, 1, N_IMG, 2, 32)
    assert tnew["self0"] is tvw["self0"]
    for n in ("xk", "xv"):
        np.testing.assert_allclose(tnew["cross"][n].numpy(),
                                   np.asarray(jnew["cross"][n]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tnew["cross"]["xlen"].numpy(),
                                  np.asarray(jnew["cross"]["xlen"]))
    jc = jpaging.merge_slot(jc, jnew, slot)
    # the memories of the fresh projection: within fp32 of the reference's,
    # written at rows [0, 12) of the slot; merged from the reference's own
    # values, bit-equal
    tpaging.merge_slot(tc, {**tnew, "cross": _port_tree(jnew["cross"])},
                       torch.tensor([slot]))
    want = dict(ckpt_manager.flatten_with_paths(
        {"c": jax.tree_util.tree_map(np.asarray, jc)}))
    got = dict(ckpt_manager.flatten_with_paths({"c": tc}))
    for path in ("/c/self0/k", "/c/self0/v"):
        np.testing.assert_allclose(got[path][:, :NB].numpy(), want[path],
                                   rtol=1e-5, atol=1e-5)
    for path in ("/c/cross/xk", "/c/cross/xv", "/c/cross/xlen",
                 "/c/self0/len"):
        np.testing.assert_array_equal(got[path].numpy(), want[path])
    assert tc["self0"]["len"][:, slot].eq(hist + true_c).all()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_construction_leaves_the_cache_as_init_cache_made_it(layout):
    """The decode graph's warm-up steps every slot; the engine puts back
    what init_cache made (``xlen`` N_IMG_TOKENS contiguous; zeros and the
    sentinel paged): the JAX engine's cache after its construction."""
    eng, jeng = _engine(layout), _jax_engine(layout)
    got = dict(ckpt_manager.flatten_with_paths({"c": eng.caches}))
    want = dict(ckpt_manager.flatten_with_paths(
        {"c": jax.tree_util.tree_map(np.asarray, jeng.caches)}))
    assert set(got) == set(want)
    for path, a in want.items():
        g = got[path]
        if layout == "paged" and _arena(path):
            g = g[:, :eng.paging.num_blocks]
        np.testing.assert_array_equal(g.numpy(), a, err_msg=path)
    assert (want["/c/cross/xlen"] == (tv.N_IMG_TOKENS
                                      if layout == "contiguous" else 0)).all()


def test_paged_bucket_build_keeps_slot0_memories():
    """A paged prefill bucket built while slot 0 serves: its warm-up (slot
    0, true length 0) writes slot 0's column of every pass-through leaf
    (the image memories and ``xlen``) and its ``len``; the build puts them
    back, so slot 0's request goes on unchanged: every leaf but the sink
    as before the build, and its stream the one it gives alone."""
    eng = _engine("paged")
    uid = eng.submit(GenerationRequest(prompt=prompts()[0],
                                       max_new_tokens=NEW))
    eng.step()
    eng.step()
    assert eng.caches["cross"]["xlen"][:, 0].eq(N_IMG).all()
    before = {n: t.clone() for n, t in
              ckpt_manager.flatten_with_paths({"c": eng.caches})}
    assert 32 not in eng.prefill_graphs
    eng.prefill_graph(32)
    after = dict(ckpt_manager.flatten_with_paths({"c": eng.caches}))
    for n, t in before.items():
        if _arena(n):
            t, a = t[:, :-1], after[n][:, :-1]  # the sink takes the writes
        else:
            a = after[n]
        assert torch.equal(t, a), n
    while not eng.idle:
        eng.step()
    assert [list(eng.output(uid).tokens)] == list(
        _engine("paged").generate([prompts()[0]], NEW).values())


# ------------------------------------------------------------------- the graphs


@pytest.fixture(scope="module", params=["contiguous", "chunk"])
def vision_served(request):
    """vision SMOKE with the reference's 2-bit VQ weights: an engine built
    and driven with its StepGraphs (decode, prefill buckets, chunk
    continuations) recorded."""
    calls = []
    with mock.patch.object(engine_mod, "StepGraph", _recording(calls)):
        eng = _engine(request.param)
        out = eng.generate(prompts(), NEW)
    return {"eng": eng, "calls": calls, "out": out,
            "layout": request.param}


def test_steps_read_nothing_from_the_host(vision_served):
    """Every step under ``test_torch_graphs``' guard: no host op, and
    nothing read but params, cache leaves, the engine's image and the
    step's static inputs; the streams are the JAX engine's."""
    eng = vision_served["eng"]
    resident = {id(t) for t in _leaves((eng.params, eng.caches,
                                        eng._extra_batch))}
    names = {n for n, _ in vision_served["calls"]}
    assert ("tokens", "positions") in names
    assert ("tokens",) in names or ("tokens", "slot", "bt_row",
                                    "true_len") in names
    if vision_served["layout"] == "chunk":
        assert ("tokens", "slot", "bt_row", "hist", "true_len") in names
    for names, log in vision_served["calls"]:
        assert log, names
        for call in log:
            host = sorted({op for op in call["ops"] if op in HOST_OPS})
            assert not host, (names, host)
            foreign = [(op, tuple(t.shape), t.dtype)
                       for op, t in call["foreign"] if id(t) not in resident]
            assert not foreign, (names, foreign)
    assert vision_served["out"] == _jax_run(vision_served["layout"])[0]


# ----------------------------------------------------------------- resilience


def _sampling(i, sampled):
    if not sampled or i % 2:
        return SamplingParams()
    return SamplingParams(greedy=False, temperature=0.8, top_k=20, seed=i)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("layout", ["contiguous", "paged", "chunk"])
def test_restored_equals_uninterrupted(layout, sampled):
    """A snapshot mid-run (a chunked prefill in flight under ``chunk``)
    restored into a fresh engine: its streams are the uninterrupted
    run's, the image memories are in the snapshot, and the restore
    writes every cache leaf in place."""
    reqs = [GenerationRequest(prompt=p, max_new_tokens=NEW,
                              sampling=_sampling(i, sampled))
            for i, p in enumerate(prompts())]
    eng = _engine(layout)
    uids = [eng.submit(r) for r in reqs]
    snap, t = None, 0
    while not eng.idle:
        eng.step()
        t += 1
        mid_chunk = any(tr is not None and not eng.active[b]
                        for b, tr in enumerate(eng.sched.slots))
        if snap is None and t >= 3 and (layout != "chunk" or mid_chunk):
            snap = eng.snapshot()
    want = {u: eng.output(u).tokens for u in uids}
    assert snap is not None
    paths = {p for p in snap.arrays if p.startswith("/caches/")}
    assert {"/caches/cross/xk", "/caches/cross/xv", "/caches/cross/xlen",
            "/caches/self0/len"} <= paths
    assert snap.arrays["/caches/cross/xk"].shape == (2, 2, tv.N_IMG_TOKENS,
                                                     2, 32)
    eng2 = _engine(layout)
    ptrs = [t.data_ptr() for t in _leaves(eng2.caches)]
    eng2.restore(snap)
    assert [t.data_ptr() for t in _leaves(eng2.caches)] == ptrs
    while not eng2.idle:
        eng2.step()
    assert {u: eng2.output(u).tokens for u in uids} == want


# ------------------------------------------------------------------- refusals


def test_refusals_as_reference():
    """kv_bits 8/4/2 and speculation raise the reference's messages in
    both engines; the port refuses an engine without ``image_embeds`` at
    once (the reference would fail later, inside the first prefill)."""
    cases = ([({"kv_bits": b}, "requires an attention-cache family "
               r"\(dense/moe\), got 'vision'") for b in (8, 4, 2)]
             + [({"speculate_k": 2}, "speculate_k > 0 requires "
                 "family='dense'")])
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            _jax_engine(**kw)
        with pytest.raises(ValueError, match=match):
            _engine(**kw)
    s = setup()
    with pytest.raises(ValueError, match="image_embeds"):
        Engine(s["m"], s["params"]["vq"][1], RunConfig(),
               EngineConfig(num_slots=2, max_len=MAX_LEN), device="cpu")


def test_cli_prints_the_reference_counters(capsys):
    """``python -m repro_torch.launch.serve --arch llama-3.2-vision-11b``
    (8 image rows from its own generator, zero gates as the reference
    CLI's) prints the reference CLI's counters for the same trace."""
    argv = ["--arch", "llama-3.2-vision-11b", "--requests", "5", "--slots",
            "2", "--max-new", "6"]
    want = _lines(capsys, lambda: _reference_main(argv))
    got = _lines(capsys, lambda: tserve.main([*argv, "--device", "cpu"]))
    assert got == want
    out = tserve.serve("llama-3.2-vision-11b", requests=3, max_new=4,
                       num_slots=2, device="cpu")
    eng = out["engine"]
    assert eng._extra_batch["image_embeds"].shape == (1, 8, 128)
    assert not any(g["cross"]["attn_gate"].item()
                   for g in eng.params["groups"])
    assert out["tokens"] == 12 and eng.metrics()["finished_length"] == 3
