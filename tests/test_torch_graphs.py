"""The serving steps stay capturable as CUDA graphs
(``repro_torch/serve/graphs.py``, the engine's decode step and prefill
buckets).

On the CPU the exact functions the engine hands to ``StepGraph`` run
under a dispatch mode that records every aten op, on llama2 SMOKE with
2-bit VQ weights at kv_bits 16, 8 and 4 (INT8 prefill at 4), with the
planner's default ranking (the fused EVA kernel) and pinned to the
two-kernel split; and with speculative decoding (K = 2: the verify
window's decode step) at kv_bits 16 and 4, and with a VQ-Logits head.
Inside a step no op reads a value back to the host
(``.item()``, ``bool(t)``, ``nonzero``), no tensor is made from host
data, and every tensor a step reads that it did not make is a param,
a cache leaf, the engine's stacked KV codebooks, its successor table
``succ`` (a static device buffer the eager part updates in place) or
one of its static inputs; consecutive calls hand the step the same
static input tensors;
the warm-up at construction leaves the caches as ``init_cache`` made
them; ``trace_counts`` counts one decode build and one build per
prefill bucket used.

The paged engine's steps are held the same way (kv_bits 16 with
chunked prefill, also speculating, 8 and 4, a pool small enough to
preempt): the decode
step over the block arenas and tables, the paged prefill buckets (which
commit into the slot's blocks) and the chunk continuations, whose slot,
table row, committed length and true length are static inputs too.

xLSTM's decode step is held the same way (contiguous and paged: its
recurrent state, updated in place, is pass-through in a paged tree), and
its exact-length eager prefills read nothing back to the host; the
construction puts back the state init_cache made (sLSTM's ``n`` =
1e-6), not zeros.

On the card (marked ``cuda``, skipped here) a replayed decode step and a
replayed prefill bucket equal the eager ones bitwise, and the launch
counts of the replays are the capture's counts times the replays.

This file imports no JAX: the steps are held to themselves, and the
engine's streams to the JAX engine's in ``test_torch_engine.py`` and
``test_torch_kvvq.py``.
"""
import dataclasses
import gc
import weakref
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import kernels
from repro_torch.configs import get_smoke_config
from repro_torch.core import calibrate
from repro_torch.core import plan as plan_mod
from repro_torch.core.logits_vq import synthetic_logits_vq
from repro_torch.core.plan import PlanPolicy
from repro_torch.models import RunConfig, build_model
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import graphs
from repro_torch.serve import paging
from repro_torch.serve.kvcache import pad_prefill_cache

# ops that read a device value back to the host, or make a tensor from
# host data (``torch.tensor``, ``torch.from_numpy``)
HOST_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.item",
            "aten.lift_fresh", "aten.lift_fresh_copy", "aten.masked_select")
PROMPT_LENS = (5, 9, 7)            # buckets 8 and 16
MAX_NEW = 4
# kv_bits, EVA backend, speculate_k, LM head
CASES = [(kv_bits, backend, 0, "w") for kv_bits in (16, 8, 4)
         for backend in ("eva_fused", "eva_split")]
CASES += [(16, "eva_fused", 2, "w"), (4, "eva_fused", 2, "w"),
          (16, "eva_fused", 0, "vql")]


def _leaves(tree):
    """Every tensor of a params or cache tree (VQWeight fields too)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


class _StepOps(TorchDispatchMode):
    """Records each aten op of a step, and each tensor an op reads that
    neither an earlier op of the step made nor the step was handed."""

    def __init__(self, inputs):
        super().__init__()
        self.made = {id(t): t for t in inputs}
        self.ops, self.foreign = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.Tensor) and id(a) not in self.made:
                self.foreign.append((str(func), a))
        self.ops.append(str(func.overloadpacket))
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.made[id(t)] = t
        return out


def _recording(calls):
    class Recording(graphs.StepGraph):
        """The engine's StepGraph, its function run under ``_StepOps``."""

        def __init__(self, fn, inputs, device, **kw):
            log = []
            calls.append((tuple(inputs), log))

            def step(**static):
                mode = _StepOps(static.values())
                with mode:
                    out = fn(**static)
                log.append({"inputs": dict(static), "ops": mode.ops,
                            "foreign": mode.foreign})
                return out

            super().__init__(step, inputs, device, **kw)

    return Recording


def _pin_split(planner):
    entry = lambda us: calibrate.BackendCalibration(
        overhead_us=us, us_per_mac=0.0, us_per_add=0.0, us_per_byte=0.0,
        rows=calibrate.MIN_FIT_ROWS)
    planner.reload_calibration(calibrate.Calibration(
        calibrate.SCHEMA, "pinned: eva_split below eva_fused",
        {"eva_fused": entry(1e6), "eva_split": entry(1.0)}))
    planner.cache_clear()


def _model_and_params(device):
    cfg = get_smoke_config("llama2_7b")
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.quantize(model.init(gen, device=device), method="synthetic",
                            generator=gen,
                            device=device)
    return model, params


def _engine(model, params, kv_bits, device, speculate_k=0):
    rc = RunConfig(attn_chunk=16, plan_policy=PlanPolicy(
        impl="cuda", int8_prefill=kv_bits == 4))
    return Engine(model, params, rc,
                  EngineConfig(num_slots=2, max_len=32, kv_bits=kv_bits,
                               speculate_k=speculate_k), device=device)


def _case_id(kv_bits, backend, spec_k, head):
    return (f"kv{kv_bits}-{backend}" + (f"-spec{spec_k}" if spec_k else "")
            + ("-vql" if head == "vql" else ""))


@pytest.fixture(scope="module")
def model_params():
    return _model_and_params("cpu")


@pytest.fixture(scope="module", params=CASES,
                ids=[_case_id(*c) for c in CASES])
def served(request, model_params):
    """An engine built and driven with every step recorded: three
    requests over two prefill buckets, two slots."""
    kv_bits, backend, spec_k, head = request.param
    model, params = model_params
    if head == "vql":
        gen = torch.Generator().manual_seed(1)
        params = dict(params, lm_head={"vql": synthetic_logits_vq(
            gen, model.cfg.d_model, model.cfg.padded_vocab, 24)})
    planner = plan_mod.default_planner()
    before = planner.calibration
    calls = []
    try:
        if backend == "eva_split":
            _pin_split(planner)
        with mock.patch.object(engine_mod, "StepGraph", _recording(calls)):
            eng = _engine(model, params, kv_bits, "cpu", spec_k)
            fresh = [t.clone() for t in _leaves(eng.caches)]
            rng = np.random.default_rng(kv_bits)
            prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
                       for n in PROMPT_LENS]
            out = eng.generate(prompts, MAX_NEW)
    finally:
        planner.reload_calibration(before)
        planner.cache_clear()
    return {"eng": eng, "calls": calls, "fresh": fresh, "out": out,
            "backend": backend, "kv_bits": kv_bits, "model": model}


def test_engine_hands_each_step_to_a_step_graph(served):
    eng, calls = served["eng"], served["calls"]
    backends = {pl.backend for _, pl in eng.plans["decode"]
                if pl.spec.kind == "vq"}
    assert backends == {served["backend"]}
    assert [names for names, _ in calls] == [("tokens", "positions"),
                                             ("tokens",), ("tokens",)]
    assert eng.trace_counts == {"decode": 1, "prefill": 2}
    assert sorted(eng.prefill_graphs) == [8, 16]
    decode_calls = len(calls[0][1])
    # the warm-up at construction, then one call a decode step
    assert decode_calls == 1 + eng.metrics()["decode_steps"]
    assert all(len(out) == MAX_NEW for out in served["out"].values())


def test_steps_read_nothing_from_the_host(served):
    eng = served["eng"]
    # made once at construction: params, caches, the stacked KV codebooks,
    # the successor table
    resident = {id(t) for t in _leaves((eng.params, eng.caches,
                                        getattr(eng, "_kv_cb", None),
                                        eng.succ))}
    for names, log in served["calls"]:
        assert log, names
        for call in log:
            host = sorted({op for op in call["ops"] if op in HOST_OPS})
            assert not host, (names, host)
            foreign = [(op, tuple(t.shape), t.dtype)
                       for op, t in call["foreign"] if id(t) not in resident]
            assert not foreign, (names, foreign)


def test_steps_get_the_same_static_inputs(served):
    for names, log in served["calls"]:
        assert len(log) >= 2, names
        first = log[0]["inputs"]
        for call in log[1:]:
            assert call["inputs"].keys() == first.keys()
            for n, t in call["inputs"].items():
                assert t is first[n] and t.data_ptr() == first[n].data_ptr()


def test_construction_leaves_the_caches_as_init_cache_made_them(served):
    eng, model = served["eng"], served["model"]
    kw = ({"kv_int8": True} if served["kv_bits"] == 8 else
          {"kvq": eng.kvq} if eng.kvq is not None else {})
    want = list(_leaves(model.init_cache(2, 32, device="cpu", **kw)))
    got = served["fresh"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# kv_bits, prefill_chunk, speculate_k
PAGED_CASES = [(16, 4, 0), (8, None, 0), (4, None, 0), (16, 4, 2)]
PAGED_PROMPT_LENS = (12, 9, 6, 11, 5)


@pytest.fixture(scope="module", params=PAGED_CASES,
                ids=[f"kv{k}-chunk{c}" + (f"-spec{s}" if s else "")
                     for k, c, s in PAGED_CASES])
def paged_served(request, model_params):
    """A paged engine (8 blocks of 4 for 2 slots of 32: it preempts)
    built and driven with every step recorded."""
    kv_bits, chunk, spec_k = request.param
    model, params = model_params
    calls = []
    rc = RunConfig(attn_chunk=16, plan_policy=PlanPolicy(
        impl="cuda", int8_prefill=kv_bits == 4))
    with mock.patch.object(engine_mod, "StepGraph", _recording(calls)):
        eng = Engine(model, params, rc, EngineConfig(
            num_slots=2, max_len=32, kv_bits=kv_bits, paged=True,
            block_size=4, num_blocks=8, prefill_chunk=chunk,
            speculate_k=spec_k), device="cpu")
        fresh = [t.clone() for t in _leaves(eng.caches)]
        rng = np.random.default_rng(kv_bits)
        prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
                   for n in PAGED_PROMPT_LENS]
        out = eng.generate(prompts, 2 * MAX_NEW)
    return {"eng": eng, "calls": calls, "fresh": fresh, "out": out,
            "kv_bits": kv_bits, "chunk": chunk, "model": model}


def test_paged_engine_hands_each_step_to_a_step_graph(paged_served):
    eng, calls = paged_served["eng"], paged_served["calls"]
    names = [n for n, _ in calls]
    assert names[0] == ("tokens", "positions")
    prefill = ("tokens", "slot", "bt_row", "true_len")
    chunk = ("tokens", "slot", "bt_row", "hist", "true_len")
    assert set(names[1:]) == ({prefill, chunk} if paged_served["chunk"]
                              else {prefill})
    assert eng.trace_counts["decode"] == 1
    assert eng.trace_counts["prefill"] == names.count(prefill)
    m = eng.metrics()
    assert m["preemptions"] >= 1
    if paged_served["chunk"]:
        assert eng.trace_counts["prefill_chunk"] == names.count(chunk) >= 1
        assert m["prefill_chunks"] >= 1
    assert m["blocks_in_use"] == 0
    assert len(calls[0][1]) == 1 + m["decode_steps"]
    assert all(len(o) == 2 * MAX_NEW for o in paged_served["out"].values())


def test_paged_steps_read_nothing_from_the_host(paged_served):
    test_steps_read_nothing_from_the_host(paged_served)


def test_paged_steps_get_the_same_static_inputs(paged_served):
    test_steps_get_the_same_static_inputs(paged_served)


def test_paged_construction_leaves_the_cache_as_init_cache_made_it(
        paged_served):
    """Arenas zero (the decode build's warm-up wrote only the sink, then
    everything was put back) and every table entry the sentinel."""
    eng, model = paged_served["eng"], paged_served["model"]
    kw = ({"kv_int8": True} if paged_served["kv_bits"] == 8 else
          {"kvq": eng.kvq} if eng.kvq is not None else {})
    want = list(_leaves(model.init_cache(2, 32, device="cpu",
                                         paging=eng.paging, **kw)))
    got = paged_served["fresh"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert paging.is_paged(eng.caches)
    assert (eng.tables == eng.paging.sentinel).all()  # drained: all freed


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_dropped_engine_is_freed_without_a_collection(model_params, kv_bits):
    """Nothing an engine's steps hold refers back to the engine, so a
    dropped engine and its graphs are freed by reference counting at
    once: never by a garbage collection, which on the card could free a
    graph during another engine's capture."""
    model, params = model_params
    collecting = gc.isenabled()
    gc.disable()
    try:
        eng = _engine(model, params, kv_bits, "cpu")
        eng.generate([np.arange(5, dtype=np.int32)], 2)
        assert eng.trace_counts == {"decode": 1, "prefill": 1}
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


def test_step_graph_on_cpu_restores_state_and_counts_nothing():
    """On the CPU a StepGraph runs its function directly over the static
    buffers. The warm-up runs it once, and its in-place writes stay for
    the caller to restore, as the engine puts its caches back; no kernel
    count moves."""
    state = torch.arange(4.0)
    seen = []

    def fn(x):
        seen.append(x)
        state.add_(x[:, 0])
        return state * 2

    kernels.reset_launch_counts()
    step = graphs.StepGraph(fn, {"x": ((4, 1), torch.float32)},
                            torch.device("cpu"))
    assert len(seen) == 1 and seen[0] is step.inputs.dev["x"]
    assert step.inputs.dev["x"].eq(0).all()  # the warm-up's input
    state.copy_(torch.arange(4.0))
    assert step.graph is None and step.launches == {}
    out = step(x=np.ones(4, np.float32))
    assert torch.equal(out, (torch.arange(4.0) + 1) * 2)
    out = step(x=np.full((4, 1), 2, np.float32))
    assert torch.equal(out, (torch.arange(4.0) + 3) * 2)
    assert seen[1] is seen[2] is step.inputs.dev["x"]
    assert set(kernels.launch_counts().values()) == {0}


def test_launch_counts_set_and_read_back():
    counts = {n: i for i, n in enumerate(kernels.wrappers())}
    kernels.set_launch_counts(counts)
    try:
        assert kernels.launch_counts() == counts
        some = dict(list(counts.items())[1:3])
        kernels.add_launch_counts({n: 10 for n in some})
        assert kernels.launch_counts() == {
            n: k + (10 if n in some else 0) for n, k in counts.items()}
    finally:
        kernels.reset_launch_counts()


# ---------------------------------------------------------------- xlstm


def _recording_eager(calls):
    class Recording(graphs.EagerStep):
        """The engine's EagerStep (an exact-length prefill), its function
        run under ``_StepOps``."""

        def __init__(self, fn, inputs, device):
            log = []
            calls.append((tuple(inputs), log))

            def step(**static):
                mode = _StepOps(static.values())
                with mode:
                    out = fn(**static)
                log.append({"inputs": dict(static), "ops": mode.ops,
                            "foreign": mode.foreign})
                return out

            super().__init__(step, inputs, device)

    return Recording


@pytest.fixture(scope="module", params=[False, True],
                ids=["contiguous", "paged"])
def xlstm_served(request):
    """xlstm SMOKE with 2-bit VQ weights: an engine built and driven with
    its decode StepGraph and its exact-length eager prefills recorded."""
    cfg = get_smoke_config("xlstm_125m")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.quantize(model.init(gen, device="cpu"), method="synthetic",
                            generator=gen,
                            device="cpu")
    calls, eager = [], []
    kw = {"paged": True, "block_size": 4} if request.param else {}
    with mock.patch.object(engine_mod, "StepGraph", _recording(calls)), \
            mock.patch.object(engine_mod, "EagerStep",
                              _recording_eager(eager)):
        eng = Engine(model, params, RunConfig(attn_chunk=16),
                     EngineConfig(num_slots=2, max_len=32, **kw),
                     device="cpu")
        fresh = [t.clone() for t in _leaves(eng.caches)]
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in PROMPT_LENS]
        out = eng.generate(prompts, MAX_NEW)
    return {"eng": eng, "calls": calls, "eager": eager, "fresh": fresh,
            "out": out, "model": model}


def test_xlstm_decode_step_reads_nothing_from_the_host(xlstm_served):
    """The recurrent decode step (its state updated in place) under the
    same guard: no host op, and nothing read but params, state leaves and
    its static inputs; the eager exact-length prefills read nothing back
    to the host either."""
    eng = xlstm_served["eng"]
    assert [names for names, _ in xlstm_served["calls"]] == [
        ("tokens", "positions")]
    assert len(xlstm_served["calls"][0][1]) == \
        1 + eng.metrics()["decode_steps"]
    assert len(xlstm_served["eager"]) == len(set(PROMPT_LENS))
    test_steps_read_nothing_from_the_host(xlstm_served)
    for names, log in xlstm_served["eager"]:
        for call in log:
            assert not {op for op in call["ops"] if op in HOST_OPS}, names
    assert all(len(o) == MAX_NEW for o in xlstm_served["out"].values())


def test_xlstm_construction_leaves_the_state_as_init_cache_made_it(
        xlstm_served):
    """The decode build's warm-up stepped every slot's state; the engine
    put back init_cache's values (sLSTM's ``n`` = 1e-6 contiguous, zeros
    as a paged tree holds pass-through state), not zeros everywhere."""
    eng, model = xlstm_served["eng"], xlstm_served["model"]
    want = list(_leaves(model.init_cache(2, 32, device="cpu",
                                         paging=eng.paging)))
    got = xlstm_served["fresh"]
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert any(bool(t.any()) for t in got) == (eng.paging is None)


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv_bits", [16, 4])
def test_replay_equals_eager_bitwise_on_card(cuda, kv_bits):
    model, params = _model_and_params("cuda")
    eng = _engine(model, params, kv_bits, "cuda")
    assert all(not bool(t.any()) for t in _leaves(eng.caches))
    rc, vocab = eng.rc, model.cfg.vocab_size
    gen = np.random.default_rng(kv_bits)

    # prefill buckets 8 and 16, captured in that order into the engine's
    # one pool and replayed 16, 8, 16: each replay against the eager
    # prefill (+ encode)
    built = {b: eng.prefill_graph(b) for b in (8, 16)}
    for bucket in (16, 8, 16):
        step = built[bucket]
        toks = gen.integers(0, vocab, (1, bucket)).astype(np.int32)
        kernels.reset_launch_counts()
        logits, cache = step(tokens=toks)
        got = [logits.clone(), *(t.clone() for t in _leaves(cache))]
        assert kernels.launch_counts() == {
            n: step.launches.get(n, 0) for n in kernels.wrappers()}
        with torch.no_grad():  # the graph's own function, run eagerly
            want = list(_leaves(step.fn(
                tokens=torch.from_numpy(toks).to(cuda))))
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), bucket
    assert eng.trace_counts == {"decode": 1, "prefill": 2}

    # decode: the prefilled cache in every slot, then 8 steps replayed on
    # the engine's caches and run eagerly on a clone
    padded = pad_prefill_cache(cache, 32, true_len=16)
    for b in range(2):
        engine_mod._insert_slot(eng.caches, padded, b)
    plain = {"body": {n: t.clone() for n, t in eng.caches["body"].items()}}
    steps = 8
    toks = gen.integers(0, vocab, (steps, 2, 1)).astype(np.int32)
    pos = np.broadcast_to(16 + np.arange(steps, dtype=np.int32)[:, None, None],
                          toks.shape).copy()
    kernels.reset_launch_counts()
    got = [eng.decode_graph(tokens=toks[i], positions=pos[i]).clone()
           for i in range(steps)]
    assert kernels.launch_counts() == {
        n: steps * eng.decode_graph.launches.get(n, 0)
        for n in kernels.wrappers()}
    assert eng.decode_graph.launches and eng.trace_counts["decode"] == 1
    for i in range(steps):
        with torch.no_grad():
            want, _ = model.decode(eng.params, torch.from_numpy(toks[i]).to(cuda),
                                   torch.from_numpy(pos[i]).to(cuda), plain,
                                   rc.replace(mode="decode"))
        assert torch.equal(got[i], want[:, 0, :vocab]), i
    for n, t in eng.caches["body"].items():
        assert torch.equal(t, plain["body"][n]), n


@pytest.mark.cuda
def test_speculative_replay_equals_eager_bitwise_on_card(cuda):
    """A speculative engine's decode graph (the verify window, K = 2)
    replayed on a prefilled cache against ``verify_logits`` run eagerly
    on a clone, each step followed on both sides by the eager part: the
    logits and windows of every step, and the caches and successor
    tables after the last, bitwise equal."""
    from repro_torch.serve import speculative

    model, params = _model_and_params("cuda")
    eng = _engine(model, params, 16, "cuda", speculate_k=2)
    vocab = model.cfg.vocab_size
    gen = np.random.default_rng(5)
    toks = torch.from_numpy(gen.integers(0, vocab, (1, 16)).astype(np.int32))
    _, cache = model.prefill(eng.params, {"tokens": toks.to(cuda)},
                             eng.rc.replace(mode="prefill"))
    padded = pad_prefill_cache(cache, 32, true_len=16)
    for b in range(2):
        engine_mod._insert_slot(eng.caches, padded, b)
    plain = {"body": {n: t.clone() for n, t in eng.caches["body"].items()}}
    eng.succ.copy_(torch.from_numpy(
        gen.integers(-1, vocab, tuple(eng.succ.shape)).astype(np.int32)))
    succ = eng.succ.clone()
    on = lambda a, dt: torch.as_tensor(a, dtype=dt, device=cuda)
    knobs = {"generators": [None, None], "greedy": [True, True],
             "temperature": on([1.0, 1.0], torch.float32),
             "top_k": on([0, 0], torch.int32),
             "top_p": on([1.0, 1.0], torch.float32),
             "stop_ids": on([[-1], [-1]], torch.int32),
             "remaining": on([32, 32], torch.int32),
             "active": on([True, True], torch.bool),
             "spec_on": on([True, True], torch.bool)}
    pos = np.full((2, 1), 16, np.int32)
    for i in range(4):
        last = gen.integers(0, vocab, (2, 1)).astype(np.int32)
        got = [t.clone() for t in eng.decode_graph(tokens=last, positions=pos)]
        with torch.no_grad():
            want = speculative.verify_logits(
                model, eng.params, plain, succ, on(last, torch.int32),
                on(pos, torch.int32), eng._rc_decode, 2)
            e = [speculative.settle_window(*out, caches, table, **knobs)[2]
                 for out, caches, table in ((got, eng.caches, eng.succ),
                                            (want, plain, succ))]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), i
        assert torch.equal(e[0], e[1]), i
        pos = pos + e[0].cpu().numpy()[:, None]
    assert eng.trace_counts["decode"] == 1
    assert torch.equal(eng.succ, succ)
    for n, t in eng.caches["body"].items():
        assert torch.equal(t, plain["body"][n]), n
