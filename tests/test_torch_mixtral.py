"""mixtral-8x22b in the port (top-2 MoE, sliding-window rings) held
against the JAX reference on the CPU at its SMOKE config (2 layers, 4
experts, window 64) at fp32, with the reference's params converted (the
synthetic quantization's salt pinned):

  * ring conversion (``serve/kvcache.py``: ``_to_ring``,
    ``_to_ring_dynamic``, ``pad_prefill_cache(window=...)``) bit-equal to
    the reference at ``tests/test_kvcache.py``'s edge cases, with int and
    device-tensor true lengths;
  * windowed ``blocked_attention`` and ring ``decode_attention`` within
    1e-5 x max|o|;
  * the model's prefill logits over a prompt longer than the window and
    its decode logits past it, over fp, int8 and KV-VQ (4-bit) rings,
    within 1e-4 x max|logit|;
  * greedy ``Engine`` streams identical to the JAX engine's, prompts
    longer than the window, a decode budget past ``max_len`` (a ring
    admits it): fp, kv_bits 8 and 4 and the split-pinned planner; the
    exact-length prefill (one build per distinct length) and the expert
    plans at their capacity;
  * inside the port: a paged ring gives the contiguous ring's streams
    exactly, and a ring engine snapshotted mid-run and restored into a
    fresh engine gives the uninterrupted run's;
  * B1's and B3's launch shapes at every mixtral linear, full width
    included.
"""
import dataclasses
import functools
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.core import quantize as jq
from repro.core import vq as jvq
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve import kvcache as jkv
from repro_torch import configs as tconfigs
from repro_torch.convert import from_jax_params
from repro_torch.core import calibrate
from repro_torch.core import plan as plan_mod
from repro_torch.core import quantize as tq
from repro_torch.core import vq as tvq
from repro_torch.kernels.dequant_gemv.ops import TOKEN_TILES, launch_shape
from repro_torch.kernels.eva_lookup import tiles
from repro_torch.kernels.fused_vq_matmul.ops import select_split
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as tcm
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams)
from repro_torch.serve import kvcache as tkv

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCH = "mixtral_8x22b"
WINDOW, MAX_LEN, SLOTS, NEW = 64, 96, 2, 8
PROMPTS = (70, 9, 90, 33, 65)        # three past the window


def _stable_hash(s: str) -> int:
    """A process-independent stand-in for ``hash`` of a string."""
    return zlib.crc32(s.encode())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    dense = jm.init(KEY)
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(dense, method="synthetic", key=KEY)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32")
    rng = np.random.default_rng(0)
    return {"jm": jm, "jcfg": jcfg, "m": build_model(cfg), "cfg": cfg,
            "jp": vq, "tp": _conv(vq),
            "prompts": [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                        for n in PROMPTS]}


def _conv(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def test_config_and_smoke_equal_reference():
    for name in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tconfigs, name)(ARCH)) == \
            dataclasses.asdict(getattr(jconfigs, name)(ARCH)), name
    assert tconfigs.get_config("mixtral-8x22b") == tconfigs.get_config(ARCH)
    build_model(tconfigs.get_config(ARCH))


# ------------------------------------------------------- ring conversion


def _attn_cache(S, int8=False, seed=0, B=1, Hk=2, hd=4):
    rng = np.random.default_rng(seed)
    c = {"k": rng.normal(size=(B, S, Hk, hd)).astype(np.float32),
         "v": rng.normal(size=(B, S, Hk, hd)).astype(np.float32),
         "len": np.full((B,), S, np.int32)}
    if int8:
        c["k"] = (c["k"] * 10).astype(np.int8)
        c["v"] = (c["v"] * 10).astype(np.int8)
        for n in ("k_s", "v_s"):
            c[n] = rng.normal(size=(B, S, Hk)).astype(np.float32)
    return c


def _both_caches(c):
    """(jax, port) copies; the scale leaves bf16 in both."""
    j = {n: (jnp.asarray(a).astype(jnp.bfloat16) if n.endswith("_s")
             else jnp.asarray(a)) for n, a in c.items()}
    t = {n: (_t(a).to(torch.bfloat16) if n.endswith("_s") else _t(a))
         for n, a in c.items()}
    return j, t


def _assert_equal_trees(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, n
        np.testing.assert_array_equal(g, w, err_msg=n)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("S,window,cap", [
    (8, 8, 16),      # S == window: identity
    (13, 8, 16),     # wraps: the newest position of each slot
    (12, 16, 8),     # window > capacity: a ring of capacity
    (5, 8, 32),      # short: padded to the ring
    (20, 8, 8),
    (6, 0, 12),      # no window: padded to capacity
])
def test_pad_prefill_cache_rings_as_reference(S, window, cap, int8):
    j, t = _both_caches(_attn_cache(S, int8=int8))
    _assert_equal_trees(tkv.pad_prefill_cache(t, cap, window=window),
                        jkv.pad_prefill_cache(j, cap, window=window))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("S,ring,true_len", [
    (16, 8, 0), (16, 8, 8), (16, 8, 5), (16, 8, 13), (16, 8, 16),
    (4, 8, 3), (12, 8, 12), (70, 64, 70), (64, 64, 9)])
def test_to_ring_dynamic_bit_equal(S, ring, true_len, as_tensor):
    x = np.arange(S * 3, dtype=np.float32).reshape(1, S, 3) + 1
    want = jkv._to_ring_dynamic(jnp.asarray(x), 1, ring,
                                jnp.asarray(true_len, jnp.int32))
    tl = torch.tensor([true_len], dtype=torch.int32) if as_tensor else true_len
    got = tkv._to_ring_dynamic(_t(x), 1, ring, tl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S,ring", [(8, 8), (13, 8), (5, 8), (70, 64)])
def test_to_ring_bit_equal(S, ring):
    x = np.random.default_rng(S).normal(size=(2, S, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tkv._to_ring(_t(x), 1, ring).numpy(),
        np.asarray(jkv._to_ring(jnp.asarray(x), 1, ring)))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("true_len", [0, 5, 8, 11, 16])
def test_pad_prefill_cache_true_len_bit_equal(true_len, int8):
    """The contiguous engine's call: a prompt's cache in its buffer, its
    true length an int."""
    j, t = _both_caches(_attn_cache(16, int8=int8, seed=true_len))
    want = jkv.pad_prefill_cache(j, 16, window=8,
                                 true_len=jnp.asarray(true_len, jnp.int32))
    _assert_equal_trees(tkv.pad_prefill_cache(t, 16, window=8,
                                              true_len=true_len), want)


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("window,chunk", [(0, 16), (8, 16), (16, 7), (33, 64)])
def test_blocked_attention_window_matches_reference(window, chunk):
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal((2, 40, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    want = jcm.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=window,
                                 chunk=chunk)
    got = tcm.blocked_attention(_t(q), _t(k), _t(v), chunk=chunk,
                                window=window)
    _close(got.numpy(), want, 1e-5)


def test_ring_decode_attention_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((3, 16, 2, 8)).astype(np.float32)
            for _ in range(2))
    lens = np.array([5, 16, 23], np.int32)     # partial, full, wrapped
    want = jcm.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lens), window=16, ring=True)
    got = tcm.decode_attention(_t(q), _t(k), _t(v), _t(lens), ring=True)
    _close(got.numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="one token at a time"):
        tcm.decode_attention(_t(np.concatenate([q, q], 1)), _t(k), _t(v),
                             _t(lens), ring=True)


# ------------------------------------------------------------------ model


def _kv_params(s, kv_bits):
    """(jax params, port params, jax kvq, port kvq) for a cache layout."""
    if kv_bits != 4:
        return s["jp"], s["tp"], None, None
    jk, tk = jvq.KVQuantConfig(kv_bits=4), tvq.KVQuantConfig(kv_bits=4)
    jp = jq.attach_kv_codebooks(s["jp"], s["jcfg"], jk)
    return jp, _conv(jp), jk, tk


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_logits_past_the_window_match_jax(kv_bits):
    """An 80-token prompt (past the 64-token window) on two rows: prefill
    logits; then the reference's fp prefill cache (both sides start from
    the same values: an int8 or KV-VQ code at a rounding edge would
    otherwise flip on fp32 reassociation alone) quantized and converted
    to the engine's ring layout by each package, then 5 decode steps
    that wrap it: logits within 1e-4 x max|logit|. The reference decodes
    op by op (``jax.disable_jit``): jitted on the CPU, XLA drops the bf16
    rounding of the int8 cache's dequantized rows (``k.astype(bf16) *
    k_s``, then fp32 scores), which the port, like the reference's own
    ops, rounds."""
    s = _setup()
    jp, tp, jk, tk = _kv_params(s, kv_bits)
    toks = np.random.default_rng(7).integers(0, 512, (2, 85)).astype(np.int32)
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=16, kv_vq=jk)
    trc = RunConfig(mode="prefill", attn_chunk=16, kv_vq=tk)
    want, jc = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks[:, :80])}, jrc)
    with torch.no_grad():
        got, _ = s["m"].prefill(tp, {"tokens": _t(toks[:, :80])}, trc)
    _close(got.numpy(), want, 1e-4)
    tc = {"body": {n: _t(np.array(a)) for n, a in jc["body"].items()}}
    if kv_bits == 8:
        jc, tc = (jkv.quantize_prefill_cache_int8(jc),
                  tkv.quantize_prefill_cache_int8(tc))
    elif kv_bits == 4:
        jc = jkv.encode_prefill_cache(jc, jq.kv_codebook_tree(jp), jk)
        tc = tkv.encode_prefill_cache(tc, tq.kv_codebook_tree(tp), tk)
    jc = jkv.pad_prefill_cache(jc, MAX_LEN, window=WINDOW)
    tc = tkv.pad_prefill_cache(tc, MAX_LEN, window=WINDOW)
    assert tc["body"]["k"].shape[2] == WINDOW
    for i in range(5):
        pos = 80 + i
        with jax.disable_jit():
            want, jc = s["jm"].decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                                      jnp.full((2, 1), pos, jnp.int32), jc,
                                      jrc.replace(mode="decode"))
        with torch.no_grad():
            got, tc = s["m"].decode(tp, _t(toks[:, pos:pos + 1]),
                                    torch.full((2, 1), pos, dtype=torch.int32),
                                    tc, trc.replace(mode="decode"))
        _close(got.numpy(), want, 1e-4)
    assert tc["body"]["len"].tolist() == [[85, 85]] * 2
    assert {n: tuple(t.shape) for n, t in tc["body"].items()} == \
        {n: tuple(a.shape) for n, a in jc["body"].items()}


# ----------------------------------------------------------------- engine


@pytest.fixture
def split_pinned():
    """The default planner ranks ``eva_split`` below ``eva_fused``;
    restored after."""
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


@functools.lru_cache(maxsize=None)
def _jax_streams(kv_bits):
    s = _setup()
    jrc = jcm.RunConfig(mode="decode", remat=False, attn_chunk=16)
    return JaxEngine(s["jm"], s["jp"], jrc, JaxEngineConfig(
        num_slots=SLOTS, max_len=MAX_LEN, kv_bits=kv_bits)).generate(
            s["prompts"], NEW)


def _engine(s, **kw):
    return Engine(s["m"], s["tp"], RunConfig(attn_chunk=16), EngineConfig(
        **{"num_slots": SLOTS, "max_len": MAX_LEN, **kw}), device="cpu")


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_greedy_streams_identical_to_jax_engine(kv_bits):
    s = _setup()
    eng = _engine(s, kv_bits=kv_bits)
    assert eng.generate(s["prompts"], NEW) == _jax_streams(kv_bits)
    # exact-length prefill: one (eager) step a distinct prompt length
    assert eng.trace_counts == {"decode": 1, "prefill": len(set(PROMPTS))}
    assert set(eng.plans) == {"decode", "prefill@cap"}
    cap = tcm.moe_capacity(s["cfg"], SLOTS)
    for path, pl in eng.plans["decode"]:
        if pl.spec.kind == "vq":
            assert pl.spec.M == (cap if "experts" in path else SLOTS), path
    assert cache_ring(eng) == WINDOW


def cache_ring(eng):
    return eng.caches["body"]["k"].shape[2]


def test_split_pinned_streams_identical_to_jax_engine(split_pinned):
    s = _setup()
    eng = _engine(s)
    assert {pl.backend for _, pl in eng.plans["decode"]
            if pl.spec.kind == "vq"} == {"eva_split"}
    assert eng.generate(s["prompts"], NEW) == _jax_streams(16)


def test_ring_admits_a_budget_past_max_len():
    """A windowed cache wraps: a request whose prompt + budget passes
    max_len is admitted (a full cache would reject it) and decodes past
    max_len through the ring, as the JAX engine does."""
    s = _setup()
    prompt = s["prompts"][2]                       # 90 tokens, max_len 96
    jrc = jcm.RunConfig(mode="decode", remat=False, attn_chunk=16)
    want = JaxEngine(s["jm"], s["jp"], jrc, JaxEngineConfig(
        num_slots=SLOTS, max_len=MAX_LEN)).generate([prompt], 12)
    got = _engine(s).generate([prompt], 12)
    assert got == want and [len(t) for t in got.values()] == [12]


@pytest.mark.parametrize("kv_bits,block", [(16, 16), (16, 8), (8, 16), (4, 16)])
def test_paged_ring_equals_contiguous_ring(kv_bits, block):
    s = _setup()
    want = _engine(s, kv_bits=kv_bits).generate(s["prompts"], NEW)
    eng = _engine(s, kv_bits=kv_bits, paged=True, block_size=block)
    assert eng.paging.page_len == WINDOW
    assert eng.paging.blocks_per_slot == WINDOW // block
    assert eng.generate(s["prompts"], NEW) == want
    m = eng.metrics()
    assert m["blocks_in_use"] == 0
    assert m["peak_blocks_in_use"] <= SLOTS * WINDOW // block
    assert "prefill_chunk" not in eng.trace_counts


@pytest.mark.parametrize("kw", [{}, {"kv_bits": 4},
                                {"paged": True, "block_size": 16}],
                         ids=["fp", "kv4", "paged"])
def test_ring_snapshot_restore_equals_uninterrupted(kw):
    """Snapshot after the third tick (the long prompts' rings wrapped),
    restore into a fresh engine: the same streams."""
    s = _setup()
    reqs = [GenerationRequest(prompt=p, max_new_tokens=NEW,
                              sampling=SamplingParams())
            for p in s["prompts"][:3]]
    eng = _engine(s, **kw)
    uids = [eng.submit(r) for r in reqs]
    snap, t = None, 0
    while not eng.idle:
        eng.step()
        t += 1
        if t == 3:
            snap = eng.snapshot()
    want = {u: eng.output(u).tokens for u in uids}
    eng2 = _engine(s, **kw)
    eng2.restore(snap)
    while not eng2.idle:
        eng2.step()
    assert {u: eng2.output(u).tokens for u in uids} == want


# --------------------------------------------------------- launch shapes


def _linears(cfg):
    """(name, K, N) of every VQ linear of a mixtral layer, and the rows
    each runs at in decode at 4 slots and in prefill of a 4160-token
    prompt (the experts at their capacity)."""
    E_cap = lambda T: tcm.moe_capacity(cfg, T)
    dff = cfg.moe_d_ff
    return [("wqkv", cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim, 4, 4160),
            ("wo", cfg.q_dim, cfg.d_model, 4, 4160),
            ("gu", cfg.d_model, 2 * dff, E_cap(4), E_cap(4160)),
            ("down", dff, cfg.d_model, E_cap(4), E_cap(4160))]


@pytest.mark.parametrize("arch", ["full", "smoke"])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
def test_b1_launch_shape_at_every_mixtral_linear(arch, M):
    """The fused kernel's tile model places every decode linear: covers V
    and N, fits 227 KB, at M <= 4 one wave of the card."""
    cfg = (tconfigs.get_config if arch == "full"
           else tconfigs.get_smoke_config)(ARCH)
    for name, K, N, _, _ in _linears(cfg):
        V = K // 8
        for recompute in (True, False):
            t = (select_split(M, V, N, C=2, sm_count=132) if recompute
                 else tiles.lookup_tiles(M, V, N, 2, 132, False))
            assert t.splits * t.slabs_per_split * t.vl >= V, name
            assert t.smem == tiles.smem_bytes(2, t.mw, t.bn, t.stages,
                                              recompute) <= 227 * 1024
            assert -(-N // t.bn) * t.bn >= N
            if M <= 4 and recompute:
                assert tiles.grid_ctas(t, M, N) <= 132 * t.groups, name
    assert tcm.moe_capacity(tconfigs.get_config(ARCH), 4) == 2


@pytest.mark.parametrize("arch", ["full", "smoke"])
def test_b3_launch_shape_at_every_mixtral_linear(arch):
    """dequant_gemv's launch shape at prefill (4160 tokens: the experts
    at M = 1300) and at decode rows: a token tile that exists, K splits
    that each keep at least one stage."""
    cfg = (tconfigs.get_config if arch == "full"
           else tconfigs.get_smoke_config)(ARCH)
    assert tcm.moe_capacity(tconfigs.get_config(ARCH), 4160) == 1300
    for name, K, N, m_dec, m_pre in _linears(cfg):
        V = K // 8
        for M in (m_dec, m_pre):
            T, splits = launch_shape(M, V, N, 132)
            assert T in TOKEN_TILES and T >= min(M, TOKEN_TILES[-1]), name
            assert 1 <= splits <= -(-V // 8)
            if M > 256 and arch == "full":   # the tiles fill the card
                assert T == 256 and splits == 1
