"""deepseek-v2-lite-16b in the port (MLA, a dense first layer, 64 routed
experts top-6 beside 2 shared) held against the JAX reference on the
CPU at its SMOKE config (3 layers: 1 dense, 2 MoE; 8 experts top-2) at
fp32, with the reference's params converted (the synthetic
quantization's salt pinned):

  * the config and registry, field for field the reference's;
  * the model's prefill logits and 3 decode steps from the reference's
    fp prefill cache (KV-VQ: encoded by each package), fp and 4-bit
    latents, expand and absorb, within 1e-5 x max|logit|;
  * greedy ``Engine`` streams identical to the JAX engine's: fp and
    kv_bits=4, contiguous and paged (the reference's ``PAGED_ARCHS`` and
    ``KVQ_ARCHS`` hold this arch), and the absorbed decode; the
    exact-length eager prefill, the experts planned at their capacity
    and the expand decode's ``wkv_b`` at slots x max_len;
  * the reference's refusals: kv_bits=8 and ``speculate_k`` raise, and
    chunked prefill stays off;
  * the engine's decode and prefill step functions under the no-host-sync
    dispatch mode of ``test_torch_graphs.py``;
  * a snapshot restored into a fresh engine gives the uninterrupted
    run's streams (fp, kv_bits=4, paged);
  * ``convert`` and the checkpoint files carry ``pre_layers`` and the MLA
    leaves (``wq_kva``, ``wkv_b``, ``kv_norm``, ``kv_cb.lat``) both ways,
    byte for byte;
  * B1's and B3's launch shapes at every deepseek linear at full width,
    ``wkv_b`` at the expand decode's M = slots x max_len included.
"""
import dataclasses
import functools
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint import manager as jmanager
from repro.core import quantize as jq
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve import kvcache as jkv
from repro.models import common as jcm
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import to_reference_layout
from repro_torch.core import plan as plan_mod
from repro_torch.core import quantize as tq
from repro_torch.kernels.dequant_gemv.ops import TOKEN_TILES, launch_shape
from repro_torch.kernels.eva_lookup import tiles
from repro_torch.kernels.fused_vq_matmul.ops import select_split
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as tcm
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import kvcache as tkv

from test_torch_checkpoint import _assert_bitwise, _npz_members
from test_torch_graphs import HOST_OPS, _StepOps, _leaves
from test_torch_mla import ARCH, _close, _t, setup
from test_torch_moe import _assert_same

torch.set_num_threads(1)
MAX_LEN, SLOTS, NEW = 48, 2, 8
PROMPTS = (13, 5, 30, 9, 21)


@functools.lru_cache(maxsize=None)
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32) for n in PROMPTS]


def test_config_and_registry_equal_reference():
    for name in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tconfigs, name)(ARCH)) == \
            dataclasses.asdict(getattr(jconfigs, name)(ARCH)), name
    assert tconfigs.get_config("deepseek-v2-lite-16b") == \
        tconfigs.get_config(ARCH)
    ids = tconfigs.ARCH_IDS
    assert ids.index("xlstm_125m") + 1 == ids.index(ARCH) == \
        ids.index("mixtral_8x22b") - 1
    model = build_model(tconfigs.get_config(ARCH))
    assert model.cfg.use_mla and model.cfg.first_dense_layers == 1


# ---------------------------------------------------------------------- model


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
@pytest.mark.parametrize("kv_bits", [16, 4])
def test_logits_match_jax(kv_bits, absorb):
    """Prefill logits of 20 tokens on two rows; then the reference's fp
    prefill cache (KV-VQ: encoded by each package, from the same values)
    padded to MAX_LEN by each package, and 3 decode steps."""
    s = setup()
    jp, tp = s["params"]["kv4" if kv_bits == 4 else "vq"]
    jk, tk = (s["jkvq"], s["tkvq"]) if kv_bits == 4 else (None, None)
    toks = np.random.default_rng(7).integers(0, 512, (2, 23)).astype(np.int32)
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=8, kv_vq=jk,
                        mla_absorb=absorb)
    trc = RunConfig(mode="prefill", attn_chunk=8, kv_vq=tk, mla_absorb=absorb)
    want, jc = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks[:, :20])}, jrc)
    with torch.no_grad():
        got, _ = s["m"].prefill(tp, {"tokens": _t(toks[:, :20])}, trc)
    _close(got.numpy(), want)
    tc = {seg: {n: _t(a) for n, a in node.items()} for seg, node in jc.items()}
    if kv_bits == 4:
        jc = jkv.encode_prefill_cache(jc, jq.kv_codebook_tree(jp), jk)
        tc = tkv.encode_prefill_cache(tc, tq.kv_codebook_tree(tp), tk)
    jc, tc = (jkv.pad_prefill_cache(jc, MAX_LEN),
              tkv.pad_prefill_cache(tc, MAX_LEN))
    for i in range(3):
        pos = 20 + i
        want, jc = s["jm"].decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                                  jnp.full((2, 1), pos, jnp.int32), jc,
                                  jrc.replace(mode="decode"))
        with torch.no_grad():
            got, tc = s["m"].decode(tp, _t(toks[:, pos:pos + 1]),
                                    torch.full((2, 1), pos, dtype=torch.int32),
                                    tc, trc.replace(mode="decode"))
        _close(got.numpy(), want)
    assert [tc[seg]["len"].tolist() for seg in ("pre", "body")] == \
        [[[23, 23]], [[23, 23]] * 2]
    for seg in ("pre", "body"):
        assert {n: tuple(t.shape) for n, t in tc[seg].items()} == \
            {n: tuple(a.shape) for n, a in jc[seg].items()}


# --------------------------------------------------------------------- engine


def _jax_engine_cfg(**kw):
    return JaxEngineConfig(**{"num_slots": SLOTS, "max_len": MAX_LEN, **kw})


@functools.lru_cache(maxsize=None)
def _jax_streams(kv_bits, paged, absorb):
    s = setup()
    jrc = jcm.RunConfig(mode="decode", remat=False, attn_chunk=16,
                        mla_absorb=absorb)
    kw = {"paged": True, "block_size": 8} if paged else {}
    return JaxEngine(s["jm"], s["params"]["vq"][0], jrc, _jax_engine_cfg(
        kv_bits=kv_bits, **kw)).generate(prompts(), NEW)


def _engine(s, absorb=False, **kw):
    return Engine(s["m"], s["params"]["vq"][1],
                  RunConfig(attn_chunk=16, mla_absorb=absorb),
                  EngineConfig(**{"num_slots": SLOTS, "max_len": MAX_LEN,
                                  **kw}), device="cpu")


STREAM_CASES = [(16, False, False), (4, False, False), (16, True, False),
                (4, True, False), (16, False, True)]


@pytest.mark.parametrize("kv_bits,paged,absorb", STREAM_CASES,
                         ids=["fp", "kv4", "paged", "kv4-paged", "absorb"])
def test_greedy_streams_identical_to_jax_engine(kv_bits, paged, absorb):
    s = setup()
    kw = {"paged": True, "block_size": 8} if paged else {}
    eng = _engine(s, absorb, kv_bits=kv_bits, **kw)
    assert eng.generate(prompts(), NEW) == _jax_streams(kv_bits, paged,
                                                        absorb)
    # exact-length prefill: one (eager) step a distinct prompt length
    assert eng.trace_counts == {"decode": 1, "prefill": len(set(PROMPTS))}
    cap = tcm.moe_capacity(s["cfg"], SLOTS)
    rows = {}
    for path, pl in eng.plans["decode"]:
        if pl.spec.kind == "vq":
            rows[path[-1] if "experts" not in path else "experts"] = \
                pl.spec.M
    assert rows == {"wq_kva": SLOTS, "wo": SLOTS, "gu": SLOTS,
                    "down": SLOTS, "experts": cap,
                    # absorbed, wkv_b is dequantized, not run: planned
                    # at the default rows
                    "wkv_b": SLOTS if absorb else SLOTS * MAX_LEN}
    if paged:
        assert eng.metrics()["blocks_in_use"] == 0
        assert eng.paging.page_len == MAX_LEN


def test_refusals_as_reference():
    """kv_bits=8 (no latent int8 layout) and speculation raise in both
    engines; chunked prefill stays off (its option is taken, its streams
    are the unchunked ones)."""
    s = setup()
    jrc = jcm.RunConfig(mode="decode", remat=False)
    for kw, match in (({"kv_bits": 8}, "no MLA latent layout"),
                      ({"speculate_k": 2}, "speculate_k")):
        with pytest.raises(ValueError, match=match):
            JaxEngine(s["jm"], s["params"]["vq"][0], jrc, _jax_engine_cfg(**kw))
        with pytest.raises(ValueError, match=match):
            _engine(s, **kw)
    eng = _engine(s, paged=True, block_size=8, prefill_chunk=8)
    assert "prefill_chunk" not in eng.trace_counts and not eng._chunked
    assert eng.generate(prompts()[:3], 4) == \
        _engine(s, paged=True, block_size=8).generate(prompts()[:3], 4)
    assert eng.metrics()["prefill_chunks"] == 0


# --------------------------------------------------------------------- graphs


GRAPH_CASES = [(16, False, False), (4, False, False), (16, True, False),
               (4, True, False), (16, False, True)]


@pytest.fixture(scope="module", params=GRAPH_CASES,
                ids=["fp", "kv4", "paged", "kv4-paged", "absorb"])
def served(request):
    """An engine whose decode StepGraph and eager prefill steps run their
    functions under ``_StepOps``, driven over three requests."""
    kv_bits, paged, absorb = request.param
    s = setup()
    log = {"decode": [], "prefill": []}

    def recording(base, key):
        class Recording(base):
            def __init__(self, fn, inputs, device, **kw):
                def step(**static):
                    mode = _StepOps(static.values())
                    with mode:
                        out = fn(**static)
                    log[key].append(mode)
                    return out

                super().__init__(step, inputs, device, **kw)

        return Recording

    with mock.patch.object(engine_mod, "StepGraph",
                           recording(engine_mod.StepGraph, "decode")), \
            mock.patch.object(engine_mod, "EagerStep",
                              recording(engine_mod.EagerStep, "prefill")):
        kw = {"paged": True, "block_size": 8} if paged else {}
        eng = _engine(s, absorb, kv_bits=kv_bits, **kw)
        out = eng.generate(prompts()[:3], 4)
    return {"eng": eng, "log": log, "out": out}


def test_steps_read_nothing_from_the_host(served):
    eng = served["eng"]
    resident = {id(t) for t in _leaves((eng.params, eng.caches,
                                        getattr(eng, "_kv_cb", None)))}
    log = served["log"]
    assert len(log["decode"]) == 1 + eng.metrics()["decode_steps"]
    assert len(log["prefill"]) == 3
    for key, modes in log.items():
        for mode in modes:
            host = sorted({op for op in mode.ops if op in HOST_OPS})
            assert not host, (key, host)
            if key == "decode":   # the prefill is eager: not captured
                foreign = [(op, tuple(t.shape)) for op, t in mode.foreign
                           if id(t) not in resident]
                assert not foreign, foreign
    assert all(len(t) == 4 for t in served["out"].values())


# ----------------------------------------------------------------- resilience


@pytest.mark.parametrize("kw", [{}, {"kv_bits": 4},
                                {"paged": True, "block_size": 8}],
                         ids=["fp", "kv4", "paged"])
def test_snapshot_restore_equals_uninterrupted(kw):
    s = setup()
    reqs = [GenerationRequest(prompt=p, max_new_tokens=NEW,
                              sampling=SamplingParams())
            for p in prompts()[:4]]
    eng = _engine(s, **kw)
    uids = [eng.submit(r) for r in reqs]
    snap, t = None, 0
    while not eng.idle:
        eng.step()
        t += 1
        if t == 3:
            snap = eng.snapshot()
    want = {u: eng.output(u).tokens for u in uids}
    assert any("/caches/pre/" in p for p in snap.arrays)
    eng2 = _engine(s, **kw)
    ptrs = [t.data_ptr() for t in _leaves(eng2.caches)]
    eng2.restore(snap)
    assert [t.data_ptr() for t in _leaves(eng2.caches)] == ptrs
    while not eng2.idle:
        eng2.step()
    assert {u: eng2.output(u).tokens for u in uids} == want


def test_backend_fault_rebuilds_over_live_latent_caches():
    """A backend fault mid-run on a paged engine: every cache leaf, the
    ``"pre"`` subtree's included, comes out of the decode graph's rebuild
    bit for bit and in place, and the decode plans move to the split."""
    s = setup()
    eng = _engine(s, paged=True, block_size=8)
    for p in prompts()[:3]:
        eng.submit(GenerationRequest(prompt=p, max_new_tokens=NEW))
    try:
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
    finally:
        plan_mod.reset_quarantine()


# ------------------------------------------------ conversion and checkpoints


@pytest.mark.parametrize("kind", ["dense", "vq", "kv4"])
def test_convert_carries_pre_layers_and_mla_both_ways(kind):
    s = setup()
    jp, tp = s["params"][kind]
    assert isinstance(tp["pre_layers"], list) and len(tp["pre_layers"]) == 1
    attn = tp["pre_layers"][0]["attn"]
    assert {"wkv_b", "kv_norm", "wo"} <= set(attn)
    assert ("wq_kva" in attn) == (kind != "dense")
    if kind == "kv4":
        assert tuple(attn["kv_cb"]["lat"].shape) == \
            jp["pre_layers"]["attn"]["kv_cb"]["lat"].shape[1:]
    _assert_same(to_reference_layout(tp), jp)


@pytest.mark.parametrize("kind", ["vq", "kv4"])
def test_checkpoint_files_byte_for_byte(kind, tmp_path):
    """The port writes the reference's files for a deepseek SMOKE tree
    (``pre_layers`` and ``layers`` stacked), and restores the reference's
    checkpoint bit for bit."""
    s = setup()
    jp, tp = s["params"][kind]
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(4, {"params": jp})
    CheckpointManager(str(tmp_path / "port")).save(4, {"params": tp})
    ref, port = (tmp_path / d / "step_0000000004" for d in ("ref", "port"))
    assert (port / "MANIFEST.json").read_bytes() == \
        (ref / "MANIFEST.json").read_bytes()
    assert b"pre_layers/attn/wq_kva" in (ref / "MANIFEST.json").read_bytes()
    mine, want = (_npz_members(d / "params.npz") for d in (port, ref))
    assert list(mine) == list(want)
    for name, data in want.items():
        assert mine[name] == data, name
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    step, state = CheckpointManager(str(tmp_path / "ref")).restore(
        device="cpu")
    assert step == 4
    _assert_bitwise(state["params"], tp)


# --------------------------------------------------------------- launch shapes


def _linears(cfg, T=200):
    """(name, K, N, decode rows at 4 slots and max_len 512, prefill rows of
    a T-token prompt) of every VQ linear of a deepseek layer: attention,
    the dense first layer's MLP, the shared experts' MLP and a routed
    expert (at its capacity)."""
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    D, dff = cfg.d_model, cfg.moe_d_ff
    sh = dff * cfg.num_shared_experts
    cap = lambda n: tcm.moe_capacity(cfg, n)
    return [("wq_kva", D, H * (dn + dr) + r + dr, 4, T),
            ("wkv_b", r, H * (dn + dv), 4 * 512, T),
            ("wo", H * dv, D, 4, T),
            ("dense_gu", D, 2 * cfg.d_ff, 4, T),
            ("dense_down", cfg.d_ff, D, 4, T),
            ("shared_gu", D, 2 * sh, 4, T),
            ("shared_down", sh, D, 4, T),
            ("expert_gu", D, 2 * dff, cap(4), cap(T)),
            ("expert_down", dff, D, cap(4), cap(T))]


@pytest.mark.parametrize("arch", ["full", "smoke"])
def test_b1_launch_shape_at_every_deepseek_linear(arch):
    """The fused kernel's tile model places every decode linear at its
    rows: covers V and N (wq_kva's N = 3648 ragged at both column tiles),
    fits 227 KB; at M <= 4 one wave of the card; the expand decode's
    wkv_b at M = 2048 with its split workspace under 64 MB."""
    full = tconfigs.get_config(ARCH)
    cfg = full if arch == "full" else tconfigs.get_smoke_config(ARCH)
    assert tcm.moe_capacity(full, 4) == 1 and tcm.moe_capacity(full, 200) == 24
    for name, K, N, m_dec, _ in _linears(cfg):
        V = K // 8
        for M in sorted({1, 2, 4, m_dec}):
            t = select_split(M, V, N, C=2, sm_count=132)
            assert t.splits * t.slabs_per_split * t.vl >= V, name
            assert t.smem == tiles.smem_bytes(2, t.mw, t.bn, t.stages,
                                              True) <= 227 * 1024
            assert -(-N // t.bn) * t.bn >= N
            if M <= 4:
                assert tiles.grid_ctas(t, M, N) <= 132 * t.groups, name
            if t.groups > 1:
                assert t.groups * M * N * 4 <= 64 << 20, (name, M, t)
    assert 3648 % 512 and 3648 % 1024


@pytest.mark.parametrize("arch", ["full", "smoke"])
def test_split_launch_shapes_at_every_deepseek_linear(arch):
    """The split-pinned planner's pair at every decode linear: vq_gemm's
    grid writes each (codebook, row) of M x V once (the expand decode's
    wkv_b: 131072 rows), and oc_lookup's tile model covers V and N,
    fits 227 KB without codebooks or x rows, and keeps its split
    workspace under 64 MB."""
    from repro_torch.kernels.oc_lookup.ops import select_lookup_split
    from repro_torch.kernels.vq_gemm.ops import ROWS_MAX
    from repro_torch.kernels.vq_gemm.ops import launch_shape as b4_shape

    cfg = (tconfigs.get_config if arch == "full"
           else tconfigs.get_smoke_config)(ARCH)
    for name, K, N, M, _ in _linears(cfg):
        V = K // 8
        rows, ctas = b4_shape(M * V, 132)
        assert 1 <= rows <= ROWS_MAX and (ctas - 1) * rows < M * V <= \
            ctas * rows, name
        t = select_lookup_split(M, V, N, C=2, sm_count=132)
        assert t.splits * t.slabs_per_split * t.vl >= V, name
        assert t.smem == tiles.smem_bytes(2, t.mw, t.bn, t.stages,
                                          False) <= 227 * 1024
        assert -(-N // t.bn) * t.bn >= N
        if t.groups > 1:
            assert t.groups * M * N * 4 <= 64 << 20, (name, M, t)


@pytest.mark.parametrize("arch", ["full", "smoke"])
def test_b3_launch_shape_at_every_deepseek_linear(arch):
    """dequant_gemv at prefill of a 200-token prompt (an expert at M =
    24; the first layer's down at V = 1368, an expert's down at V = 176)
    and at the decode rows: a token tile that exists, K splits that each
    keep at least one stage."""
    cfg = (tconfigs.get_config if arch == "full"
           else tconfigs.get_smoke_config)(ARCH)
    for name, K, N, m_dec, m_pre in _linears(cfg):
        V = K // 8
        for M in (m_dec, m_pre):
            T, splits = launch_shape(M, V, N, 132)
            assert T in TOKEN_TILES and T >= min(M, TOKEN_TILES[-1]), name
            assert 1 <= splits <= -(-V // 8)
