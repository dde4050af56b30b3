"""RecurrentGemma-2B in the port (``repro_torch/models/rglru.py``) held
against the JAX reference (``repro/models/rglru.py``) on the CPU at fp32,
on its SMOKE config (one (rec, rec, attn) group and two trailing rec
layers, d_model 128, a 32-position local window), with the reference's
params converted (the synthetic quantization's salt pinned):

  * the config and registry, field for field the reference's;
  * ``causal_conv1d`` with and without a buffer (S 1, 2, 40) within
    1e-6; ``rg_lru`` from a nonzero ``h0`` (S 1, 7, 40) within 1e-5,
    and the port's log-depth scan against a sequential fp64 loop over
    2100 positions (no underflow where a cumulative product of ``a``
    would);
  * both layer forwards (prefill, then decode from the prefill's state;
    grouped VQ, ungrouped VQ and dense) within 1e-5 x max|y|;
  * the model: prefill logits and 3 decode steps past the window within
    1e-4 x max|logit| (dense and VQ); prefill + step-by-step decode equal
    to the full forward across a ring wrap (``tests/test_decode_
    consistency.py``, 1e-4); EVA equal to dequant; ``init_cache`` equal
    to the reference's (``kv_int8``/``kvq`` ignored);
  * the port's own quantization: ``wqkv`` (N = q + 2 kv) and ``gu``
    grouped, ``wa``/``wx`` not, ``cw`` and ``lam`` dense; at full width
    (a 512-row vocabulary and d_ff 64, so the CPU builds 0.2 GB) every
    leaf's shape and dtype the reference's ``param_specs(quantized=True)``
    (``cw`` bf16 by its stacked size under ``"groups"``, fp32 under the
    two-layer ``"trail"``) and 158 VQ linears;
  * ``convert`` and the checkpoint files carry ``"groups"`` and
    ``"trail"`` both ways, byte for byte;
  * B1's, the split pair's and B3's launch shapes at every rglru linear.
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
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.models import rglru as jr
from repro.serve import kvcache as jkv
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import to_reference_layout
from repro_torch.core import quantize as tq
from repro_torch.core.plan import PlanPolicy
from repro_torch.kernels.dequant_gemv.ops import (ROWS_PER_STAGE, TOKEN_TILES,
                                                  launch_shape)
from repro_torch.kernels.eva_lookup import tiles
from repro_torch.kernels.fused_vq_matmul.ops import select_split
from repro_torch.kernels.oc_lookup.ops import select_lookup_split
from repro_torch.kernels.vq_gemm.ops import ROWS_MAX as B4_ROWS_MAX
from repro_torch.kernels.vq_gemm.ops import launch_shape as b4_shape
from repro_torch.models import RunConfig, build_model
from repro_torch.models import rglru as tr
from repro_torch.serve import kvcache as tkv

from test_torch_checkpoint import _assert_bitwise, _npz_members
from test_torch_mla import KEY, _close, _conv, _stable_hash, _t
from test_torch_moe import _assert_same
from test_torch_xlstm import _close_tree, _f32, _rng, _shapes

torch.set_num_threads(1)
ARCH = "recurrentgemma_2b"
REC, ATTN = "b0_rec", "b2_attn"


@functools.lru_cache(maxsize=None)
def setup():
    """The reference's SMOKE model at fp32: dense params, 2-bit VQ params
    (salt pinned) grouped and ungrouped, each with its conversion."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    dense = jm.init(KEY)
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(dense, method="synthetic", key=KEY)
        flat = jq.quantize_params(dense, jcfg, method="synthetic", key=KEY,
                                  group_projections=False)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32")
    trees = {"dense": dense, "vq": vq, "vq_ungrouped": flat}
    return {"jcfg": jcfg, "cfg": cfg, "jm": jm, "m": build_model(cfg),
            "params": {k: (t, _conv(t)) for k, t in trees.items()}}


def _layer(s, kind, name):
    """Group 0's layer ``name`` (or trailing layer 1, ``"trail"``) in both
    packages."""
    jp, tp = s["params"][kind]
    if name == "trail":
        return (jax.tree_util.tree_map(lambda a: a[1], jp["trail"]),
                tp["trail"][1])
    return (jax.tree_util.tree_map(lambda a: a[0], jp["groups"][name]),
            tp["groups"][0][name])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pos(B, start, S):
    return np.broadcast_to(np.arange(start, start + S, dtype=np.int32)[None],
                           (B, S)).copy()


def test_config_and_registry_equal_reference():
    for name in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tconfigs, name)(ARCH)) == \
            dataclasses.asdict(getattr(jconfigs, name)(ARCH)), name
    assert tconfigs.get_config("recurrentgemma-2b") == tconfigs.get_config(ARCH)
    ids = tconfigs.ARCH_IDS
    assert ids.index("mixtral_8x22b") + 1 == ids.index(ARCH) == \
        ids.index("llama_3_2_vision_11b") - 1
    model = build_model(tconfigs.get_config(ARCH))
    assert model.module is tr
    assert tr._split(tconfigs.get_config(ARCH)) == (8, 2)


# ---------------------------------------------------------------- recurrences


@pytest.mark.parametrize("with_buf", [False, True], ids=["zeros", "buffer"])
@pytest.mark.parametrize("S", [1, 2, 40])
def test_causal_conv1d_matches_reference(S, with_buf):
    """The W = 4 taps summed in fp32 in tap order; the new buffer is the
    last W - 1 inputs (zero-padded when S < W - 1 and no buffer)."""
    rng = _rng(S + 10 * with_buf)
    y, cw, cb = _f32(rng, 2, S, 16), _f32(rng, 4, 16, scale=0.1), \
        _f32(rng, 16, scale=0.1)
    buf = _f32(rng, 2, 3, 16) if with_buf else None
    want, wbuf = jr.causal_conv1d(jnp.asarray(y), jnp.asarray(cw),
                                  jnp.asarray(cb),
                                  None if buf is None else jnp.asarray(buf))
    got, gbuf = tr.causal_conv1d(_t(y), _t(cw), _t(cb),
                                 None if buf is None else _t(buf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(gbuf.numpy(), np.asarray(wbuf))


@pytest.mark.parametrize("S", [1, 7, 40])
def test_rg_lru_matches_reference(S):
    """From a nonzero h0: one step at S = 1 (decode's form), the
    log-depth scan otherwise, against the reference's associative scan,
    rtol/atol 1e-5; h at the last position too."""
    rng = _rng(100 + S)
    y = _f32(rng, 2, S, 32)
    r = 1 / (1 + np.exp(-_f32(rng, 2, S, 32)))
    i = 1 / (1 + np.exp(-_f32(rng, 2, S, 32)))
    u = rng.uniform(0.9, 0.999, 32).astype(np.float32)
    lam = np.log(np.expm1(-np.log(u) / jr.RGLRU_C)).astype(np.float32)
    h0 = _f32(rng, 2, 32)
    want, wlast = jr.rg_lru(*map(jnp.asarray, (y, r, i, lam, h0)))
    got, glast = tr.rg_lru(*map(_t, (y, r, i, lam, h0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(glast.numpy(), np.asarray(wlast), rtol=1e-5,
                               atol=1e-5)


def test_scan_equals_a_sequential_loop_over_a_long_prompt():
    """The log-depth scan over 2100 positions (past recurrentgemma's
    2048-position window) against h_t = a_t h_{t-1} + b_t in fp64, within
    1e-5; a cumulative product of ``a`` underflows fp32 there."""
    rng = _rng(7)
    S = 2100
    a = rng.uniform(0.5, 0.99, (1, S, 8))
    b = rng.standard_normal((1, S, 8))
    assert np.cumprod(a[0, :, 0].astype(np.float32))[-1] < \
        np.finfo(np.float32).tiny
    want = np.empty_like(b)
    h = np.zeros((1, 8))
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = tr._scan(_t(a.astype(np.float32)), _t(b.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- layers


@pytest.mark.parametrize("kind", ["vq", "vq_ungrouped", "dense"])
@pytest.mark.parametrize("name", [REC, "trail", ATTN])
def test_layer_forwards_match_reference(name, kind):
    """Prefill over 11 tokens from no state, then one decode step from
    the prefill's state (attention: its cache padded to 16 positions);
    the outputs within 1e-5 x max|y|, the state leaves too."""
    s = setup()
    jl, tl = _layer(s, kind, name)
    cfg, jcfg = s["cfg"], s["jcfg"]
    x = _f32(_rng(5), 2, 12, cfg.d_model)
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=4)
    trc = RunConfig(mode="prefill", attn_chunk=4)
    if name == ATTN:
        assert ("wqkv" in tl["attn"]) == (kind == "vq")
        pos = _pos(2, 0, 11)
        want, wc = jr.attn_layer_fwd(jl, jnp.asarray(x[:, :11]), jrc, jcfg,
                                     positions=jnp.asarray(pos))
        with torch.no_grad():
            got, gc = tr.attn_layer_fwd(tl, _t(x[:, :11]), trc, cfg,
                                        positions=_t(pos))
        _close(got.numpy(), want)
        wc = jkv.pad_prefill_cache(wc, 16, window=cfg.local_window)
        gc = tkv.pad_prefill_cache(gc, 16, window=cfg.local_window)
        pos = _pos(2, 11, 1)
        want, wc = jr.attn_layer_fwd(jl, jnp.asarray(x[:, 11:]),
                                     jrc.replace(mode="decode"), jcfg,
                                     positions=jnp.asarray(pos), cache=wc)
        with torch.no_grad():
            got, gc = tr.attn_layer_fwd(tl, _t(x[:, 11:]),
                                        trc.replace(mode="decode"), cfg,
                                        positions=_t(pos), cache=gc)
        _close(got.numpy(), want)
        _close_tree(gc, _np_tree(wc))
        return
    assert ("gu" in tl["mlp"]) == (kind == "vq")
    assert not {"wq", "wkv"} & set(tl)
    want, wc = jr.rec_layer_fwd(jl, jnp.asarray(x[:, :11]), jrc, jcfg)
    with torch.no_grad():
        got, gc = tr.rec_layer_fwd(tl, _t(x[:, :11]), trc, cfg)
    _close(got.numpy(), want)
    _close_tree(gc, _np_tree(wc))
    want, wc = jr.rec_layer_fwd(jl, jnp.asarray(x[:, 11:]),
                                jrc.replace(mode="decode"), jcfg, wc)
    with torch.no_grad():
        got, gc = tr.rec_layer_fwd(tl, _t(x[:, 11:]),
                                   trc.replace(mode="decode"), cfg, gc)
    _close(got.numpy(), want)
    _close_tree(gc, _np_tree(wc))


# ---------------------------------------------------------------------- model


def _cache_close(got, want, rel=1e-5):
    for seg, node in want.items():
        for name, sub in node.items():
            if isinstance(sub, dict):
                _close_tree(got[seg][name], _np_tree(sub), rel)
            else:
                assert tuple(got[seg][name].shape) == sub.shape
                _close(got[seg][name].numpy(), sub, rel)


@pytest.mark.parametrize("kind", ["vq", "dense"])
def test_logits_match_jax(kind):
    """Prefill logits of 40 tokens on two rows (past the 32-position
    window; and the last token's under ``lm_head_last_only``), then 3
    decode steps from the prefill's cache ring-converted, the cache
    updated in place: within 1e-4 x max|logit|, every state leaf and
    ring within 1e-4 x its max."""
    s = setup()
    jp, tp = s["params"][kind]
    W = s["cfg"].local_window
    toks = _rng(7).integers(0, 512, (2, 43)).astype(np.int32)
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=8)
    trc = RunConfig(mode="prefill", attn_chunk=8)
    want, jc = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks[:, :40])}, jrc)
    with torch.no_grad():
        got, tc = s["m"].prefill(tp, {"tokens": _t(toks[:, :40])}, trc)
        last, _ = s["m"].prefill(tp, {"tokens": _t(toks[:, :40])},
                                 trc.replace(lm_head_last_only=True))
    _close(got.numpy(), want, 1e-4)
    assert torch.equal(last, got[:, -1:])
    assert set(tc) == {"groups", "trail"} and \
        set(tc["groups"]) == {"b0_rec", "b1_rec", ATTN}
    jc, tc = (jkv.pad_prefill_cache(jc, 64, window=W),
              tkv.pad_prefill_cache(tc, 64, window=W))
    ptrs = [t.data_ptr() for t in jax.tree_util.tree_leaves(tc)]
    for pos in range(40, 43):
        want, jc = s["jm"].decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                                  jnp.full((2, 1), pos, jnp.int32), jc,
                                  jrc.replace(mode="decode"))
        with torch.no_grad():
            got, tc2 = s["m"].decode(tp, _t(toks[:, pos:pos + 1]),
                                     torch.full((2, 1), pos,
                                                dtype=torch.int32),
                                     tc, trc.replace(mode="decode"))
        assert tc2 is tc
        _close(got.numpy(), want, 1e-4)
    _cache_close(tc, _np_tree(jc), 1e-4)
    assert [t.data_ptr() for t in jax.tree_util.tree_leaves(tc)] == ptrs


def test_prefill_then_decode_equals_full_forward_across_a_ring_wrap():
    """``tests/test_decode_consistency.py`` in the port, past the window:
    the train-mode forward over 44 tokens against a prefill of 40 (ring
    of 32, wrapped) and 4 decode steps, rtol/atol 1e-4."""
    s = setup()
    _, tp = s["params"]["dense"]
    W = s["cfg"].local_window
    toks = _t(_rng(11).integers(0, 512, (2, 44)).astype(np.int32))
    with torch.no_grad():
        full, _ = s["m"].forward(tp, {"tokens": toks},
                                 RunConfig(mode="train", attn_chunk=8))
        pre, cache = s["m"].prefill(tp, {"tokens": toks[:, :40]},
                                    RunConfig(attn_chunk=8))
        np.testing.assert_allclose(pre[:, -1].numpy(), full[:, 39].numpy(),
                                   rtol=1e-4, atol=1e-4)
        cache = tkv.pad_prefill_cache(cache, 64, window=W)
        assert cache["groups"][ATTN]["k"].shape[2] == W
        for t in range(40, 44):
            got, cache = s["m"].decode(tp, toks[:, t:t + 1],
                                       torch.full((2, 1), t,
                                                  dtype=torch.int32),
                                       cache, RunConfig())
            np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                       rtol=1e-4, atol=1e-4)


def test_eva_decode_equals_dequant():
    """The paper's exactness claim at model level, on the VQ params: one
    decode step through EVA and through the dequant baseline from the
    same prefill state, rtol/atol 1e-4."""
    s = setup()
    _, tp = s["params"]["vq"]
    toks = _t(_rng(13).integers(0, 512, (2, 9)).astype(np.int32))
    step = (toks[:, 8:], torch.full((2, 1), 8, dtype=torch.int32))
    out = {}
    with torch.no_grad():
        for mode in ("eva", "dequant"):
            rc = RunConfig(plan_policy=PlanPolicy(vq_mode=mode))
            _, cache = s["m"].prefill(tp, {"tokens": toks[:, :8]}, rc)
            cache = tkv.pad_prefill_cache(cache, 16, window=32)
            out[mode], _ = s["m"].decode(tp, *step, cache, rc)
    np.testing.assert_allclose(out["eva"].numpy(), out["dequant"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_init_cache_equals_reference():
    """The mixed tree's layout, dtypes and zeros (rings of min(max_len,
    window) positions); ``kv_int8`` and ``kvq`` are ignored, as the
    reference's facade ignores them for rglru."""
    from repro_torch.core.vq import KVQuantConfig

    s = setup()
    for max_len in (17, 99):
        want = _np_tree(s["jm"].init_cache(3, max_len))
        for kw in ({}, {"kv_int8": True}, {"kvq": KVQuantConfig(kv_bits=4)}):
            got = s["m"].init_cache(3, max_len, device="cpu", **kw)
            assert set(got) == set(want) == {"groups", "trail"}
            assert set(got["groups"]) == set(want["groups"])
            for seg, node in (("trail", want["trail"]),
                              *((f"groups/{k}", v)
                                for k, v in want["groups"].items())):
                mine = got
                for part in seg.split("/"):
                    mine = mine[part]
                assert set(mine) == set(node)
                for n, a in node.items():
                    assert str(mine[n].dtype).replace("torch.", "") == \
                        str(a.dtype), (seg, n)
                    np.testing.assert_array_equal(mine[n].numpy(), a)
    assert got["groups"][ATTN]["k"].shape[2] == 32


# --------------------------------------------------------------- quantization


def _port_dense(cfg, device="cpu", block_device=None):
    gen = torch.Generator().manual_seed(0)
    return build_model(cfg).init(gen, device=device,
                                 block_device=block_device), gen


def test_port_quantize_groups_qkv_and_gu_only():
    """The port's own pass on its own params: attention's q|k|v (MQA: N =
    q + 2 kv) and each MLP's gate|up grouped; the rec layer's linears
    (``wa``/``wx`` keep their biases) never; ``cw``, ``cb`` and ``lam``
    stay dense."""
    cfg = tconfigs.get_smoke_config(ARCH)
    dense, gen = _port_dense(cfg)
    qp = tq.quantize_params(dense, cfg, method="synthetic",
                            generator=gen, device="cpu")
    attn = qp["groups"][0][ATTN]["attn"]
    assert attn["wqkv"]["vq"].splits == (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)
    for rec in (qp["groups"][0]["b1_rec"], qp["trail"][0]):
        assert {k for k, v in rec.items() if isinstance(v, dict)
                and "vq" in v} == {"gate_proj", "x_proj", "wa", "wx", "out"}
        assert {"vq", "b"} == set(rec["wa"]) == set(rec["wx"])
        assert rec["mlp"]["gu"]["vq"].splits == (cfg.d_ff, cfg.d_ff)
        assert all(isinstance(rec[k], torch.Tensor)
                   for k in ("cw", "cb", "lam"))
    assert tq.count_vq_layers(qp) == 4 * 7 + 4


def _narrow_full():
    """recurrentgemma-2b at full width and depth but a 512-row vocabulary
    and d_ff 64 (the CPU builds 0.2 GB of it)."""
    return {pkg: dataclasses.replace(mod.get_config(ARCH), vocab_size=512,
                                     d_ff=64)
            for pkg, mod in (("jax", jconfigs), ("torch", tconfigs))}


@pytest.fixture(scope="module")
def full_width():
    cfgs = _narrow_full()
    dense, gen = _port_dense(cfgs["torch"], block_device="meta")
    return cfgs, tq.quantize_params(dense, cfgs["torch"], method="synthetic",
                                    generator=gen,
                                    device="cpu")


def test_quantized_dtypes_equal_reference_param_specs(full_width):
    """The serving-dtype rule on the two stacks: a dense fp32 leaf goes
    bf16 when its STACKED size (the reference's) is >= 65536: ``cw`` (8,
    4, 2560) under ``"groups"`` bf16, (2, 4, 2560) under ``"trail"``
    fp32; every leaf's shape and dtype the reference's."""
    cfgs, qp = full_width
    want = _shapes(jax_build_model(cfgs["jax"]).param_specs(quantized=True))
    got = _shapes(to_reference_layout(qp))
    assert got == want
    assert want["/groups/b0_rec/cw"] == ((8, 4, 2560), "bfloat16")
    assert want["/trail/cw"] == ((2, 4, 2560), "float32")
    assert want["/groups/b0_rec/lam"] == ((8, 2560), "float32")
    assert want["/groups/b2_attn/attn/wqkv/vq/idx"][0][-1] == 3072


def test_vq_counts_at_full_width(full_width):
    """158 VQ linears: 7 a rec layer (gate_proj, x_proj, wa, wx, out, the
    MLP's gu and down) x 18, 4 an attention layer (wqkv, wo, gu, down)
    x 8."""
    cfgs, qp = full_width
    cfg = cfgs["torch"]
    assert tq.count_vq_layers(qp) == 158 == sum(
        n for *_, n in _linears(cfg))
    _, dense_b = tq.compressed_model_bytes(qp)
    assert dense_b == 2 * sum(K * N * n for _, K, N, n in _linears(cfg))


# ------------------------------------------------- conversion and checkpoints


@pytest.mark.parametrize("kind", ["dense", "vq", "vq_ungrouped"])
def test_convert_carries_groups_and_trail_both_ways(kind):
    s = setup()
    jp, tp = s["params"][kind]
    assert isinstance(tp["groups"], list) and len(tp["groups"]) == 1
    assert set(tp["groups"][0]) == {"b0_rec", "b1_rec", ATTN}
    assert isinstance(tp["trail"], list) and len(tp["trail"]) == 2
    _assert_same(to_reference_layout(tp), jp)


@pytest.mark.parametrize("kind", ["vq", "dense"])
def test_checkpoint_files_byte_for_byte(kind, tmp_path):
    """The port writes the reference's files for an rglru SMOKE tree (its
    ``groups`` and ``trail`` stacked), and restores the reference's
    checkpoint bit for bit."""
    s = setup()
    jp, tp = s["params"][kind]
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(2, {"params": jp})
    CheckpointManager(str(tmp_path / "port")).save(2, {"params": tp})
    ref, port = (tmp_path / d / "step_0000000002" for d in ("ref", "port"))
    assert (port / "MANIFEST.json").read_bytes() == \
        (ref / "MANIFEST.json").read_bytes()
    assert b"trail/lam" in (ref / "MANIFEST.json").read_bytes()
    mine, want = (_npz_members(d / "params.npz") for d in (port, ref))
    assert list(mine) == list(want)
    for name, data in want.items():
        assert mine[name] == data, name
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    step, state = CheckpointManager(str(tmp_path / "ref")).restore(
        device="cpu")
    assert step == 2
    _assert_bitwise(state["params"], tp)


# --------------------------------------------------------------- launch shapes


def _linears(cfg):
    """(name, K, N, times a decode step) of every VQ linear of the model:
    a rec layer's gate_proj, x_proj (D, d_rnn), wa, wx (d_rnn, d_rnn) and
    out (d_rnn, D), attention's grouped wqkv and wo, every layer's gu
    and down."""
    D, dr, F = cfg.d_model, cfg.d_rnn, cfg.d_ff
    G, T = tr._split(cfg)
    n_rec = G * cfg.rec_pattern.count("rec") + T
    n_attn = G * cfg.rec_pattern.count("attn")
    assert D == dr == cfg.q_dim
    return (("gate_proj|x_proj|wa|wx|out|wo", D, D, 5 * n_rec + n_attn),
            ("wqkv", D, cfg.q_dim + 2 * cfg.kv_dim, n_attn),
            ("gu", D, 2 * F, n_rec + n_attn), ("down", F, D, n_rec + n_attn))


@pytest.mark.parametrize("arch", ["full", "smoke"])
def test_b1_and_split_launch_shapes_at_every_rglru_linear(arch):
    """The fused kernel's and the split pair's launch shapes at every
    decode linear, M 1-4: they cover V and N, fit 227 KB, B1 in one wave
    of the card, vq_gemm writes each (codebook, row) of M x V once, and
    oc_lookup's split workspace stays under 64 MB."""
    cfg = (tconfigs.get_config if arch == "full"
           else tconfigs.get_smoke_config)(ARCH)
    for name, K, N, _ in _linears(cfg):
        V = K // 8
        for M in (1, 2, 4):
            t = select_split(M, V, N, C=2, sm_count=132)
            assert t.splits * t.slabs_per_split * t.vl >= V, name
            assert t.smem == tiles.smem_bytes(2, t.mw, t.bn, t.stages,
                                              True) <= 227 * 1024
            assert -(-N // t.bn) * t.bn >= N
            assert tiles.grid_ctas(t, M, N) <= 132 * t.groups, (name, M, t)
            rows, ctas = b4_shape(M * V, 132)
            assert 1 <= rows <= B4_ROWS_MAX and \
                (ctas - 1) * rows < M * V <= ctas * rows, (name, M)
            t = select_lookup_split(M, V, N, C=2, sm_count=132)
            assert t.splits * t.slabs_per_split * t.vl >= V, (name, M)
            assert t.smem == tiles.smem_bytes(2, t.mw, t.bn, t.stages,
                                              False) <= 227 * 1024
            if t.groups > 1:
                assert t.groups * M * N * 4 <= 64 << 20, (name, M, t)


@pytest.mark.parametrize("M", [5, 32, 200, 2100])
def test_b3_launch_shape_at_every_rglru_linear(M):
    """dequant_gemv's launch at an exact-length prefill of M tokens (2100:
    the ring-wrap prompt): a token tile that holds M (tiles of 256 above)
    and between one K split and one a stage."""
    for name, K, N, _ in _linears(tconfigs.get_config(ARCH)):
        T, splits = launch_shape(M, K // 8, N, 132)
        assert T in TOKEN_TILES and T >= min(M, TOKEN_TILES[-1]), (name, T)
        assert 1 <= splits <= -(-(K // 8) // ROWS_PER_STAGE), (name, splits)
