"""Whisper-medium in the port (``repro_torch/models/whisper.py``) held
against the JAX reference (``repro/models/whisper.py``) on the CPU at
fp32, on its SMOKE config (2 encoder and 2 decoder layers, d_model 64,
head dim 16), with the reference's params converted (the synthetic
quantization's salt pinned; every bias, LayerNorm gain and ``b2`` drawn
at random first, so each one counts):

  * the config and registry, field for field the reference's;
  * ``layernorm`` and the sinusoid (``sinusoid_pos``/``sinusoid_at``,
    also at 1500 x 1024) within 1e-6 (an fp32 op: ``allclose`` at 1e-5
    relative and absolute for LayerNorm);
  * ``blocked_attention(causal=False)`` at Sq != Skv, padded chunks, and
    ``attention_fwd`` with ``kv_source`` (its prefill cache included;
    a grouped ``wqkv`` and a cache raise);
  * ``encode``; a prefill's logits within 1e-4 of max|logit| and every
    cache leaf (``cross_k``/``cross_v`` from 16 frames at fp32 within
    1e-5, ``len``/``cross_len`` bit-equal); ``pad_prefill_cache`` passes
    the memories through, and slot insertion writes them at rows [0,
    16) of the S_SRC rows ``init_cache`` holds (``cross_len`` S_SRC on
    every slot); then 3 decode steps, logits and every leaf;
  * the quantized tree: the port's own at full width (a 512-row
    vocabulary, so the CPU builds 0.3 GB) has the reference's
    ``param_specs(quantized=True)`` shapes and dtypes (self-attention
    ``wqkv`` grouped with its biases concatenated, ``cross_attn`` never
    grouped, ``frontend.proj``, the embedding and the head dense and
    bf16, the biases beside VQ weights fp32) and 288 VQ linears;
  * ``convert`` and the checkpoint files carry ``"encoder"`` and
    ``"decoder"`` both ways, byte for byte.
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
from repro.models import whisper as jw
from repro.serve import engine as jengine
from repro.serve import kvcache as jkv
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import to_reference_layout
from repro_torch.core import quantize as tq
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as tcm
from repro_torch.models import whisper as tw
from repro_torch.serve import cache_bytes
from repro_torch.serve import engine as tengine
from repro_torch.serve import kvcache as tkv

from test_torch_checkpoint import _assert_bitwise, _npz_members
from test_torch_mla import KEY, _close, _conv, _stable_hash, _t
from test_torch_moe import _assert_same
from test_torch_xlstm import _f32, _rng, _shapes

torch.set_num_threads(1)
ARCH = "whisper_medium"
FRAMES = 16


def _randomize(tree, seed=7):
    """Every 1-D leaf drawn at random: biases and ``b2`` about 0, the
    LayerNorm gains about 1."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key not in ("b", "b2", "g"):
            return a
        r = rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return jnp.asarray(r + (1.0 if path[-1].key == "g" else 0.0))

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def setup():
    """The reference's SMOKE model at fp32: dense params (biases and norms
    at random), 2-bit VQ params (salt pinned) grouped and ungrouped, each
    with its conversion, and 16 frames."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    dense = _randomize(jm.init(KEY))
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(dense, method="synthetic", key=KEY)
        flat = jq.quantize_params(dense, jcfg, method="synthetic", key=KEY,
                                  group_projections=False)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32")
    trees = {"dense": dense, "vq": vq, "vq_ungrouped": flat}
    return {"jcfg": jcfg, "cfg": cfg, "jm": jm, "m": build_model(cfg),
            "params": {k: (t, _conv(t)) for k, t in trees.items()},
            "frames": _f32(_rng(11), FRAMES, jcfg.d_model)}


def _frames(s, B):
    return np.broadcast_to(s["frames"][None], (B,) + s["frames"].shape).copy()


def _rc(mode, chunk=8):
    return (jcm.RunConfig(mode=mode, remat=False, attn_chunk=chunk),
            RunConfig(mode=mode, attn_chunk=chunk))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_config_and_registry_equal_reference():
    for name in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tconfigs, name)(ARCH)) == \
            dataclasses.asdict(getattr(jconfigs, name)(ARCH)), name
    assert tconfigs.get_config("whisper-medium") == tconfigs.get_config(ARCH)
    ids = tconfigs.ARCH_IDS
    assert ids.index("qwen2_72b") + 1 == ids.index(ARCH) == \
        ids.index("xlstm_125m") - 1
    cfg = tconfigs.get_config(ARCH)
    assert build_model(cfg).module is tw
    assert (cfg.encoder_layers, cfg.num_layers, cfg.head_dim,
            cfg.padded_vocab, tw.S_SRC) == (24, 24, 64, 51968, jw.S_SRC)


# ------------------------------------------------------------ the small ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = _rng(1)
    x = _f32(rng, 3, 5, 64, scale=3.0) + 2.0
    p = {"g": _f32(rng, 64) + 1.0, "b2": _f32(rng, 64)}
    want = jcm.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x, dtype), 1e-5)
    got = tcm.layernorm({k: _t(v) for k, v in p.items()},
                        _t(x).to(getattr(torch, dtype)), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-5)
    made = tcm.make_layernorm(8, "cpu")
    assert set(made) == {"g", "b2"} and made["g"].dtype == torch.float32
    assert made["g"].eq(1).all() and not made["b2"].any()


@pytest.mark.parametrize("S,d", [(7, 16), (64, 64), (1500, 1024)])
def test_sinusoid_matches_reference(S, d):
    """The (S, d) table within 1e-6 (at 1500 x 1024 too), and at
    arbitrary (B, S) positions."""
    want = np.asarray(jw.sinusoid_pos(S, d, jnp.float32))
    got = tw.sinusoid_pos(S, d, torch.float32)
    assert got.shape == (S, d)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    pos = _rng(S).integers(0, 4 * S, (2, 5)).astype(np.int32)
    want = np.asarray(jw.sinusoid_at(jnp.asarray(pos), d, jnp.float32))
    got = tw.sinusoid_at(_t(pos), d, torch.float32)
    assert got.shape == (2, 5, d)
    assert np.abs(got.numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("Sq,Skv,chunk", [(5, 37, 8), (16, 16, 8),
                                          (9, 1500, 1024)])
def test_blocked_attention_noncausal_matches_reference(Sq, Skv, chunk):
    """``causal=False`` masks only the kv padding (the chunks pad Skv):
    within 1e-5; the default stays causal, as before."""
    rng = _rng(Sq + Skv)
    q, k, v = (_f32(rng, 2, S, 4, 16) for S in (Sq, Skv, Skv))
    want = jcm.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False, chunk=chunk)
    got = tcm.blocked_attention(_t(q), _t(k), _t(v), causal=False,
                                chunk=chunk)
    _close(got.numpy(), want)
    if Sq == Skv:
        want = jcm.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, chunk=chunk)
        _close(tcm.blocked_attention(_t(q), _t(k), _t(v),
                                     chunk=chunk).numpy(), want)


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_cross_attention_fwd_matches_reference(kind):
    """``attention_fwd`` with ``kv_source``: q from x, k and v from the
    memory, no rope, non-causal; its prefill cache (the memory's k and v)
    too. A grouped wqkv and a cache raise."""
    s = setup()
    jp, tp = s["params"][kind]
    jla = jax.tree_util.tree_map(lambda a: a[0], jp["decoder"])["cross_attn"]
    tla = tp["decoder"][0]["cross_attn"]
    rng = _rng(4)
    x, mem = _f32(rng, 2, 5, 64), _f32(rng, 2, FRAMES, 64)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32)[None], (2, 5)).copy()
    jrc, trc = _rc("prefill")
    want, jc = jcm.attention_fwd(jla, jnp.asarray(x), jrc, s["jcfg"],
                                 positions=jnp.asarray(pos),
                                 kv_source=jnp.asarray(mem), causal=False)
    got, tc = tcm.attention_fwd(tla, _t(x), trc, s["cfg"], positions=_t(pos),
                                kv_source=_t(mem), causal=False)
    _close(got.numpy(), want)
    for n in ("k", "v"):
        assert tc[n].shape == (2, FRAMES, 4, 16)
        _close(tc[n].numpy(), jc[n])
    grouped = s["params"]["vq"][1]["decoder"][0]["self_attn"]
    assert "wqkv" in grouped
    with pytest.raises(ValueError, match="grouped wqkv"):
        tcm.attention_fwd(grouped, _t(x), trc, s["cfg"], positions=_t(pos),
                          kv_source=_t(mem))
    with pytest.raises(ValueError, match="takes no cache"):
        tcm.attention_fwd(tla, _t(x), trc, s["cfg"], positions=_t(pos),
                          kv_source=_t(mem), cache={"k": None})


@pytest.mark.parametrize("kind", ["dense", "vq", "vq_ungrouped"])
def test_encode_matches_reference(kind):
    s = setup()
    jp, tp = s["params"][kind]
    fr = _frames(s, 2)
    jrc, trc = _rc("prefill")
    want = jw.encode(jp, jnp.asarray(fr), jrc, s["jcfg"])
    got = tw.encode(tp, _t(fr), trc, s["cfg"])
    assert got.shape == (2, FRAMES, 64)
    _close(got.numpy(), want)
    # the engine's decode rc runs the encoder in prefill mode
    _close(tw.encode(tp, _t(fr), RunConfig(mode="decode", attn_chunk=8),
                     s["cfg"]).numpy(), want)


# ------------------------------------------------------------------ the model


def _assert_cache(got, want, rel=1e-5):
    """Every leaf of a whisper cache tree: fp leaves within ``rel``
    (allclose), int leaves bit-equal."""
    g = {f"cross/{n}": got[n] for n in ("cross_k", "cross_v", "cross_len")}
    g.update({f"self/{n}": t for n, t in got["self"].items()})
    w = {f"cross/{n}": want[n] for n in ("cross_k", "cross_v", "cross_len")}
    w.update({f"self/{n}": a for n, a in want["self"].items()})
    assert set(g) == set(w)
    for n, a in w.items():
        a = np.asarray(a)
        assert tuple(g[n].shape) == a.shape, n
        if a.dtype.kind == "i":
            assert g[n].dtype == torch.int32, n
            np.testing.assert_array_equal(g[n].numpy(), a, err_msg=n)
        else:
            np.testing.assert_allclose(g[n].numpy(), a, rtol=rel, atol=rel,
                                       err_msg=n)


def _prefill(s, kind, toks):
    jp, tp = s["params"][kind]
    jrc, trc = _rc("prefill")
    fr = _frames(s, toks.shape[0])
    jl, jc = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks),
                                  "frames": jnp.asarray(fr)}, jrc)
    with torch.no_grad():
        tl, tc = s["m"].prefill(tp, {"tokens": _t(toks), "frames": _t(fr)},
                                trc)
    return jl, jc, tl, tc


@pytest.mark.parametrize("kind", ["dense", "vq", "vq_ungrouped"])
def test_prefill_logits_and_cache_match_reference(kind):
    """Logits within 1e-4 of max|logit| and every cache leaf: the cross
    memories of 16 frames (fp32 within 1e-5), ``cross_len`` = 16 and
    ``len`` bit-equal."""
    s = setup()
    toks = _rng(3).integers(0, 500, (2, 9)).astype(np.int32)
    jl, jc, tl, tc = _prefill(s, kind, toks)
    assert tl.shape == (2, 9, 512) and tl.dtype == torch.float32
    _close(tl.numpy(), jl, 1e-4)
    _assert_cache(tc, jc)
    assert tc["cross_len"].eq(FRAMES).all() and tc["self"]["len"].eq(9).all()


def test_init_cache_equals_reference():
    """zeros but ``cross_len`` = S_SRC on every slot; ``kv_int8`` is
    ignored (the engine refuses kv_bits != 16 before)."""
    s = setup()
    want = _np_tree(s["jm"].init_cache(3, 20))
    for kw in ({}, {"kv_int8": True}):
        got = s["m"].init_cache(3, 20, device="cpu", **kw)
        _assert_cache(got, want, rel=0)
        assert got["cross_k"].shape == (2, 3, tw.S_SRC, 4, 16)
    assert (want["cross_len"] == tw.S_SRC).all()


def test_pad_and_insert_keep_the_memories_at_their_rows():
    """``pad_prefill_cache`` pads the self-attention and passes the
    memories through (as the reference's); slot insertion writes them at
    rows [0, 16) of the slot's S_SRC and sets ``cross_len`` to 16, the
    rows past them as they were (the reference's ``_insert_slot``);
    ``cache_bytes`` counts every leaf."""
    s = setup()
    toks = _rng(5).integers(0, 500, (1, 6)).astype(np.int32)
    jl, jc, tl, tc = _prefill(s, "dense", toks)
    jpad = jkv.pad_prefill_cache(jc, 20, true_len=jnp.int32(6))
    tpad = tkv.pad_prefill_cache(tc, 20, true_len=6)
    _assert_cache(tpad, jpad)
    assert tpad["cross_k"] is tc["cross_k"]
    jbig = jengine._insert_slot(s["jm"].init_cache(3, 20), jpad, 1)
    tbig = s["m"].init_cache(3, 20, device="cpu")
    tbig["cross_k"][:, 1, FRAMES:].fill_(5.0)
    jbig["cross_k"] = jbig["cross_k"].at[:, 1, FRAMES:].set(5.0)
    tengine._insert_slot(tbig, tpad, 1)
    _assert_cache(tbig, jbig)
    assert tbig["cross_len"][:, 1].eq(FRAMES).all()
    assert tbig["cross_len"][:, [0, 2]].eq(tw.S_SRC).all()
    assert tbig["cross_k"][:, 1, FRAMES:].eq(5.0).all()
    L, B, H, hd = 2, 3, 4, 16
    assert cache_bytes(tbig) == 4 * (2 * L * B * 20 * H * hd + L * B
                                     + 2 * L * B * tw.S_SRC * H * hd + L * B)


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_decode_steps_match_reference(kind):
    """Two 16-frame prompts (lengths 9 and 4) inserted into a 2-slot cache
    of S_SRC memory rows, then 3 decode steps: logits within 1e-4 of
    max|logit| and every cache leaf, in both packages."""
    s = setup()
    jp, tp = s["params"][kind]
    cap = 16
    jcache, tcache = s["jm"].init_cache(2, cap), s["m"].init_cache(
        2, cap, device="cpu")
    rng = _rng(9)
    last = []
    for b, n in enumerate((9, 4)):
        toks = rng.integers(0, 500, (1, n)).astype(np.int32)
        _, jc, _, tc = _prefill(s, kind, toks)
        jcache = jengine._insert_slot(jcache, jkv.pad_prefill_cache(jc, cap),
                                      b)
        tengine._insert_slot(tcache, tkv.pad_prefill_cache(tc, cap), b)
        last.append(n)
    jrc, trc = _rc("decode")
    pos = np.array(last, np.int32)[:, None]
    for _ in range(3):
        tok = rng.integers(0, 500, (2, 1)).astype(np.int32)
        want, jcache = s["jm"].decode(jp, jnp.asarray(tok), jnp.asarray(pos),
                                      jcache, jrc)
        with torch.no_grad():
            got, tcache = s["m"].decode(tp, _t(tok), _t(pos), tcache, trc)
        _close(got.numpy(), want, 1e-4)
        pos = pos + 1
    _assert_cache(tcache, _np_tree(jcache))


def test_prefill_then_decode_equals_full_forward():
    """``tests/test_decode_consistency.py``'s check on whisper: the
    prompt's prefill then step-by-step decode (the memories inserted into
    S_SRC rows) gives the logits of one forward over the whole sequence,
    within 1e-4."""
    s = setup()
    _, tp = s["params"]["vq"]
    toks = _rng(12).integers(0, 500, (1, 10)).astype(np.int32)
    fr = _t(_frames(s, 1))
    trc = RunConfig(mode="prefill", attn_chunk=8)
    with torch.no_grad():
        full, _ = s["m"].forward(tp, {"tokens": _t(toks), "frames": fr},
                                 trc.replace(mode="train"))
        _, c = s["m"].prefill(tp, {"tokens": _t(toks[:, :6]), "frames": fr},
                              trc)
        cache = s["m"].init_cache(1, 16, device="cpu")
        tengine._insert_slot(cache, tkv.pad_prefill_cache(c, 16), 0)
        for t in range(6, 10):
            lg, cache = s["m"].decode(tp, _t(toks[:, t:t + 1]),
                                      torch.tensor([[t]], dtype=torch.int32),
                                      cache, trc.replace(mode="decode"))
            _close(lg[:, 0].numpy(), full[:, t].numpy(), 1e-4)


# --------------------------------------------------------------- quantization


def test_port_quantize_groups_self_attention_only():
    """The port's own pass on its own params: encoder and decoder
    self-attention ``wqkv`` (biases concatenated), ``gu`` never (a GELU
    MLP), ``cross_attn`` ungrouped; frontend, embedding and head dense."""
    cfg = tconfigs.get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    dense = build_model(cfg).init(gen, device="cpu")
    dense["decoder"][0]["self_attn"]["wk"]["b"].fill_(2.0)
    qp = tq.quantize_params(dense, cfg, method="synthetic",
                            generator=gen, device="cpu")
    for seg, attn in (("encoder", "attn"), ("decoder", "self_attn")):
        a = qp[seg][0][attn]
        assert set(a) == {"wqkv", "wo"} and a["wqkv"]["vq"].splits == \
            (64, 64, 64) and a["wqkv"]["b"].shape == (192,)
        assert "b" not in a["wo"]
    assert qp["decoder"][0]["self_attn"]["wqkv"]["b"][64:128].eq(2.0).all()
    x = qp["decoder"][0]["cross_attn"]
    assert set(x) == {"wq", "wk", "wv", "wo"} and all(
        "vq" in x[n] for n in x)
    assert set(qp["frontend"]["proj"]) == {"w", "b"}
    assert "w" in qp["lm_head"] and "emb" in qp["embedding"]
    assert tq.count_vq_layers(qp) == 2 * 4 + 2 * 8


@pytest.fixture(scope="module")
def full_width():
    """whisper-medium at full width with a 512-row vocabulary in the port:
    block linears from their shapes (meta), quantized synthetically on
    the CPU."""
    cfg = dataclasses.replace(tconfigs.get_config(ARCH), vocab_size=512)
    gen = torch.Generator().manual_seed(0)
    dense = build_model(cfg).init(gen, device="cpu", block_device="meta")
    return cfg, tq.quantize_params(dense, cfg, method="synthetic",
                                   generator=gen, device="cpu")


def test_quantized_dtypes_equal_reference_param_specs(full_width):
    """The serving-dtype rule: a bias beside a VQWeight keeps fp32 (the
    reference leaves a quantized node as it is), so the self-attention
    ``wqkv`` bias (24 x 3072, past the stacked-size threshold) and
    ``mlp.up``'s (24 x 4096) stay fp32, as do ``mlp.down``'s, the cross
    biases and the norms (24 x 1024, below it); the frontend's weight,
    the embedding and the head go bf16; every leaf's shape and dtype the
    reference's."""
    cfg, qp = full_width
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH), vocab_size=512)
    want = _shapes(jax_build_model(jcfg).param_specs(quantized=True))
    got = _shapes(to_reference_layout(qp))
    assert got == want
    assert want["/decoder/self_attn/wqkv/b"] == ((24, 3072), "float32")
    assert want["/encoder/mlp/up/b"] == ((24, 4096), "float32")
    assert want["/embedding/emb"] == ((512, 1024), "bfloat16")
    assert want["/lm_head/w"] == ((1024, 512), "bfloat16")
    assert want["/decoder/mlp/down/b"] == ((24, 1024), "float32")
    assert want["/decoder/cross_attn/wq/b"] == ((24, 1024), "float32")
    assert want["/decoder/cross_norm/g"] == ((24, 1024), "float32")
    assert want["/frontend/proj/w"] == ((1024, 1024), "bfloat16")
    assert want["/frontend/proj/b"] == ((1024,), "float32")


def test_vq_counts_at_full_width(full_width):
    """288 VQ linears (4 an encoder layer: wqkv, wo, up, down; 8 a decoder
    layer: wqkv, wo, the cross wq, wk, wv, wo, up, down) and their bytes
    (704.6 M weights at 2 bits, plus codebooks and scales)."""
    cfg, qp = full_width
    assert tq.count_vq_layers(qp) == 24 * 4 + 24 * 8 == 288
    vq_b, dense_b = tq.compressed_model_bytes(qp)
    D, F = 1024, 4096
    weights = 24 * (4 * D * D + 2 * D * F) + 24 * (8 * D * D + 2 * D * F)
    assert weights == 704_643_072 and dense_b == 2 * weights
    assert weights // 4 < vq_b < weights // 4 + 288 * 2 * (8 * 256 * 4
                                                           + 4096 * 4)


# ------------------------------------------------- conversion and checkpoints


@pytest.mark.parametrize("kind", ["dense", "vq", "vq_ungrouped"])
def test_convert_carries_encoder_and_decoder_both_ways(kind):
    s = setup()
    jp, tp = s["params"][kind]
    assert isinstance(tp["encoder"], list) and len(tp["encoder"]) == 2
    assert isinstance(tp["decoder"], list) and len(tp["decoder"]) == 2
    assert set(tp["encoder"][0]["attn_norm"]) == {"g", "b2"}
    _assert_same(to_reference_layout(tp), jp)


@pytest.mark.parametrize("kind", ["vq", "dense"])
def test_checkpoint_files_byte_for_byte(kind, tmp_path):
    """The port writes the reference's files for a whisper SMOKE tree (its
    ``encoder`` and ``decoder`` stacked), and restores the reference's
    checkpoint bit for bit."""
    s = setup()
    jp, tp = s["params"][kind]
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(4, {"params": jp})
    CheckpointManager(str(tmp_path / "port")).save(4, {"params": tp})
    ref, port = (tmp_path / d / "step_0000000004" for d in ("ref", "port"))
    assert (port / "MANIFEST.json").read_bytes() == \
        (ref / "MANIFEST.json").read_bytes()
    assert b"decoder/cross_norm/b2" in (ref / "MANIFEST.json").read_bytes()
    mine, want = (_npz_members(d / "params.npz") for d in (port, ref))
    assert list(mine) == list(want)
    for name, data in want.items():
        assert mine[name] == data, name
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    step, state = CheckpointManager(str(tmp_path / "ref")).restore(
        device="cpu")
    assert step == 4
    _assert_bitwise(state["params"], tp)
