"""Llama-3.2-Vision in the port (``repro_torch/models/vision.py``) held
against the JAX reference (``repro/models/vision.py``) on the CPU at
fp32, on its SMOKE config (2 groups of one self layer and one cross
layer, d_model 128, 4 query heads over 2 kv heads, head dim 32), with
the reference's params converted (the synthetic quantization's salt
pinned). The reference draws the cross layers' gates at zero, which
would let every image path below pass broken (tanh(0) = 0: the cross
layers add nothing), so ``setup`` sets ``attn_gate`` and ``mlp_gate``
to non-zero values in the JAX params before conversion, and draws every
RMSNorm gain and ``img_proj``'s bias at random:

  * the config and registry, field for field the reference's;
  * ``_cross_fwd`` in prefill (k and v from the image, its fresh
    memories) and in decode (over cached memories of two lengths
    ``xlen``), dense and VQ, within 1e-5 of max|out|;
  * a prefill's logits within 1e-4 of max|logit| and every cache leaf
    (``self0`` k/v/len, ``xk``/``xv`` from 12 image rows at fp32 within
    1e-5, ``xlen`` bit-equal); ``pad_prefill_cache`` passes the memories
    through, and slot insertion writes them at rows [0, 12) of the
    N_IMG_TOKENS rows ``init_cache`` holds; 3 decode steps, logits and
    every leaf; prefill then decode equals the full forward;
  * the image matters through the gates only: two images give equal
    logits at zero gates and differ at non-zero ones; decode attends
    only rows below ``xlen`` (rows past it changed, the logits are not;
    ``xlen`` left at N_IMG_TOKENS moves them);
  * the quantized tree: the port's own (``xattn`` never grouped) and at
    full width on meta tensors (a 512-row vocabulary) the reference's
    ``param_specs(quantized=True)`` shapes and dtypes (``img_proj``'s
    weight bf16, its bias and the gates fp32) with 176 VQ linears over
    8.724 G weights;
  * ``convert`` and the checkpoint files carry ``"groups"`` (nested
    ``self0``/``cross`` dicts, the gates stacked as (G,)) both ways,
    byte for byte.
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
from repro.models import vision as jv
from repro.serve import engine as jengine
from repro.serve import kvcache as jkv
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import to_reference_layout
from repro_torch.core import quantize as tq
from repro_torch.core.vq import VQWeight
from repro_torch.models import RunConfig, build_model
from repro_torch.models import vision as tv
from repro_torch.serve import cache_bytes
from repro_torch.serve import engine as tengine
from repro_torch.serve import kvcache as tkv

from test_torch_checkpoint import _assert_bitwise, _npz_members
from test_torch_mla import KEY, _close, _conv, _stable_hash, _t
from test_torch_moe import _assert_same
from test_torch_xlstm import _f32, _rng, _shapes

torch.set_num_threads(1)
ARCH = "llama_3_2_vision_11b"
N_IMG = 12       # image rows of the tests (not a multiple of the chunk 8)
GATES = {"attn_gate": (0.9, -0.6), "mlp_gate": (0.5, 1.1)}


def _gated(tree, gates=GATES):
    """``tree`` with the cross layers' stacked (G,) gates set to
    ``gates`` (zero at init in both packages)."""
    cross = dict(tree["groups"]["cross"])
    for n, vals in gates.items():
        cross[n] = jnp.asarray(vals, jnp.float32)
    return {**tree, "groups": {**tree["groups"], "cross": cross}}


def _randomize(tree, seed=7):
    """Every RMSNorm gain about 1 and ``img_proj``'s bias about 0, at
    random."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key not in ("b", "g"):
            return a
        r = rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return jnp.asarray(r + (1.0 if path[-1].key == "g" else 0.0))

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def setup():
    """The reference's SMOKE model at fp32: dense params (norms and the
    image bias at random, the gates non-zero), 2-bit VQ params (salt
    pinned) grouped and ungrouped, each with its conversion, and 12 image
    rows."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    dense = _gated(_randomize(jm.init(KEY)))
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(dense, method="synthetic", key=KEY)
        flat = jq.quantize_params(dense, jcfg, method="synthetic", key=KEY,
                                  group_projections=False)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32")
    trees = {"dense": dense, "vq": vq, "vq_ungrouped": flat}
    return {"jcfg": jcfg, "cfg": cfg, "jm": jm, "m": build_model(cfg),
            "params": {k: (t, _conv(t)) for k, t in trees.items()},
            "image": _f32(_rng(11), N_IMG, jcfg.d_model)}


def _image(s, B, image=None):
    image = s["image"] if image is None else image
    return np.broadcast_to(image[None], (B,) + image.shape).copy()


def _rc(mode, chunk=8):
    return (jcm.RunConfig(mode=mode, remat=False, attn_chunk=chunk),
            RunConfig(mode=mode, attn_chunk=chunk))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """path -> leaf of a cache tree (either package's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_config_and_registry_equal_reference():
    for name in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tconfigs, name)(ARCH)) == \
            dataclasses.asdict(getattr(jconfigs, name)(ARCH)), name
    assert tconfigs.get_config("llama-3.2-vision-11b") == \
        tconfigs.get_config(ARCH)
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    cfg = tconfigs.get_config(ARCH)
    assert build_model(cfg).module is tv
    assert (cfg.num_layers // cfg.cross_attn_period, cfg.head_dim,
            cfg.padded_vocab, tv.N_IMG_TOKENS) == (8, 128, 128256,
                                                   jv.N_IMG_TOKENS)


def test_init_params_layout():
    """The port's own params: a list of G groups of ``self0``..``self3``
    and ``cross`` (full width on meta: 8 groups), the gates 0-d zeros,
    ``img_proj`` biased."""
    cfg = tconfigs.get_smoke_config(ARCH)
    p = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert len(p["groups"]) == 2 and set(p["groups"][0]) == {"self0",
                                                             "cross"}
    cross = p["groups"][1]["cross"]
    assert set(cross) == {"attn_norm", "xattn", "attn_gate", "mlp_norm",
                          "mlp", "mlp_gate", "qnorm", "knorm"}
    for n in ("attn_gate", "mlp_gate"):
        assert cross[n].shape == () and cross[n].dtype == torch.float32
        assert cross[n].item() == 0.0
    assert set(p["img_proj"]) == {"w", "b"}
    full = build_model(tconfigs.get_config(ARCH)).init(
        torch.Generator().manual_seed(0), device="meta", block_device="meta")
    assert len(full["groups"]) == 8 and set(full["groups"][0]) == {
        "self0", "self1", "self2", "self3", "cross"}
    with pytest.raises(ValueError, match="cross_attn_period"):
        build_model(dataclasses.replace(cfg, num_layers=3)).init(
            torch.Generator(), device="cpu")


# ------------------------------------------------------------ the cross layer


def _layer(s, kind, g=1):
    jp, tp = s["params"][kind]
    jlp = jax.tree_util.tree_map(lambda a: a[g], jp["groups"])["cross"]
    return jlp, tp["groups"][g]["cross"]


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_cross_fwd_prefill_matches_reference(kind):
    """q from the text, k (normalized) and v from the image, non-causal,
    gated: the output within 1e-5 and the fresh memories ({"xk", "xv"}
    within 1e-5, ``xlen`` = n_img)."""
    s = setup()
    jlp, tlp = _layer(s, kind)
    rng = _rng(4)
    x, img = _f32(rng, 2, 5, 128), _f32(rng, 2, N_IMG, 128)
    jrc, trc = _rc("prefill")
    want, jc = jv._cross_fwd(jlp, jnp.asarray(x), jrc, s["jcfg"],
                             jnp.asarray(img), None)
    got, tc = tv._cross_fwd(tlp, _t(x), trc, s["cfg"], _t(img), None)
    _close(got.numpy(), want)
    assert set(tc) == {"xk", "xv", "xlen"}
    for n in ("xk", "xv"):
        assert tc[n].shape == (2, N_IMG, 2, 32)
        _close(tc[n].numpy(), jc[n])
    np.testing.assert_array_equal(tc["xlen"].numpy(), np.asarray(jc["xlen"]))
    # train mode returns no memories
    got, tc = tv._cross_fwd(tlp, _t(x), RunConfig(mode="train",
                                                  attn_chunk=8),
                            s["cfg"], _t(img), None)
    assert tc is None
    _close(got.numpy(), want)


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_cross_fwd_decode_matches_reference(kind):
    """Decode over cached memories of 40 rows whose slots hold 5 and 40
    valid ones: the output within 1e-5; the cache comes back as it
    was."""
    s = setup()
    jlp, tlp = _layer(s, kind, g=0)
    rng = _rng(5)
    x = _f32(rng, 2, 1, 128)
    cache = {"xk": _f32(rng, 2, 40, 2, 32), "xv": _f32(rng, 2, 40, 2, 32),
             "xlen": np.array([5, 40], np.int32)}
    jrc, trc = _rc("decode")
    want, _ = jv._cross_fwd(jlp, jnp.asarray(x), jrc, s["jcfg"], None,
                            {n: jnp.asarray(a) for n, a in cache.items()})
    tcache = {n: _t(a) for n, a in cache.items()}
    got, tc = tv._cross_fwd(tlp, _t(x), trc, s["cfg"], None, tcache)
    assert tc is tcache
    _close(got.numpy(), want)


# ------------------------------------------------------------------ the model


def _assert_cache(got, want, rel=1e-5):
    """Every leaf of a vision cache tree: fp leaves within ``rel``
    (allclose), int leaves bit-equal."""
    g, w = _flat(got), _flat(_np_tree(want))
    assert set(g) == set(w)
    for n, a in w.items():
        assert tuple(g[n].shape) == a.shape, n
        if a.dtype.kind == "i":
            assert g[n].dtype == torch.int32, n
            np.testing.assert_array_equal(g[n].numpy(), a, err_msg=n)
        else:
            np.testing.assert_allclose(g[n].numpy(), a, rtol=rel, atol=rel,
                                       err_msg=n)


def _prefill(s, kind, toks, image=None):
    jp, tp = s["params"][kind]
    jrc, trc = _rc("prefill")
    img = _image(s, toks.shape[0], image)
    jl, jc = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks),
                                  "image_embeds": jnp.asarray(img)}, jrc)
    with torch.no_grad():
        tl, tc = s["m"].prefill(tp, {"tokens": _t(toks),
                                     "image_embeds": _t(img)}, trc)
    return jl, jc, tl, tc


@pytest.mark.parametrize("kind", ["dense", "vq", "vq_ungrouped"])
def test_prefill_logits_and_cache_match_reference(kind):
    """Logits within 1e-4 of max|logit| and every cache leaf: the image
    memories of 12 rows (fp32 within 1e-5), ``xlen`` = 12 and ``len``
    bit-equal; under ``lm_head_last_only`` the last row only."""
    s = setup()
    toks = _rng(3).integers(0, 512, (2, 9)).astype(np.int32)
    jl, jc, tl, tc = _prefill(s, kind, toks)
    assert tl.shape == (2, 9, 512) and tl.dtype == torch.float32
    _close(tl.numpy(), jl, 1e-4)
    _assert_cache(tc, jc)
    assert tc["cross"]["xlen"].eq(N_IMG).all()
    assert tc["self0"]["len"].eq(9).all()
    assert tc["cross"]["xk"].shape == (2, 2, N_IMG, 2, 32)
    _, tp = s["params"][kind]
    with torch.no_grad():
        last, _ = s["m"].prefill(tp, {"tokens": _t(toks),
                                      "image_embeds": _t(_image(s, 2))},
                                 RunConfig(attn_chunk=8,
                                           lm_head_last_only=True))
    assert last.shape == (2, 1, 512)
    _close(last.numpy(), jl[:, -1:], 1e-4)


def test_init_cache_equals_reference():
    """zeros but ``xlen`` = N_IMG_TOKENS on every slot; ``kv_int8`` is
    ignored (the engine refuses kv_bits != 16 before)."""
    s = setup()
    want = s["jm"].init_cache(3, 20)
    for kw in ({}, {"kv_int8": True}):
        got = s["m"].init_cache(3, 20, device="cpu", **kw)
        _assert_cache(got, want, rel=0)
        assert got["cross"]["xk"].shape == (2, 3, tv.N_IMG_TOKENS, 2, 32)
        assert got["self0"]["k"].dtype == torch.float32
    assert (np.asarray(want["cross"]["xlen"]) == tv.N_IMG_TOKENS).all()


def test_pad_and_insert_keep_the_memories_at_their_rows():
    """``pad_prefill_cache`` pads the self caches and passes the memories
    through (as the reference's); slot insertion writes them at rows [0,
    12) of the slot's N_IMG_TOKENS and sets ``xlen`` to 12, the rows past
    them as they were (the reference's ``_insert_slot``);
    ``cache_bytes`` counts every leaf."""
    s = setup()
    toks = _rng(5).integers(0, 512, (1, 6)).astype(np.int32)
    jl, jc, tl, tc = _prefill(s, "dense", toks)
    jpad = jkv.pad_prefill_cache(jc, 20, true_len=jnp.int32(6))
    tpad = tkv.pad_prefill_cache(tc, 20, true_len=6)
    _assert_cache(tpad, jpad)
    assert tpad["cross"]["xk"] is tc["cross"]["xk"]
    jbig = s["jm"].init_cache(3, 20)
    jbig["cross"]["xk"] = jbig["cross"]["xk"].at[:, 1, N_IMG:].set(5.0)
    jbig = jengine._insert_slot(jbig, jpad, 1)
    tbig = s["m"].init_cache(3, 20, device="cpu")
    tbig["cross"]["xk"][:, 1, N_IMG:].fill_(5.0)
    tengine._insert_slot(tbig, tpad, 1)
    _assert_cache(tbig, jbig)
    xlen = tbig["cross"]["xlen"]
    assert xlen[:, 1].eq(N_IMG).all() and \
        xlen[:, [0, 2]].eq(tv.N_IMG_TOKENS).all()
    assert tbig["cross"]["xk"][:, 1, N_IMG:].eq(5.0).all()
    G, B, Hk, hd = 2, 3, 2, 32
    assert cache_bytes(tbig) == 4 * (2 * G * B * 20 * Hk * hd + G * B
                                     + 2 * G * B * tv.N_IMG_TOKENS * Hk * hd
                                     + G * B)


def _decode_run(s, kind, lengths, steps, cap=16, image=None):
    """Prompts of ``lengths`` prefilled and inserted into a cache of
    ``cap`` positions (N_IMG_TOKENS memory rows), then ``steps`` decode
    steps in both packages: the JAX and port logits a step and the final
    caches."""
    jp, tp = s["params"][kind]
    B = len(lengths)
    jcache, tcache = s["jm"].init_cache(B, cap), s["m"].init_cache(
        B, cap, device="cpu")
    rng = _rng(9)
    for b, n in enumerate(lengths):
        toks = rng.integers(0, 512, (1, n)).astype(np.int32)
        _, jc, _, tc = _prefill(s, kind, toks, image)
        jcache = jengine._insert_slot(jcache, jkv.pad_prefill_cache(jc, cap),
                                      b)
        tengine._insert_slot(tcache, tkv.pad_prefill_cache(tc, cap), b)
    jrc, trc = _rc("decode")
    pos = np.array(lengths, np.int32)[:, None]
    out = []
    for _ in range(steps):
        tok = rng.integers(0, 512, (B, 1)).astype(np.int32)
        want, jcache = s["jm"].decode(jp, jnp.asarray(tok), jnp.asarray(pos),
                                      jcache, jrc)
        with torch.no_grad():
            got, tcache = s["m"].decode(tp, _t(tok), _t(pos), tcache, trc)
        out.append((np.asarray(want), got.numpy()))
        pos = pos + 1
    return out, jcache, tcache


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_decode_steps_match_reference(kind):
    """Two prompts (lengths 9 and 4) with 12-row images inserted into a
    2-slot cache of N_IMG_TOKENS memory rows, then 3 decode steps: logits
    within 1e-4 of max|logit| and every cache leaf, in both packages."""
    s = setup()
    out, jcache, tcache = _decode_run(s, kind, (9, 4), 3)
    for want, got in out:
        _close(got, want, 1e-4)
    _assert_cache(tcache, jcache)


def test_prefill_then_decode_equals_full_forward():
    """``tests/test_decode_consistency.py``'s check on vision: the
    prompt's prefill then step-by-step decode (the memories inserted into
    N_IMG_TOKENS rows) gives the logits of one forward over the whole
    sequence with the image, within 1e-4."""
    s = setup()
    _, tp = s["params"]["vq"]
    toks = _rng(12).integers(0, 512, (1, 10)).astype(np.int32)
    img = _t(_image(s, 1))
    trc = RunConfig(mode="prefill", attn_chunk=8)
    with torch.no_grad():
        full, _ = s["m"].forward(tp, {"tokens": _t(toks),
                                      "image_embeds": img},
                                 trc.replace(mode="train"))
        _, c = s["m"].prefill(tp, {"tokens": _t(toks[:, :6]),
                                   "image_embeds": img}, trc)
        cache = s["m"].init_cache(1, 16, device="cpu")
        tengine._insert_slot(cache, tkv.pad_prefill_cache(c, 16), 0)
        for t in range(6, 10):
            lg, cache = s["m"].decode(tp, _t(toks[:, t:t + 1]),
                                      torch.tensor([[t]], dtype=torch.int32),
                                      cache, trc.replace(mode="decode"))
            _close(lg[:, 0].numpy(), full[:, t].numpy(), 1e-4)


# ------------------------------------------------- the image and its rows


def _logits(tp, s, toks, image):
    with torch.no_grad():
        lg, _ = s["m"].prefill(tp, {"tokens": _t(toks),
                                    "image_embeds": _t(image[None])},
                               RunConfig(attn_chunk=8))
    return lg


def test_image_changes_logits_only_through_the_gates():
    """At the reference's zero gates two different images give equal
    logits (tanh(0) = 0: the cross layers add nothing, so a broken image
    path would pass every test above); at the non-zero gates of
    ``setup`` they differ, by more than 1 % of max|logit|, in both
    packages alike."""
    s = setup()
    jp = s["params"]["vq"][0]
    zero = _gated(jp, {n: (0.0, 0.0) for n in GATES})
    toks = _rng(13).integers(0, 512, (1, 7)).astype(np.int32)
    img2 = _f32(_rng(14), N_IMG, 128)
    for tree, differs in ((zero, False), (jp, True)):
        tp = _conv(tree)
        a, b = _logits(tp, s, toks, s["image"]), _logits(tp, s, toks, img2)
        if not differs:
            assert torch.equal(a, b)
            continue
        gap = (a - b).abs().max().item()
        assert gap > 0.01 * a.abs().max().item(), gap
        jl = s["jm"].prefill(tree, {"tokens": jnp.asarray(toks),
                                    "image_embeds": jnp.asarray(
                                        img2[None])}, _rc("prefill")[0])[0]
        _close(b.numpy(), jl, 1e-4)


def test_decode_attends_only_rows_below_xlen():
    """A slot's memories of 12 rows inside N_IMG_TOKENS: rows past
    ``xlen`` filled with large values leave the decode logits exactly as
    they were, in both packages; the same cache with ``xlen`` left at
    N_IMG_TOKENS (a prefill that did not set it) attends those rows and
    moves the logits."""
    s = setup()
    jp, tp = s["params"]["vq"]
    toks = _rng(15).integers(0, 512, (1, 5)).astype(np.int32)
    _, jc, _, tc = _prefill(s, "vq", toks)
    jcache = jengine._insert_slot(s["jm"].init_cache(1, 16),
                                  jkv.pad_prefill_cache(jc, 16), 0)
    cache = s["m"].init_cache(1, 16, device="cpu")
    tengine._insert_slot(cache, tkv.pad_prefill_cache(tc, 16), 0)
    tok, pos = np.array([[3]], np.int32), np.array([[5]], np.int32)

    def step(c):
        c = jax.tree_util.tree_map(lambda t: t.clone(), c)
        with torch.no_grad():
            return s["m"].decode(tp, _t(tok), _t(pos), c,
                                 RunConfig(mode="decode", attn_chunk=8))[0]

    clean = step(cache)
    want, _ = s["jm"].decode(jp, jnp.asarray(tok), jnp.asarray(pos), jcache,
                             _rc("decode")[0])
    _close(clean.numpy(), want, 1e-4)
    for n in ("xk", "xv"):
        cache["cross"][n][:, :, N_IMG:] = 30.0
        jcache["cross"][n] = jcache["cross"][n].at[:, :, N_IMG:].set(30.0)
    assert torch.equal(step(cache), clean)
    jgot, _ = s["jm"].decode(jp, jnp.asarray(tok), jnp.asarray(pos), jcache,
                             _rc("decode")[0])
    np.testing.assert_array_equal(np.asarray(jgot), np.asarray(want))
    cache["cross"]["xlen"].fill_(tv.N_IMG_TOKENS)
    moved = (step(cache) - clean).abs().max().item()
    assert moved > 0.01 * clean.abs().max().item(), moved


# --------------------------------------------------------------- quantization


def test_port_quantize_keeps_xattn_ungrouped():
    """The port's own pass on its own params: self-attention ``wqkv`` and
    ``gu`` grouped, ``xattn`` never (its q reads the text, k and v the
    image); ``img_proj``, the embedding and the head dense; 10 VQ
    linears a group."""
    cfg = tconfigs.get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    dense = build_model(cfg).init(gen, device="cpu")
    qp = tq.quantize_params(dense, cfg, method="synthetic",
                            generator=gen, device="cpu")
    g = qp["groups"][0]
    assert set(g["self0"]["attn"]) == {"wqkv", "wo"}
    assert g["self0"]["attn"]["wqkv"]["vq"].splits == (128, 64, 64)
    assert set(g["self0"]["mlp"]) == {"gu", "down"}
    x = g["cross"]["xattn"]
    assert set(x) == {"wq", "wk", "wv", "wo"} and all(
        set(x[n]) == {"vq"} for n in x)
    assert set(g["cross"]["mlp"]) == {"gu", "down"}
    assert set(qp["img_proj"]) == {"w", "b"}
    assert "w" in qp["lm_head"] and "emb" in qp["embedding"]
    assert g["cross"]["attn_gate"].dtype == torch.float32
    assert tq.count_vq_layers(qp) == 2 * (4 + 6)


def _meta_vq(generator, K, N, *, d=8, n=8, C=2, splits=(), lead=(),
             device=None):
    """``synthetic_vq``'s VQWeight with its tensors on the meta device:
    its shapes and dtypes, no values."""
    V, k = K // d, 2 ** n
    meta = lambda shape, dt: torch.empty(tuple(lead) + shape, dtype=dt,
                                         device="meta")
    return VQWeight(idx=meta((C, V, N), torch.uint8),
                    codebooks=meta((C, d, k), torch.float32),
                    scale=meta((N,), torch.float32), K=K, N=N, d=d, n=n,
                    splits=tuple(splits))


@pytest.fixture(scope="module")
def full_width():
    """llama-3.2-vision-11b at full width with a 512-row vocabulary in the
    port: block linears from their shapes (meta), quantized with their VQ
    tensors on the meta device too (2.18 GB of indices otherwise); the
    dense leaves (``img_proj``, the norms, the gates) on the CPU."""
    cfg = dataclasses.replace(tconfigs.get_config(ARCH), vocab_size=512)
    gen = torch.Generator().manual_seed(0)
    dense = build_model(cfg).init(gen, device="cpu", block_device="meta")
    with mock.patch.object(tq, "synthetic_vq", _meta_vq):
        return cfg, tq.quantize_params(dense, cfg, method="synthetic",
                                       generator=gen,
                                       device="cpu")


def test_quantized_dtypes_equal_reference_param_specs(full_width):
    """The serving-dtype rule at full width: ``img_proj``'s weight (4096 x
    4096), the embedding and the head go bf16; ``img_proj``'s bias, the
    norms (8 x 4096 stacked, below the threshold) and the scalar gates
    (stacked (8,)) stay fp32; every leaf's shape and dtype the
    reference's ``param_specs(quantized=True)``."""
    cfg, qp = full_width
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH), vocab_size=512)
    want = _shapes(jax_build_model(jcfg).param_specs(quantized=True))
    got = _shapes(to_reference_layout(qp))
    assert got == want
    assert want["/img_proj/w"] == ((4096, 4096), "bfloat16")
    assert want["/img_proj/b"] == ((4096,), "float32")
    for n in ("attn_gate", "mlp_gate"):
        assert want[f"/groups/cross/{n}"] == ((8,), "float32")
    assert want["/groups/cross/qnorm/g"] == ((8, 128), "float32")
    assert want["/groups/self3/mlp_norm/g"] == ((8, 4096), "float32")
    assert want["/embedding/emb"] == ((512, 4096), "bfloat16")
    assert want["/groups/cross/xattn/wk/vq/idx"] == ((8, 2, 512, 1024),
                                                      "uint8")


def test_vq_counts_at_full_width(full_width):
    """176 VQ linears (4 a self layer: wqkv, wo, gu, down; 6 a cross
    layer: wq, wk, wv, wo, gu, down) over 8.724 G weights, and their
    bytes (2 bits a weight, plus codebooks and scales)."""
    cfg, qp = full_width
    assert tq.count_vq_layers(qp) == 32 * 4 + 8 * 6 == 176
    vq_b, dense_b = tq.compressed_model_bytes(qp)
    D, F, kv = 4096, 14336, 1024
    attn = 2 * D * D + 2 * D * kv
    weights = 40 * (attn + 3 * D * F)
    assert weights == 8_724_152_320 and dense_b == 2 * weights
    assert weights // 4 < vq_b < weights // 4 + 176 * 2 * (8 * 256 * 4
                                                           + 28672 * 4)


# ------------------------------------------------- conversion and checkpoints


@pytest.mark.parametrize("kind", ["dense", "vq", "vq_ungrouped"])
def test_convert_carries_groups_both_ways(kind):
    """``"groups"`` becomes a list of 2 dicts of ``self0`` and ``cross``
    with 0-d gates (the reference's (G,) leaves, one value a group), and
    back, leaf for leaf."""
    s = setup()
    jp, tp = s["params"][kind]
    assert isinstance(tp["groups"], list) and len(tp["groups"]) == 2
    for g, want in enumerate(GATES["attn_gate"]):
        gate = tp["groups"][g]["cross"]["attn_gate"]
        assert gate.shape == () and gate.item() == np.float32(want)
    _assert_same(to_reference_layout(tp), jp)


@pytest.mark.parametrize("kind", ["vq", "dense"])
def test_checkpoint_files_byte_for_byte(kind, tmp_path):
    """The port writes the reference's files for a vision SMOKE tree (its
    ``groups`` stacked, the gates (G,)), and restores the reference's
    checkpoint bit for bit."""
    s = setup()
    jp, tp = s["params"][kind]
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(4, {"params": jp})
    CheckpointManager(str(tmp_path / "port")).save(4, {"params": tp})
    ref, port = (tmp_path / d / "step_0000000004" for d in ("ref", "port"))
    assert (port / "MANIFEST.json").read_bytes() == \
        (ref / "MANIFEST.json").read_bytes()
    assert b"groups/cross/attn_gate" in (ref / "MANIFEST.json").read_bytes()
    mine, want = (_npz_members(d / "params.npz") for d in (port, ref))
    assert list(mine) == list(want)
    for name, data in want.items():
        assert mine[name] == data, name
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    step, state = CheckpointManager(str(tmp_path / "ref")).restore(
        device="cpu")
    assert step == 4
    _assert_bitwise(state["params"], tp)
