"""The port's multi-head latent attention (``repro_torch/models/common.py``
``mla_fwd``) and its caches held against the JAX reference
(``repro/models/common.py:741-930``, ``repro/serve/kvcache.py``,
``repro/serve/paging.py``) on the CPU at fp32, on deepseek-v2-lite's
SMOKE config (4 heads, kv_lora_rank 64, rope 16) with the reference's
2-bit VQ params converted (the synthetic quantization's salt pinned):

  * ``mla_fwd`` within 1e-5 x max|y| (fp32 reassociation in the EVA and
    dequant matmuls): prefill (the expand, ``blocked_attention`` with q/k
    head dim 48 against v's 32, the fresh {"latent", "k_rope", "len"}
    cache); one decode step over a contiguous and over a paged cache
    (shuffled table, sentinel rows), each with an fp latent and a
    4-bit KV-VQ latent, each by expand and by absorb — one row mid-cache
    and one at capacity (the reference overwrites the last slot) — and
    the written cache leaves (fp within 1e-5, KV-VQ indices and scales
    equal);
  * the grouped ``wq_kva`` equals its split members (the reference's
    ``test_mla_grouped_matches_split_members``, rtol/atol 1e-4) and is
    built where the reference builds it (``test_mla_q_kva_grouped``);
  * ``moe_route`` at deepseek's E = 64, k = 6: ids, keep mask and
    positions bit-equal to the reference's lines, with random gates,
    many-way ties and overflow;
  * the caches: ``pad_prefill_cache`` on a latent (``len`` overridden by
    the true length, ``tests/test_kvcache.py``'s
    ``test_mla_latent_len_overridden``), ``encode_prefill_cache`` on a
    latent, ``init_cache`` layouts with the ``"pre"`` subtree, the paged
    geometry and arenas, and a prefill written into blocks, all equal to
    the reference's.
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
from repro.serve import kvcache as jkv
from repro.serve import paging as jpaging
from repro_torch import configs as tconfigs
from repro_torch.convert import from_jax_params
from repro_torch.core import quantize as tq
from repro_torch.core import vq as tvq
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as tcm
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import paging as tpaging

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCH = "deepseek_v2_lite_16b"
SC, BS = 16, 4                  # decode capacity, paged block size


def _stable_hash(s: str) -> int:
    """A process-independent stand-in for ``hash`` of a string."""
    return zlib.crc32(s.encode())


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


def _conv(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@functools.lru_cache(maxsize=None)
def setup():
    """The reference's SMOKE model at fp32, its 2-bit VQ params (salt
    pinned) and the same with the 4-bit KV-VQ latent codebooks, each
    with its conversion."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    dense = jm.init(KEY)
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(dense, method="synthetic", key=KEY)
        flat = jq.quantize_params(dense, jcfg, method="synthetic", key=KEY,
                                  group_projections=False)
    jk, tk = jvq.KVQuantConfig(kv_bits=4), tvq.KVQuantConfig(kv_bits=4)
    kv = jq.attach_kv_codebooks(vq, jcfg, jk)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32")
    trees = {"dense": dense, "vq": vq, "vq_ungrouped": flat, "kv4": kv}
    return {"jcfg": jcfg, "cfg": cfg, "jm": jm, "m": build_model(cfg),
            "jkvq": jk, "tkvq": tk,
            "params": {k: (t, _conv(t)) for k, t in trees.items()}}


def _block(s, kind, seg="layers"):
    """Layer 0's attention params of segment ``seg`` in both packages."""
    jp, tp = s["params"][kind]
    return (jax.tree_util.tree_map(lambda a: a[0], jp[seg]["attn"]),
            tp[seg][0]["attn"])


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


# -------------------------------------------------------------------- prefill


@pytest.mark.parametrize("kind", ["vq", "vq_ungrouped", "dense"])
def test_mla_prefill_matches_reference(kind):
    s = setup()
    jb, tb = _block(s, kind)
    assert ("wq_kva" in tb) == (kind == "vq")
    x = _x(2, 11, s["cfg"].d_model, 1)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11)).copy()
    want, jc = jcm.mla_fwd(jb, jnp.asarray(x), jcm.RunConfig(
        mode="prefill", remat=False, attn_chunk=4), s["jcfg"],
        positions=jnp.asarray(pos))
    with torch.no_grad():
        got, tc = tcm.mla_fwd(tb, _t(x), RunConfig(mode="prefill",
                                                   attn_chunk=4),
                              s["cfg"], positions=_t(pos))
    _close(got.numpy(), want)
    assert set(tc) == set(jc) == {"latent", "k_rope", "len"}
    for n in ("latent", "k_rope"):
        assert tuple(tc[n].shape) == jc[n].shape
        _close(tc[n].numpy(), jc[n])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["len"].dtype == torch.int32


# --------------------------------------------------------------------- decode


def _decode_caches(s, kv_bits, seed):
    """A contiguous decode cache of SC positions for 2 rows from the
    reference's fp prefill of SC tokens (KV-VQ: encoded by the reference
    against the latent codebook), with lengths 7 (mid-cache) and SC (at
    capacity: the next write overwrites the last slot), in both
    packages' layouts; the block's params."""
    jb, tb = _block(s, "kv4" if kv_bits == 4 else "vq")
    x = _x(2, SC, s["cfg"].d_model, seed)
    pos = np.broadcast_to(np.arange(SC, dtype=np.int32), (2, SC))
    _, jc = jcm.mla_fwd(jb, jnp.asarray(x), jcm.RunConfig(
        mode="prefill", remat=False, attn_chunk=8), s["jcfg"],
        positions=jnp.asarray(pos))
    lens = np.array([7, SC], np.int32)
    cache = {"latent": np.array(jc["latent"]), "k_rope": np.array(jc["k_rope"]),
             "len": lens}
    if kv_bits == 4:
        idx, sc = jvq.kv_encode(jc["latent"][:, :, None, :],
                                jb["kv_cb"]["lat"], "outlier")
        cache["latent"] = np.array(idx[:, :, 0, :])
        cache["latent_s"] = np.array(sc.astype(jnp.bfloat16)).astype(np.float32)
    return jb, tb, cache


def _to_jax(cache):
    return {n: (jnp.asarray(a).astype(jnp.bfloat16) if n == "latent_s"
                else jnp.asarray(a)) for n, a in cache.items()}


def _to_port(cache):
    return {n: (_t(a).to(torch.bfloat16) if n == "latent_s" else _t(a))
            for n, a in cache.items()}


def _paged(cache, perm):
    """The contiguous (2, SC, F) leaves as block arenas: row b's logical
    block j at physical block perm[b * W + j]; the table's last entry of
    row 0 on the sentinel. Returns (jax cache, port cache): the port's
    arenas carry one sink block past the reference's NB."""
    W = SC // BS
    NB = 2 * W + 2
    table = perm[:2 * W].reshape(2, W).astype(np.int32)
    table[0, -1] = NB                  # row 0 never reaches its last block
    jc, tc = {}, {}
    for n, a in cache.items():
        if n == "len":
            continue
        arena = np.zeros((NB + 1, BS) + a.shape[2:], a.dtype)
        for b in range(2):
            for j in range(W):
                arena[table[b, j]] = a[b, j * BS:(j + 1) * BS]
        jc[n], tc[n] = arena[:NB], arena
    jc, tc = _to_jax(jc), _to_port(tc)
    for c in (jc, tc):
        c["len"] = (jnp.asarray if c is jc else _t)(cache["len"])
        c["block_table"] = (jnp.asarray if c is jc else _t)(table)
    return jc, tc


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
@pytest.mark.parametrize("kv_bits", [16, 4], ids=["fp", "kv4"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_mla_decode_matches_reference(layout, kv_bits, absorb):
    s = setup()
    jb, tb, cache = _decode_caches(s, kv_bits, seed=kv_bits)
    if layout == "paged":
        perm = np.random.default_rng(3).permutation(2 * SC // BS + 2)
        jc, tc = _paged(cache, perm)
    else:
        jc, tc = _to_jax(cache), _to_port(cache)
    x = _x(2, 1, s["cfg"].d_model, 11)
    pos = cache["len"][:, None].astype(np.int32)
    jrc = jcm.RunConfig(mode="decode", remat=False, mla_absorb=absorb,
                        kv_vq=s["jkvq"] if kv_bits == 4 else None)
    trc = RunConfig(mode="decode", mla_absorb=absorb,
                    kv_vq=s["tkvq"] if kv_bits == 4 else None)
    want, jnew = jcm.mla_fwd(jb, jnp.asarray(x), jrc, s["jcfg"],
                             positions=jnp.asarray(pos), cache=jc)
    with torch.no_grad():
        got, tnew = tcm.mla_fwd(tb, _t(x), trc, s["cfg"], positions=_t(pos),
                                cache=tc)
    assert tnew is tc                              # written in place
    _close(got.numpy(), want)
    assert set(tnew) == set(jnew)
    np.testing.assert_array_equal(tnew["len"].numpy(), cache["len"] + 1)
    for n, w in jnew.items():
        g = tnew[n]
        if layout == "paged" and n != "block_table" and n != "len":
            g = g[:-1]                             # the sink
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
        assert g.shape == w.shape, n
        if g.dtype == np.float32 and n != "latent_s":
            _close(g, w)
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)


def test_mla_prefill_over_a_cache_raises_as_reference():
    """Chunked prefill over a paged latent cache is refused, as the
    reference refuses it."""
    s = setup()
    jb, tb, cache = _decode_caches(s, 16, seed=0)
    jc, tc = _paged(cache, np.arange(2 * SC // BS + 2))
    x = _x(2, 3, s["cfg"].d_model, 0)
    pos = np.broadcast_to(np.arange(3, dtype=np.int32), (2, 3)).copy()
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        jcm.mla_fwd(jb, jnp.asarray(x), jcm.RunConfig(mode="prefill",
                                                      remat=False),
                    s["jcfg"], positions=jnp.asarray(pos), cache=jc)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        tcm.mla_fwd(tb, _t(x), RunConfig(mode="prefill"), s["cfg"],
                    positions=_t(pos), cache=tc)


# ------------------------------------------------------------ grouped wq_kva


def test_mla_grouped_matches_split_members():
    """The port's own quantization groups wq|wkv_a into ``wq_kva`` (splits
    H(dn + dr), r + dr); the same block with the grouped weight split
    back into its members (``core.vq.split_grouped``) gives the same
    output within rtol/atol 1e-4 (the reference's test)."""
    s = setup()
    cfg = s["cfg"]
    gen = torch.Generator().manual_seed(0)
    block = tcm.make_mla(gen, cfg, device="cpu", block_device="cpu")
    pg = tq.quantize_params({"layers": [{"attn": block}]}, cfg,
                            method="synthetic",
                            generator=gen, device="cpu")["layers"][0]["attn"]
    assert pg["wq_kva"]["vq"].splits == (192, 80)
    ps = {k: v for k, v in pg.items() if k != "wq_kva"}
    for name, vq in zip(("wq", "wkv_a"), tvq.split_grouped(pg["wq_kva"]["vq"])):
        ps[name] = {"vq": vq}
    x = _t(_x(2, 3, cfg.d_model, 5))
    pos = torch.arange(3, dtype=torch.int32)[None].expand(2, 3)
    rc = RunConfig(mode="prefill", attn_chunk=8)
    with torch.no_grad():
        yg, _ = tcm.mla_fwd(pg, x, rc, cfg, positions=pos)
        ys, _ = tcm.mla_fwd(ps, x, rc, cfg, positions=pos)
    np.testing.assert_allclose(yg.numpy(), ys.numpy(), rtol=1e-4, atol=1e-4)


def test_mla_q_kva_grouped_where_the_reference_groups():
    """Both segments' MLA blocks carry ``wq_kva`` with the reference's
    splits and keep ``wkv_b`` and ``wo`` their own leaves, in the port's
    quantization and in the converted reference params alike."""
    s = setup()
    cfg = s["cfg"]
    splits = (cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim),
              cfg.kv_lora_rank + cfg.qk_rope_dim)
    gen = torch.Generator().manual_seed(1)
    own = s["m"].quantize(s["m"].init(gen, device="cpu"), method="synthetic",
                          generator=gen,
                          device="cpu")
    for tree in (own, s["params"]["vq"][1]):
        for seg in ("pre_layers", "layers"):
            for layer in tree[seg]:
                blk = layer["attn"]
                assert "wq" not in blk and "wkv_a" not in blk
                assert blk["wq_kva"]["vq"].splits == splits
                assert blk["wkv_b"]["vq"].splits == ()
                assert "vq" in blk["wo"] and "g" in blk["kv_norm"]
    assert len(own["pre_layers"]) == cfg.first_dense_layers == 1
    assert len(own["layers"]) == cfg.num_layers - 1
    assert "mlp" in own["pre_layers"][0] and "moe" in own["layers"][0]


# -------------------------------------------------------------------- routing


def _reference_route(logits, jcfg):
    """The reference's routing lines (``models/common.py:1053-1066``)."""
    T, E, k = logits.shape[0], jcfg.num_experts, jcfg.top_k
    gates = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    topv, topi = jax.lax.top_k(gates, k)
    cap = min(max(1, int(np.ceil(T * k / E * jcfg.capacity_factor))), T)
    flat = jax.nn.one_hot(topi, E, dtype=jnp.float32).reshape(T * k, E)
    pos = jnp.einsum("se,se->s", jnp.cumsum(flat, axis=0) - flat,
                     flat).astype(jnp.int32)
    return (np.asarray(topi), np.asarray(pos < cap), np.asarray(pos),
            np.asarray(topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)),
            cap)


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["cap", "overflow"])
@pytest.mark.parametrize("gates", ["random", "ties", "equal"])
@pytest.mark.parametrize("T", [1, 4, 200, 1024])
def test_routing_top6_of_64_bit_equal(T, gates, cf):
    """deepseek's full routing, E = 64, k = 6: random fp32 logits, logits
    from {0, 1, 2} (ties several ways deep: the lower ids first) and all
    equal; at the config's capacity factor and at 0.25 (most choices
    past capacity)."""
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH), capacity_factor=cf)
    cfg = dataclasses.replace(tconfigs.get_config(ARCH), capacity_factor=cf)
    assert (cfg.num_experts, cfg.top_k) == (64, 6)
    rng = np.random.default_rng(T)
    logits = {"random": rng.standard_normal((T, 64)) * 3,
              "ties": rng.integers(0, 3, (T, 64)),
              "equal": np.zeros((T, 64))}[gates].astype(np.float32)
    topi, topv, pos, keep, cap = tcm.moe_route(_t(logits), cfg)
    want_i, want_keep, want_pos, want_v, want_cap = _reference_route(logits,
                                                                    jcfg)
    assert cap == want_cap == tcm.moe_capacity(cfg, T)
    np.testing.assert_array_equal(topi.numpy(), want_i)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_allclose(topv.numpy(), want_v, rtol=1e-6, atol=0)
    if cf < 1 and T > 1:
        assert not keep.all()


# --------------------------------------------------------------------- caches


def _latent_cache(S=12, r=4, dr=2, seed=0, kvq=False):
    rng = np.random.default_rng(seed)
    c = {"latent": rng.normal(size=(1, S, r)).astype(np.float32),
         "k_rope": rng.normal(size=(1, S, dr)).astype(np.float32),
         "len": np.full((1,), S, np.int32)}
    if kvq:
        c["latent"] = rng.integers(0, 256, (1, S, r)).astype(np.uint8)
        c["latent_s"] = rng.normal(size=(1, S, 1)).astype(np.float32)
    return c


@pytest.mark.parametrize("kvq", [False, True], ids=["fp", "kvq"])
@pytest.mark.parametrize("true_len", [None, 7, 12])
def test_pad_prefill_cache_latent_as_reference(true_len, kvq):
    c = _latent_cache(kvq=kvq)
    jc, tc = _to_jax(c), _to_port(c)
    want = jkv.pad_prefill_cache(
        jc, 16, true_len=None if true_len is None
        else jnp.asarray(true_len, jnp.int32))
    got = tkv.pad_prefill_cache(tc, 16, true_len=true_len)
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        np.testing.assert_array_equal(g, w, err_msg=n)
    assert got["latent"].shape[1] == 16
    np.testing.assert_array_equal(got["len"].numpy(),
                                  12 if true_len is None else true_len)


def test_encode_prefill_cache_latent_as_reference():
    """The reference's fp prefill cache of the SMOKE model, both segments,
    encoded by each package against its converted latent codebooks:
    indices and bf16 scales equal."""
    s = setup()
    jp, tp = s["params"]["kv4"]
    toks = np.random.default_rng(2).integers(0, 512, (2, 9)).astype(np.int32)
    _, jc = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks)}, jcm.RunConfig(
        mode="prefill", remat=False, attn_chunk=8))
    tc = {seg: {n: _t(a) for n, a in node.items()} for seg, node in jc.items()}
    want = jkv.encode_prefill_cache(jc, jq.kv_codebook_tree(jp), s["jkvq"])
    got = tkv.encode_prefill_cache(tc, tq.kv_codebook_tree(tp), s["tkvq"])
    assert set(got) == set(want) == {"pre", "body"}
    for seg in want:
        assert set(got[seg]) == set(want[seg])
        np.testing.assert_array_equal(got[seg]["latent"].numpy(),
                                      np.asarray(want[seg]["latent"]))
        np.testing.assert_array_equal(
            got[seg]["latent_s"].float().numpy(),
            np.asarray(want[seg]["latent_s"].astype(jnp.float32)))
    cbs, jcbs = tq.kv_codebook_tree(tp), jq.kv_codebook_tree(jp)
    for seg, L in (("pre", 1), ("body", 2)):
        assert tuple(cbs[seg]["lat"].shape) == jcbs[seg]["lat"].shape
        assert cbs[seg]["lat"].shape[:2] == (L, 1)


@pytest.mark.parametrize("kv_bits", [16, 4])
def test_init_cache_layouts_as_reference(kv_bits):
    s = setup()
    kw_j = {"kvq": s["jkvq"]} if kv_bits == 4 else {}
    kw_t = {"kvq": s["tkvq"]} if kv_bits == 4 else {}
    want = s["jm"].init_cache(3, 20, **kw_j)
    got = s["m"].init_cache(3, 20, device="cpu", **kw_t)
    assert set(got) == set(want) == {"pre", "body"}
    for seg in want:
        assert {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for n, t in got[seg].items()} == \
            {n: (a.shape, str(a.dtype)) for n, a in want[seg].items()}
    with pytest.raises(ValueError, match="no MLA latent layout"):
        s["m"].init_cache(3, 20, device="cpu", kv_int8=True)


@pytest.mark.parametrize("kv_bits", [16, 4])
def test_paged_geometry_and_prefill_blocks_as_reference(kv_bits):
    """make_paging_config (bytes a block over both segments' latent
    leaves), init_paged_cache (arenas, one sink block past the
    reference's) and write_prefill_into_blocks of a 9-token prompt equal
    to the reference's, the sink excluded."""
    s = setup()
    jp, tp = s["params"]["kv4" if kv_bits == 4 else "vq"]
    jk, tk = (s["jkvq"], s["tkvq"]) if kv_bits == 4 else (None, None)
    jmeta = jpaging.make_paging_config(s["jm"], 2, 24, block_size=4, kvq=jk)
    tmeta = tpaging.make_paging_config(s["m"], 2, 24, block_size=4, kvq=tk)
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    jc = jpaging.init_paged_cache(s["jm"], 2, 24, jmeta, kvq=jk)
    tc = s["m"].init_cache(2, 24, device="cpu", paging=tmeta,
                           **({"kvq": tk} if tk else {}))
    toks = np.random.default_rng(4).integers(0, 512, (1, 9)).astype(np.int32)
    _, fresh = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks)},
                               jcm.RunConfig(mode="prefill", remat=False,
                                             attn_chunk=8))
    if jk is not None:
        fresh = jkv.encode_prefill_cache(fresh, jq.kv_codebook_tree(jp), jk)
    tfresh = {seg: {n: (_t(np.array(a.astype(jnp.float32))).bfloat16()
                        if a.dtype == jnp.bfloat16 else _t(a))
                    for n, a in node.items()} for seg, node in fresh.items()}
    row = np.array([5, 2, 0, 1, 3, 4], np.int32)
    jc = jpaging.write_prefill_into_blocks(jc, fresh, 1, row,
                                           jnp.asarray(9, jnp.int32), jmeta)
    tpaging.write_prefill_into_blocks(
        tc, tfresh, torch.tensor([1]), _t(row),
        torch.tensor([9], dtype=torch.int32), tmeta)
    for seg in ("pre", "body"):
        assert set(tc[seg]) == set(jc[seg])
        for n, w in jc[seg].items():
            g = tc[seg][n]
            if n in ("latent", "k_rope", "latent_s"):
                g = g[:, :-1]                       # the sink
            g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
            w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                           else w)
            np.testing.assert_array_equal(g, w, err_msg=f"{seg}/{n}")
    assert [n["len"][0, 1].item() for n in tpaging.attn_nodes(tc)] == [9, 9]
