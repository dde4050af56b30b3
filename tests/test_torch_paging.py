"""Port of the paged KV memory (``repro_torch/serve/paging.py``, the paged
branches of ``models/common.attention_fwd`` and the engine's block
allocation, growth, freeing and preemption), held against the JAX
reference on llama2 SMOKE at fp32 with the same numpy inputs and the
reference's params converted:

  * geometry and ``BlockPool`` (the cases of tests/test_paging.py) equal
    to the reference's, ``make_paging_config`` field for field at every
    cache layout;
  * ``init_paged_cache``, ``write_prefill_into_blocks``, ``set_block_tables``,
    ``slot_view`` and ``merge_slot`` on a shuffled table with sentinel
    rows: the reference's arenas are the port's ``arena[:, :NB]``, bit-
    equal (the port's last block is the sink);
  * a paged decode step of the whole model against the reference's: the
    arenas and logits as ``tests/test_torch_model.py`` holds the
    contiguous cache (KV-VQ indices and scales bit-equal, fp rows within
    1e-5 * max, int8 codes within one step; logits within 1e-4 * max, over
    int8 max / 127);
  * the sentinel collision: a live slot owns block NB - 1 while a free
    slot's decode row and a chunk's pad rows are dropped in the same step;
  * paged == contiguous EXACTLY inside the port (fp, int8, KV-VQ; the
    plain and the kernel policy), chunked == one-shot prefill at 1e-4;
  * greedy engine streams IDENTICAL to the JAX engine's with a parity
    pool, a tight pool that preempts, ``prefill_chunk`` and kv_bits 8 and
    4, with the same ``preemptions``, ``prefill_chunks`` and
    ``peak_blocks_in_use``, the gauges drained to zero at the end; a
    sampled stream with a preemption equal to the same stream without.
"""
import dataclasses
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import quantize as jq
from repro.core import vq as jvq
from repro.models import build_model as jax_build_model
from repro.models.common import RunConfig as JaxRunConfig
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve import kvcache as jkv
from repro.serve import paging as jpg
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import quantize as tq
from repro_torch.core import vq as tvq
from repro_torch.core.plan import PlanPolicy
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as tcm
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams)
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import paging as tpg
from repro_torch.serve.engine import _insert_slot
from repro_torch.serve.kvcache import pad_prefill_cache

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
CAP, BS = 32, 4


def _stable_hash(s: str) -> int:
    """A process-independent stand-in for ``hash`` of a string."""
    return zlib.crc32(s.encode())


def _np(a):
    """numpy of a tensor or JAX array, bf16 widened to fp32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    # the reference salts its synthetic quantization key with
    # hash(str(shape)), which changes with the process's hash seed: pin
    # it, so every process (every xdist worker) holds the same params
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        jp = jm.quantize(jm.init(KEY), method="synthetic", key=KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    conv = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t),
                                     device="cpu")
    return {"jm": jm, "jp": jp, "m": build_model(cfg), "tp": conv(jp),
            "cfg": cfg, "conv": conv}


def _layout(setup, kv_bits):
    """(port kwargs, JAX kwargs, port params, JAX params, port encoder,
    JAX encoder) of a cache layout; KV-VQ codebooks attached to both."""
    jp, tp = setup["jp"], setup["tp"]
    if kv_bits == 16:
        ident = lambda c: c
        return {}, {}, tp, jp, ident, ident
    if kv_bits == 8:
        return ({"kv_int8": True}, {"kv_int8": True}, tp, jp,
                tkv.quantize_prefill_cache_int8, jkv.quantize_prefill_cache_int8)
    tk, jk = tvq.KVQuantConfig(kv_bits=kv_bits), jvq.KVQuantConfig(kv_bits=kv_bits)
    jp = jq.attach_kv_codebooks(jp, setup["jm"].cfg, jk)
    tp = setup["conv"](jp)
    return ({"kvq": tk}, {"kvq": jk}, tp, jp,
            lambda c: tkv.encode_prefill_cache(c, tq.kv_codebook_tree(tp), tk),
            lambda c: jkv.encode_prefill_cache(c, jq.kv_codebook_tree(jp), jk))


def _rc(kw, mode, **extra):
    return RunConfig(mode=mode, kv_vq=kw.get("kvq"), **extra)


def _jrc(kw, mode, **extra):
    return JaxRunConfig(mode=mode, remat=False, kv_vq=kw.get("kvq"), **extra)


# ------------------------------------------------------------ geometry


@pytest.mark.parametrize("block_size,page_len",
                         [(4, 32), (32, 32), (12, 32), (7, 32), (16, 512)])
def test_effective_block_size_matches_reference(block_size, page_len):
    assert (tpg.effective_block_size(block_size, page_len)
            == jpg.effective_block_size(block_size, page_len))
    for mod in (tpg, jpg):
        with pytest.raises(ValueError):
            mod.effective_block_size(0, page_len)


@pytest.mark.parametrize("n", [0, 1, 9, -3, 1000])
def test_blocks_for_len_matches_reference(n):
    assert (tpg.blocks_for_len(n, block_size=4, page_len=32)
            == jpg.blocks_for_len(n, block_size=4, page_len=32))


POOL_SCRIPTS = {
    "lifo": (4, [("alloc", 3), ("free", [1]), ("alloc", 1), ("free", [2, 0]),
                 ("alloc", 2)]),
    "all_or_nothing": (3, [("alloc", 4), ("alloc", 3), ("alloc", 1),
                           ("alloc", 0), ("alloc", -1)]),
    "free_guards": (3, [("alloc", 2), ("free", [0, 1]), ("free", [0]),
                        ("free", [3])]),
    "state_restore": (5, [("alloc", 2), ("free", [0]), ("state",),
                          ("alloc", 1), ("alloc", 2), ("restore_saved",),
                          ("alloc", 1), ("alloc", 2), ("restore", [1, 1]),
                          ("restore", [7])]),
}


def _run_pool(mod, n, script):
    pool, saved, out = mod.BlockPool(n), None, []
    for op, *args in script:
        try:
            if op == "state":
                r = saved = pool.state()
            elif op == "restore_saved":
                r = pool.restore(saved)
            else:
                r = getattr(pool, op)(*args)
            out.append(("ok", r, pool.free_count, pool.used_count))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


@pytest.mark.parametrize("name", list(POOL_SCRIPTS))
def test_block_pool_matches_reference(name):
    n, script = POOL_SCRIPTS[name]
    got = _run_pool(tpg, n, script)
    assert got == _run_pool(jpg, n, script)
    if name == "lifo":  # ids 0, 1, 2; the last freed comes back first
        assert [r[1] for r in got if r[0] == "ok" and r[1]] == [
            [0, 1, 2], [1], [0, 2]]


@pytest.mark.parametrize("kv_bits", [16, 8, 4, 2])
@pytest.mark.parametrize("slots,block_size,num_blocks",
                         [(3, 4, None), (2, 12, None), (2, 4, 9)])
def test_make_paging_config_matches_reference(setup, kv_bits, slots,
                                              block_size, num_blocks):
    tkw, jkw, *_ = _layout(setup, kv_bits)
    mine = tpg.make_paging_config(setup["m"], slots, CAP,
                                  block_size=block_size,
                                  num_blocks=num_blocks, **tkw)
    ref = jpg.make_paging_config(setup["jm"], slots, CAP,
                                 block_size=block_size,
                                 num_blocks=num_blocks, **jkw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_paging_config_refusals(setup):
    for mod, model in ((tpg, setup["m"]), (jpg, setup["jm"])):
        with pytest.raises(ValueError, match="one full slot"):
            mod.make_paging_config(model, 2, CAP, block_size=BS,
                                   num_blocks=CAP // BS - 1)
    # a sliding window: the ring's geometry (page_len = min(max_len,
    # window)), as the reference's
    ring = tpg.make_paging_config(setup["m"], 2, CAP, window=16)
    assert ring.page_len == 16
    assert dataclasses.asdict(ring) == dataclasses.asdict(
        jpg.make_paging_config(setup["jm"], 2, CAP, window=16))


# ------------------------------------------------------- the paged cache


def _tables(meta, fills, seed):
    """(B, W) tables: slot b owns ``fills[b]`` blocks, drawn from a
    shuffled pool; the rest of every row is the sentinel."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(meta.num_blocks)
    t = np.full((len(fills), meta.blocks_per_slot), meta.sentinel, np.int32)
    i = 0
    for b, n in enumerate(fills):
        t[b, :n] = perm[i:i + n]
        i += n
    return t


def _arenas_equal(tc, jc, meta):
    """The reference's arenas are the port's without its sink; the rest
    of the paged node (table, len) equal."""
    jb, tb = jc["body"], tc["body"]
    assert set(tb) == set(jb)
    for name, w in jb.items():
        g = tb[name]
        if name in ("k", "v", "k_s", "v_s"):
            assert g.shape[1] == meta.num_blocks + 1
            g = g[:, :meta.num_blocks]
        assert g.dtype == getattr(torch, str(np.asarray(w).dtype)), name
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_prefill_into_blocks_tables_and_slot_view_match_reference(setup,
                                                                  kv_bits):
    """A shuffled table with a free row (all sentinel): two fresh prefill
    caches (numpy, the same for both) commit into slots 0 and 2 with
    true lengths short of their bucket, so the pad positions and the
    positions past slot 2's blocks are dropped; the arenas, tables and
    ``len`` equal the reference's bit for bit, and a slot view and its
    merge give the reference's leaves."""
    tkw, jkw, _, _, tenc, jenc = _layout(setup, kv_bits)
    cfg = setup["cfg"]
    L, Hk, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    meta = tpg.make_paging_config(setup["m"], 3, CAP, block_size=BS, **tkw)
    jmeta = jpg.make_paging_config(setup["jm"], 3, CAP, block_size=BS, **jkw)
    tc = setup["m"].init_cache(3, CAP, device="cpu", paging=meta, **tkw)
    jc = jpg.init_paged_cache(setup["jm"], 3, CAP, jmeta, **jkw)
    assert tpg.is_paged(tc) and jpg.is_paged(jc)
    _arenas_equal(tc, jc, meta)
    tables = _tables(meta, (4, 0, 2), seed=kv_bits)
    rng = np.random.default_rng(kv_bits)
    for slot, P, true_len in ((0, 16, 13), (2, 16, 11)):
        fresh = {"body": {
            "k": rng.standard_normal((L, 1, P, Hk, hd)).astype(np.float32),
            "v": rng.standard_normal((L, 1, P, Hk, hd)).astype(np.float32),
            "len": np.full((L, 1), P, np.int32)}}
        tpg.write_prefill_into_blocks(
            tc, tenc(jax.tree_util.tree_map(torch.from_numpy, fresh)),
            torch.tensor([slot]), torch.from_numpy(tables[slot]),
            torch.tensor([true_len], dtype=torch.int32), meta)
        jc = jpg.write_prefill_into_blocks(
            jc, jenc(jax.tree_util.tree_map(jnp.asarray, fresh)), slot,
            tables[slot], jnp.asarray(true_len, jnp.int32), jmeta)
    tpg.set_block_tables(tc, tables)
    jc = jpg.set_block_tables(jc, tables)
    _arenas_equal(tc, jc, meta)
    assert tc["body"]["len"][:, [0, 2]].tolist() == [[13, 11]] * L

    # the view of slot 2 with 11 committed positions and a 5-position chunk
    hist, true_c, slot = 11, 5, 2
    tv = tpg.slot_view(tc, torch.tensor([slot]),
                       torch.from_numpy(tables[slot]),
                       torch.tensor([hist], dtype=torch.int32),
                       torch.tensor([true_c], dtype=torch.int32))
    jv = jpg.slot_view(jc, slot, tables[slot], hist, true_c)
    assert set(tv["body"]) == set(jv["body"])
    for name in ("block_table", "len", "prefill_len"):
        np.testing.assert_array_equal(_np(tv["body"][name]),
                                      _np(jv["body"][name]), err_msg=name)
    assert tv["body"]["k"] is tc["body"]["k"]  # the arenas are shared
    tv["body"]["len"] += true_c
    jv["body"]["len"] = jv["body"]["len"] + true_c
    tpg.merge_slot(tc, tv, torch.tensor([slot]))
    jc = jpg.merge_slot(jc, jv, slot)
    _arenas_equal(tc, jc, meta)


def _prompt_caches(setup, kv_bits, prompts, cap=CAP):
    """Each framework's prefill cache of each prompt (batch 1), encoded
    into the layout, with its first-token logits."""
    tkw, jkw, tp, jp, tenc, jenc = _layout(setup, kv_bits)
    out = []
    for p in prompts:
        jl, jc = setup["jm"].prefill(jp, {"tokens": jnp.asarray(p[None])},
                                     _jrc(jkw, "prefill", attn_chunk=8))
        with torch.no_grad():
            tl, tc = setup["m"].prefill(tp, {"tokens": torch.from_numpy(p[None])},
                                        _rc(tkw, "prefill", attn_chunk=8))
        out.append((tenc(tc), jenc(jc)))
    return out


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_paged_decode_step_matches_reference(setup, kv_bits):
    """Two prompts prefilled into slots 0 and 1 of a 3-slot paged cache
    (shuffled table, slot 2 free), then two decode steps of the whole
    model: the port's arenas and logits against the reference's."""
    from test_torch_model import _assert_cache_as_reference, _close

    tkw, jkw, tp, jp, *_ = _layout(setup, kv_bits)
    rng = np.random.default_rng(10 + kv_bits)
    prompts = [rng.integers(0, setup["cfg"].vocab_size, n).astype(np.int32)
               for n in (9, 6)]
    meta = tpg.make_paging_config(setup["m"], 3, CAP, block_size=BS, **tkw)
    jmeta = jpg.make_paging_config(setup["jm"], 3, CAP, block_size=BS, **jkw)
    tc = setup["m"].init_cache(3, CAP, device="cpu", paging=meta, **tkw)
    jc = jpg.init_paged_cache(setup["jm"], 3, CAP, jmeta, **jkw)
    tables = _tables(meta, (3, 2, 0), seed=kv_bits)
    for slot, (tf, jf) in enumerate(_prompt_caches(setup, kv_bits, prompts)):
        n = len(prompts[slot])
        tpg.write_prefill_into_blocks(
            tc, tf, torch.tensor([slot]), torch.from_numpy(tables[slot]),
            torch.tensor([n], dtype=torch.int32), meta)
        jc = jpg.write_prefill_into_blocks(jc, jf, slot, tables[slot],
                                           jnp.asarray(n, jnp.int32), jmeta)
    tpg.set_block_tables(tc, tables)
    jc = jpg.set_block_tables(jc, tables)
    pos = np.array([[9], [6], [0]], np.int32)
    for step in range(2):
        toks = rng.integers(0, setup["cfg"].vocab_size, (3, 1)).astype(np.int32)
        want, jc = setup["jm"].decode(jp, jnp.asarray(toks), jnp.asarray(pos),
                                      jc, _jrc(jkw, "decode"))
        with torch.no_grad():
            got, tc = setup["m"].decode(tp, torch.from_numpy(toks),
                                        torch.from_numpy(pos), tc,
                                        _rc(tkw, "decode"))
        _close(got.numpy()[:2], np.asarray(want)[:2],
               rel=1 / 127 if kv_bits == 8 else 1e-4)
        pos = pos + 1
    NB = meta.num_blocks
    tb = {n: (t[:, :NB] if n in ("k", "v", "k_s", "v_s") else t)
          for n, t in tc["body"].items()}
    _assert_cache_as_reference(tb, jc["body"])


def test_sentinel_writes_never_touch_a_live_block(setup):
    """The sentinel collision: slot 0 owns block NB - 1 and writes its
    next row there while, in the same decode step, free slot 1 writes a
    row that the reference drops; and a chunk of slot 1 with pad rows
    past its true length (dropped too) runs beside it. Every dropped row
    goes to the sink: slot 0's row in block NB - 1 is its own, its logits
    equal the contiguous cache's, and the chunk leaves block NB - 1 as it
    was."""
    m, tp = setup["m"], setup["tp"]
    L, NB = setup["cfg"].num_layers, 6
    meta = tpg.make_paging_config(m, 2, 16, block_size=BS, num_blocks=NB)
    tc = m.init_cache(2, 16, device="cpu", paging=meta)
    rng = np.random.default_rng(3)
    body = tc["body"]
    for name in ("k", "v"):
        body[name].copy_(torch.from_numpy(
            rng.standard_normal(body[name].shape).astype(np.float32)))
    tables = np.array([[2, 0, 1, NB - 1], [NB] * 4], np.int32)
    tpg.set_block_tables(tc, tables)
    body["len"].fill_(12)
    # a contiguous cache whose slot 0 holds slot 0's 12 positions in order
    cont = m.init_cache(2, 16, device="cpu")
    for name in ("k", "v"):
        for i in range(L):
            cont["body"][name][i, 0] = tcm.paged_view(
                body[name][i, :NB], torch.from_numpy(tables[:1]))[0]
    cont["body"]["len"].fill_(12)
    rc = RunConfig(mode="decode")
    step = (torch.tensor([[7], [9]], dtype=torch.int32),
            torch.full((2, 1), 12, dtype=torch.int32))
    with torch.no_grad():
        got, _ = m.decode(tp, *step, tc, rc)
        want, _ = m.decode(tp, *step, cont, rc)
    assert torch.equal(got[0], want[0])
    for name in ("k", "v"):
        assert torch.equal(body[name][:, NB - 1, 0], cont["body"][name][:, 0, 12])
    before = {n: body[n][:, NB - 1].clone() for n in ("k", "v")}

    # slot 1's chunk: 3 real positions from 4, an 8-position bucket; its
    # table row holds blocks 3 and 4, then the sentinel
    row = np.array([3, 4, NB, NB], np.int32)
    view = tpg.slot_view(tc, torch.tensor([1]), torch.from_numpy(row),
                         torch.tensor([4], dtype=torch.int32),
                         torch.tensor([3], dtype=torch.int32))
    chunk = torch.from_numpy(rng.integers(0, 64, (1, 8)).astype(np.int32))
    with torch.no_grad():
        m.forward(tp, {"tokens": chunk,
                       "positions": 4 + torch.arange(8, dtype=torch.int32)[None]},
                  RunConfig(mode="prefill", attn_chunk=8), caches=view)
    tpg.merge_slot(tc, view, torch.tensor([1]))
    for name in ("k", "v"):
        assert torch.equal(body[name][:, NB - 1], before[name]), name
    assert body["len"][:, 1].tolist() == [7] * L


def _one_shot_and_paged(setup, kv_bits, prompts, impl):
    """Slots filled with each prompt's prefill, contiguous and paged (a
    shuffled table), and four decode steps on both; returns the logits
    of each step, contiguous and paged."""
    tkw, _, tp, _, tenc, _ = _layout(setup, kv_bits)
    m = setup["m"]
    B = len(prompts)
    meta = tpg.make_paging_config(m, B, CAP, block_size=BS, **tkw)
    paged = m.init_cache(B, CAP, device="cpu", paging=meta, **tkw)
    cont = m.init_cache(B, CAP, device="cpu", **tkw)
    tables = _tables(meta, [meta.blocks_per_slot] * B, seed=kv_bits)
    tpg.set_block_tables(paged, tables)
    for b, p in enumerate(prompts):
        with torch.no_grad():
            _, fresh = m.prefill(tp, {"tokens": torch.from_numpy(p[None])},
                                 _rc(tkw, "prefill", attn_chunk=8))
        fresh = tenc(fresh)
        _insert_slot(cont, pad_prefill_cache(fresh, CAP, true_len=len(p)), b)
        tpg.write_prefill_into_blocks(
            paged, fresh, torch.tensor([b]), torch.from_numpy(tables[b]),
            torch.tensor([len(p)], dtype=torch.int32), meta)
    rc = _rc(tkw, "decode", plan_policy=PlanPolicy(impl=impl))
    rng = np.random.default_rng(5)
    pos = np.array([[len(p)] for p in prompts], np.int32)
    out = []
    for _ in range(4):
        toks = rng.integers(0, setup["cfg"].vocab_size, (B, 1)).astype(np.int32)
        with torch.no_grad():
            a, _ = m.decode(tp, torch.from_numpy(toks), torch.from_numpy(pos),
                            cont, rc)
            b, _ = m.decode(tp, torch.from_numpy(toks), torch.from_numpy(pos),
                            paged, rc)
        out.append((a, b))
        pos = pos + 1
    return out, cont, paged, tables, meta


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_paged_equals_contiguous_exactly(setup, kv_bits, impl):
    """Inside the port the paged cache gives the contiguous cache's
    logits bit for bit (the gathered view holds the same values at every
    position the mask shows), under the plain policy and the kernel
    policy (whose wrappers run their plain versions on the CPU), and the
    gathered view equals the contiguous cache below each slot's length."""
    rng = np.random.default_rng(kv_bits)
    prompts = [rng.integers(0, setup["cfg"].vocab_size, n).astype(np.int32)
               for n in (9, 13, 5)]
    out, cont, paged, tables, meta = _one_shot_and_paged(setup, kv_bits,
                                                         prompts, impl)
    for a, b in out:
        assert torch.equal(a, b)
    lens = cont["body"]["len"][0]
    assert torch.equal(paged["body"]["len"], cont["body"]["len"])
    bt = torch.from_numpy(tables)
    for name in ("k", "v", "k_s", "v_s"):
        if name not in cont["body"]:
            continue
        for i in range(setup["cfg"].num_layers):
            view = tcm.paged_view(paged["body"][name][i, :meta.num_blocks], bt)
            for b, n in enumerate(lens.tolist()):
                assert torch.equal(view[b, :n], cont["body"][name][i, b, :n])


def test_chunked_prefill_matches_one_shot_and_reference(setup):
    """The first 8 positions commit through the prefill write, the next
    4 through the continuation over a slot view: the last logits and the
    next decode step match a one-shot prefill of all 12 within 1e-4 (the
    reference's own tolerance, tests/test_paging.py), and the
    continuation's logits match the reference's continuation within
    1e-4 * max."""
    m, jm, tp, jp = setup["m"], setup["jm"], setup["tp"], setup["jp"]
    S, c1 = 12, 8
    toks = np.array(jax.random.randint(KEY, (1, S + 1), 0,
                                         setup["cfg"].vocab_size), np.int32)
    rc_p = RunConfig(mode="prefill", attn_chunk=8)
    with torch.no_grad():
        logits_os, fresh_os = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                                        rc_p)
        _, f1 = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :c1])}, rc_p)
    meta = tpg.make_paging_config(m, 1, CAP, block_size=BS)
    jmeta = jpg.make_paging_config(jm, 1, CAP, block_size=BS)
    row = np.random.default_rng(0).permutation(meta.num_blocks).astype(np.int32)
    paged = m.init_cache(1, CAP, device="cpu", paging=meta)
    tpg.write_prefill_into_blocks(paged, f1, torch.tensor([0]),
                                  torch.from_numpy(row),
                                  torch.tensor([c1], dtype=torch.int32), meta)
    tpg.set_block_tables(paged, row[None])
    view = tpg.slot_view(paged, torch.tensor([0]), torch.from_numpy(row),
                         torch.tensor([c1], dtype=torch.int32),
                         torch.tensor([S - c1], dtype=torch.int32))
    batch = {"tokens": torch.from_numpy(toks[:, c1:S]),
             "positions": c1 + torch.arange(S - c1, dtype=torch.int32)[None]}
    with torch.no_grad():
        logits_ch, view = m.forward(tp, batch, rc_p, caches=view)
    tpg.merge_slot(paged, view, torch.tensor([0]))
    np.testing.assert_allclose(logits_ch[:, -1].numpy(),
                               logits_os[:, -1].numpy(), rtol=1e-4, atol=1e-4)
    assert paged["body"]["len"].tolist() == [[S]] * setup["cfg"].num_layers

    # the reference's continuation from the same committed chunk
    jrc_p = JaxRunConfig(mode="prefill", remat=False, attn_chunk=8)
    _, jf1 = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :c1])}, jrc_p)
    jc = jpg.init_paged_cache(jm, 1, CAP, jmeta)
    jc = jpg.write_prefill_into_blocks(jc, jf1, 0, row,
                                       jnp.asarray(c1, jnp.int32), jmeta)
    jc = jpg.set_block_tables(jc, row[None])
    jv = jpg.slot_view(jc, 0, row, c1, S - c1)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks[:, c1:S]),
                            "positions": c1 + jnp.arange(S - c1,
                                                         dtype=jnp.int32)[None]},
                       jrc_p, caches=jv)
    want = np.asarray(jl)
    assert np.abs(logits_ch.numpy() - want).max() <= 1e-4 * np.abs(want).max()

    cont = pad_prefill_cache(fresh_os, CAP)
    rc_d = RunConfig(mode="decode")
    step = (torch.from_numpy(toks[:, S:S + 1]), torch.full((1, 1), S,
                                                           dtype=torch.int32))
    with torch.no_grad():
        lc, _ = m.decode(tp, *step, cont, rc_d)
        lp, _ = m.decode(tp, *step, paged, rc_d)
    np.testing.assert_allclose(lp.numpy(), lc.numpy(), rtol=1e-4, atol=1e-4)


def test_quantized_continuation_refuses(setup):
    """A continuation over an int8 or KV-VQ slot view raises, as the
    reference's does; a batch of two raises too."""
    m, tp = setup["m"], setup["tp"]
    for kw in ({"kv_int8": True}, {"kvq": tvq.KVQuantConfig(kv_bits=4)}):
        meta = tpg.make_paging_config(m, 1, CAP, block_size=BS, **kw)
        cache = m.init_cache(1, CAP, device="cpu", paging=meta, **kw)
        row = torch.arange(meta.blocks_per_slot, dtype=torch.int32)
        view = tpg.slot_view(cache, torch.tensor([0]), row,
                             torch.tensor([4], dtype=torch.int32),
                             torch.tensor([4], dtype=torch.int32))
        params = tp if "kv_int8" in kw else tq.attach_kv_codebooks(
            tp, setup["cfg"], kw["kvq"])
        with pytest.raises(NotImplementedError, match="quantized"):
            m.forward(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32),
                               "positions": 4 + torch.arange(8)[None]},
                      RunConfig(mode="prefill", kv_vq=kw.get("kvq")),
                      caches=view)


# ---------------------------------------------------------------- engine


ENGINE_CASES = {
    # name: (EngineConfig kwargs, prompt lengths)
    "parity": ({"num_slots": 2, "max_len": 32}, (5, 9, 7, 4, 6)),
    "tight": ({"num_slots": 3, "max_len": 64, "num_blocks": 17},
              (20, 16, 12, 8, 6, 4)),
    "chunk": ({"num_slots": 2, "max_len": 32, "prefill_chunk": 4},
              (12, 9, 6, 11, 5, 8)),
    "kv8": ({"num_slots": 2, "max_len": 32, "kv_bits": 8}, (12, 9, 6, 11, 5)),
    # quantized caches do not chunk: prefill_chunk is gated off
    "kv4": ({"num_slots": 2, "max_len": 32, "kv_bits": 4, "prefill_chunk": 4},
            (12, 9, 6, 11, 5)),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_paged_greedy_streams_identical_to_jax_engine(setup, name):
    kw, lens = ENGINE_CASES[name]
    kw = {**kw, "paged": True, "block_size": BS}
    rng = np.random.default_rng(len(name))
    prompts = [rng.integers(0, setup["cfg"].vocab_size, n).astype(np.int32)
               for n in lens]
    jeng = JaxEngine(setup["jm"], setup["jp"],
                     JaxRunConfig(mode="decode", remat=False, attn_chunk=16),
                     JaxEngineConfig(**kw))
    want = jeng.generate(prompts, 8)
    jm = jeng.metrics()
    for impl in ("torch", "cuda"):
        eng = Engine(setup["m"], setup["tp"],
                     RunConfig(attn_chunk=16, plan_policy=PlanPolicy(impl=impl)),
                     EngineConfig(**kw), device="cpu")
        assert eng.generate(prompts, 8) == want, impl
        m = eng.metrics()
        for key in ("preemptions", "prefill_chunks", "peak_blocks_in_use",
                    "peak_kv_bytes_in_use", "prefills", "admitted"):
            assert m[key] == jm[key], (key, m[key], jm[key])
        assert m["blocks_in_use"] == m["kv_bytes_in_use"] == 0
        assert m["blocks_free"] == eng.paging.num_blocks
        assert m["tokens_generated"] == m["prefills"] + m["decode_slot_steps"]
        assert eng.trace_counts["decode"] == 1
    assert (jm["preemptions"] >= 1) == (name == "tight")
    assert (jm["prefill_chunks"] >= 1) == (name == "chunk")


def test_sampled_stream_with_preemption_equals_uninterrupted(setup):
    """Mixed greedy, top-k and top-p requests: a pool that preempts gives
    every request the stream a parity pool and the contiguous engine
    give (the preempted slot's generator and budget are restored)."""
    rng = np.random.default_rng(7)
    reqs = []
    for i, n in enumerate((20, 16, 12, 8, 6, 4)):
        sp = (SamplingParams(greedy=False, temperature=0.8, top_k=20,
                             seed=100 + i) if i % 3 == 1 else
              SamplingParams(greedy=False, top_p=0.9, seed=200 + i)
              if i % 3 == 2 else SamplingParams())
        reqs.append(GenerationRequest(
            prompt=rng.integers(0, setup["cfg"].vocab_size, n).astype(np.int32),
            max_new_tokens=8, sampling=sp))

    def run(**kw):
        eng = Engine(setup["m"], setup["tp"], RunConfig(attn_chunk=16),
                     EngineConfig(num_slots=3, max_len=64, **kw), device="cpu")
        uids = [eng.submit(r) for r in reqs]
        while not eng.idle:
            eng.step()
        return eng, [eng.output(u).tokens for u in uids]

    tight, got = run(paged=True, block_size=BS, num_blocks=17)
    assert tight.metrics()["preemptions"] >= 1
    assert got == run(paged=True, block_size=BS)[1] == run()[1]


def test_paged_admission_is_length_aware(setup):
    """A paged engine takes ``max_new_tokens`` as a cap (the budget clamps
    to the capacity left) and rejects only a request the whole pool
    cannot hold at its peak."""
    eng = Engine(setup["m"], setup["tp"], RunConfig(attn_chunk=16),
                 EngineConfig(num_slots=2, max_len=16, paged=True,
                              block_size=BS), device="cpu")
    out = eng.generate([np.ones(10, np.int32)], 10)   # 10 + 10 - 1 > 16
    assert len(next(iter(out.values()))) == 16 - 10 + 1
    with pytest.raises(ValueError, match="one full slot"):
        Engine(setup["m"], setup["tp"], RunConfig(),
               EngineConfig(num_slots=2, max_len=16, paged=True,
                            block_size=BS, num_blocks=3), device="cpu")
