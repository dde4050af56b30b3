"""Port of the int4 KV cache (``Model.init_cache(kv_int4=True)``, the
reference's ``jnp.int4`` leaves), held against the JAX reference on
llama2 SMOKE at fp32 with the reference's params converted.

Torch has no int4 dtype: the port packs two two's-complement nibbles a
byte, ``(..., hd / 2)`` int8 with the even column in the low nibble
(``models.common.pack_int4``), and ``models.common.kv_layout`` tells the
layouts apart by the cache's last dim against the new rows' head dim
(KV-VQ's uint8 indices are as wide at kv_bits 4). Held:

  * the values (unpacked) and bf16 scales bit-equal to the reference's
    ``_quantize_kv(x, jnp.int4)`` and ``quantize_prefill_cache_int8(...,
    int4=True)``;
  * decode logits over an int4 cache within 1e-4 x max|logit| of the
    reference's (op by op, ``jax.disable_jit``, both from the reference's
    fp prefill cache), and the cache leaves after the steps;
  * paged == contiguous EXACTLY inside the port, plain and kernel policy;
  * the paging geometry: the port's int4 block counts half a byte a
    value, where the reference's ``jnp.int4`` leaves count one (2176
    bytes a block for both of its layouts at block 4; the port's int4
    block is 1152).
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import quantize as jq
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.serve import kvcache as jkv
from repro.serve import paging as jpg
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.plan import PlanPolicy
from repro_torch.core.vq import KVQuantConfig
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as tcm
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import paging as tpg
from repro_torch.serve.engine import _insert_slot

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
CAP, BS = 32, 4


def _i8(a):
    """numpy int8 of a JAX int4 array."""
    return np.asarray(jnp.asarray(a).astype(jnp.int8))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    salt = lambda s: sum(map(ord, s))  # pin the reference's hash salt
    with mock.patch.object(jq, "hash", salt, create=True):
        jp = jm.quantize(jm.init(KEY), method="synthetic", key=KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    return {"jm": jm, "jp": jp, "m": build_model(cfg), "cfg": cfg,
            "tp": from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")}


def test_pack_unpack_every_nibble():
    q = torch.arange(-8, 8, dtype=torch.int8).repeat(6).reshape(3, 2, 16)
    q = q[..., torch.randperm(16, generator=torch.Generator().manual_seed(0))]
    packed = tcm.pack_int4(q)
    assert packed.shape == (3, 2, 8) and packed.dtype == torch.int8
    assert torch.equal(tcm.unpack_int4(packed), q)
    assert torch.equal(packed[0, 0, 0] & 0xF, q[0, 0, 0] & 0xF)  # low: even


@pytest.mark.parametrize("shape", [(2, 5, 4, 32), (1, 1, 2, 8), (3, 7, 1, 64)])
def test_quantize_kv_int4_bit_equal(shape):
    x = (np.random.default_rng(len(shape) + shape[-1]).standard_normal(shape)
         * 3).astype(np.float32)
    x[0, 0, 0, 1] = 50.0                      # an outlier channel
    x[-1, -1, -1] = 0.0                       # an all-zero row
    jqv, js = jcm._quantize_kv(jnp.asarray(x), jnp.int4)
    q, s = tcm._quantize_kv(torch.from_numpy(x), int4=True)
    assert q.shape == shape[:-1] + (shape[-1] // 2,) and q.dtype == torch.int8
    np.testing.assert_array_equal(tcm.unpack_int4(q).numpy(), _i8(jqv))
    assert s.dtype == torch.bfloat16
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    assert np.abs(_i8(jqv)).max() <= 7


def test_quantize_prefill_cache_int4_equals_reference(setup):
    toks = np.random.default_rng(1).integers(0, 512, (2, 11)).astype(np.int32)
    _, jc = setup["jm"].prefill(setup["jp"], {"tokens": jnp.asarray(toks)},
                                jcm.RunConfig(mode="prefill", remat=False,
                                              attn_chunk=8))
    tc = {"body": {n: torch.from_numpy(np.array(a))
                   for n, a in jc["body"].items()}}
    want = jkv.quantize_prefill_cache_int8(jc, int4=True)["body"]
    got = tkv.quantize_prefill_cache_int8(tc, int4=True)["body"]
    assert set(got) == set(want) == {"k", "v", "k_s", "v_s", "len"}
    for n in ("k", "v"):
        assert got[n].shape[-1] * 2 == want[n].shape[-1]
        np.testing.assert_array_equal(tcm.unpack_int4(got[n]).numpy(),
                                      _i8(want[n]))
    for n in ("k_s", "v_s"):
        np.testing.assert_array_equal(got[n].float().numpy(),
                                      np.asarray(want[n].astype(jnp.float32)))
    np.testing.assert_array_equal(got["len"].numpy(), np.asarray(want["len"]))
    int8 = tkv.quantize_prefill_cache_int8(tc)["body"]
    assert int8["k"].shape[-1] == got["k"].shape[-1] * 2


def test_init_cache_layouts(setup):
    m, jm = setup["m"], setup["jm"]
    want = jm.init_cache(3, CAP, kv_int4=True)["body"]
    got = m.init_cache(3, CAP, device="cpu", kv_int4=True)["body"]
    for n, w in want.items():
        g = got[n]
        if n in ("k", "v"):
            assert w.dtype == jnp.int4 and g.dtype == torch.int8
            assert tuple(g.shape) == w.shape[:-1] + (w.shape[-1] // 2,)
        else:
            assert tuple(g.shape) == w.shape, n
        assert not g.any()
    assert tcm.kv_layout(got, setup["cfg"].head_dim) == "int4"
    specs = m.cache_specs(3, CAP, kv_int4=True)["body"]
    assert {n: (t.shape, t.dtype) for n, t in specs.items()} == \
        {n: (t.shape, t.dtype) for n, t in got.items()}
    layouts = {"fp": {}, "int8": {"kv_int8": True}, "int4": {"kv_int4": True},
               "kvq": {"kvq": KVQuantConfig(kv_bits=4)}}
    for name, kw in layouts.items():
        node = m.init_cache(1, CAP, device="cpu", **kw)["body"]
        assert tcm.kv_layout(node, setup["cfg"].head_dim) == name
    with pytest.raises(ValueError, match="mutually exclusive"):
        m.init_cache(1, CAP, device="cpu", kv_int4=True,
                     kvq=KVQuantConfig(kv_bits=4))
    with pytest.raises(ValueError, match="kv_int8 is mutually exclusive"):
        m.init_cache(1, CAP, device="cpu", kv_int8=True, kv_int4=True)
    with pytest.raises(ValueError, match="kv_int8 is mutually exclusive"):
        tpg.make_paging_config(m, 1, CAP, block_size=BS, kv_int8=True,
                               kv_int4=True)
    mla = build_model(get_smoke_config("deepseek_v2_lite_16b"))
    with pytest.raises(ValueError, match="no MLA latent layout"):
        mla.init_cache(1, CAP, device="cpu", kv_int4=True)
    shapes = lambda tree: [{n: (t.shape, t.dtype) for n, t in node.items()}
                           for node in tpg.attn_nodes(tree)]
    for family in ("xlstm_125m", "whisper_medium"):  # ignored, as the ref
        other = build_model(get_smoke_config(family))
        assert shapes(other.init_cache(1, CAP, device="cpu", kv_int4=True)) \
            == shapes(other.init_cache(1, CAP, device="cpu"))


def test_decode_logits_match_reference(setup):
    """The reference's fp prefill cache quantized by each package (an
    int4 code at a rounding edge would otherwise flip on fp32
    reassociation alone), padded, then 5 decode steps: logits within
    1e-4 x max|logit|, the cache leaves as the reference's after."""
    from test_torch_model import _close

    jm, jp, m, tp = setup["jm"], setup["jp"], setup["m"], setup["tp"]
    toks = np.random.default_rng(7).integers(0, 512, (2, 15)).astype(np.int32)
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=8)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])}, jrc)
    tc = {"body": {n: torch.from_numpy(np.array(a))
                   for n, a in jc["body"].items()}}
    jc = jkv.pad_prefill_cache(jkv.quantize_prefill_cache_int8(jc, int4=True),
                               CAP)
    tc = tkv.pad_prefill_cache(tkv.quantize_prefill_cache_int8(tc, int4=True),
                               CAP)
    for i in range(5):
        pos = 10 + i
        with jax.disable_jit():
            want, jc = jm.decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                                 jnp.full((2, 1), pos, jnp.int32), jc,
                                 jrc.replace(mode="decode"))
        with torch.no_grad():
            got, tc = m.decode(tp, torch.from_numpy(toks[:, pos:pos + 1]),
                               torch.full((2, 1), pos, dtype=torch.int32), tc,
                               RunConfig(mode="decode"))
        _close(got.numpy(), np.asarray(want), 1e-4)
    body, jbody = tc["body"], jc["body"]
    assert body["len"].tolist() == [[15, 15]] * 2
    for n in ("k", "v"):
        got_v, want_v = tcm.unpack_int4(body[n]).numpy(), _i8(jbody[n])
        diff = np.abs(got_v.astype(np.int32) - want_v.astype(np.int32))
        # the decode rows are quantized from each side's own fp32 rows:
        # a code on a rounding edge may land one step apart
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 0.02 * diff.size
    for n in ("k_s", "v_s"):
        np.testing.assert_allclose(body[n].float().numpy(),
                                   np.asarray(jbody[n].astype(jnp.float32)),
                                   rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_paged_equals_contiguous_exactly(setup, impl):
    """Three prompts prefilled into a contiguous and a paged int4 cache
    (a shuffled table), four decode steps on both: the logits bit for
    bit, and the paged view equal to the contiguous cache below each
    slot's length."""
    m, tp = setup["m"], setup["tp"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (9, 13, 5)]
    B = len(prompts)
    meta = tpg.make_paging_config(m, B, CAP, block_size=BS, kv_int4=True)
    paged = m.init_cache(B, CAP, device="cpu", paging=meta, kv_int4=True)
    cont = m.init_cache(B, CAP, device="cpu", kv_int4=True)
    perm = np.random.default_rng(0).permutation(meta.num_blocks)
    tables = perm.reshape(B, meta.blocks_per_slot).astype(np.int32)
    tpg.set_block_tables(paged, tables)
    for b, p in enumerate(prompts):
        with torch.no_grad():
            _, fresh = m.prefill(tp, {"tokens": torch.from_numpy(p[None])},
                                 RunConfig(mode="prefill", attn_chunk=8))
        fresh = tkv.quantize_prefill_cache_int8(fresh, int4=True)
        _insert_slot(cont, tkv.pad_prefill_cache(fresh, CAP,
                                                 true_len=len(p)), b)
        tpg.write_prefill_into_blocks(
            paged, fresh, torch.tensor([b]), torch.from_numpy(tables[b]),
            torch.tensor([len(p)], dtype=torch.int32), meta)
    rc = RunConfig(mode="decode", plan_policy=PlanPolicy(impl=impl))
    pos = np.array([[len(p)] for p in prompts], np.int32)
    for _ in range(4):
        toks = rng.integers(0, 512, (B, 1)).astype(np.int32)
        with torch.no_grad():
            a, _ = m.decode(tp, torch.from_numpy(toks), torch.from_numpy(pos),
                            cont, rc)
            b, _ = m.decode(tp, torch.from_numpy(toks), torch.from_numpy(pos),
                            paged, rc)
        assert torch.equal(a, b)
        pos = pos + 1
    bt = torch.from_numpy(tables)
    lens = cont["body"]["len"][0].tolist()
    for name in ("k", "v", "k_s", "v_s"):
        for i in range(setup["cfg"].num_layers):
            view = tcm.paged_view(paged["body"][name][i, :meta.num_blocks], bt)
            for b, n in enumerate(lens):
                assert torch.equal(view[b, :n], cont["body"][name][i, b, :n])


def test_paging_bytes_per_block(setup):
    m, jm = setup["m"], setup["jm"]
    geo = dict(block_size=4)
    want8 = jpg.make_paging_config(jm, 2, 16, kv_int8=True, **geo)
    want4 = jpg.make_paging_config(jm, 2, 16, kv_int4=True, **geo)
    got8 = tpg.make_paging_config(m, 2, 16, kv_int8=True, **geo)
    got4 = tpg.make_paging_config(m, 2, 16, kv_int4=True, **geo)
    assert want8.bytes_per_block == want4.bytes_per_block == 2176
    assert dataclasses.asdict(got8) == dataclasses.asdict(want8)
    cfg = setup["cfg"]
    values = 2 * cfg.num_layers * 4 * cfg.num_kv_heads * cfg.head_dim
    assert got4.bytes_per_block == 1152 == want4.bytes_per_block - values // 2
    assert {**dataclasses.asdict(got4), "bytes_per_block": 0} == \
        {**dataclasses.asdict(want4), "bytes_per_block": 0}
