"""Port of the compressed KV caches (KV-VQ at kv_bits 4/2, int8 at
kv_bits 8) and of INT8 prefill, held against the JAX reference on the
CPU with the same numpy inputs:

  * ``KVQuantConfig`` geometry and errors; grid codebooks equal;
    ``kv_encode`` indices BIT-EQUAL and ``kv_decode`` within 1e-6
    (scales may differ by one ulp: the "rms" mean sums in another order);
  * ``attach_kv_codebooks`` / ``kv_codebook_tree`` and the ``kv_cb``
    leaves ``from_jax_params`` carries; ``encode_prefill_cache`` and
    ``quantize_prefill_cache_int8`` bit-equal; ``pad_prefill_cache``
    pads the scale leaves;
  * the decode branches of ``attention_fwd`` over both caches: outputs
    within 1e-5 * max|y| (fp32 reassociation), the written cache rows
    bit-equal;
  * the planner's int8 / kvq_attn sites resolve to one backend per impl;
  * ``Engine`` greedy streams IDENTICAL to the JAX engine on llama2
    SMOKE at fp32 with 2-bit VQ weights, for kv_bits 8/4/2 with and
    without ``int8_prefill``; kv_bits=3 raises.
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
from repro.core.plan import PlanPolicy as JaxPlanPolicy
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve import kvcache as jkv
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import plan as plan_mod
from repro_torch.core import quantize as tq
from repro_torch.core import vq as tvq
from repro_torch.core.plan import PlanPolicy
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as tcm
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve import kvcache as tkv

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
GEOMETRIES = [(4, 1), (4, 2), (2, 1)]


def _stable_hash(s: str) -> int:
    """A process-independent stand-in for ``hash`` of a string."""
    return zlib.crc32(s.encode())


def _np(a):
    """numpy view of a tensor or JAX array, bf16 widened to fp32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ core/vq.py


@pytest.mark.parametrize("kv_bits,residual", GEOMETRIES)
def test_config_geometry_matches_reference(kv_bits, residual):
    mine = tvq.KVQuantConfig(kv_bits=kv_bits, residual=residual)
    ref = jvq.KVQuantConfig(kv_bits=kv_bits, residual=residual)
    assert mine.vec_d == ref.vec_d
    for dim in (32, 64, 128):
        assert mine.groups(dim) == ref.groups(dim)
        assert mine.idx_width(dim) == ref.idx_width(dim)
    np.testing.assert_array_equal(
        tvq.kv_grid_codebooks(4, 32, mine).numpy(),
        np.asarray(jvq.kv_grid_codebooks(4, 32, ref)))


@pytest.mark.parametrize("kw,match", [
    ({"kv_bits": 3}, "kv_bits"), ({"entries": 16}, "entries"),
    ({"variant": "max"}, "variant"), ({"residual": 0}, "residual"),
])
def test_config_errors_match_reference(kw, match):
    for mod in (tvq, jvq):
        with pytest.raises(ValueError, match=match):
            mod.KVQuantConfig(**kw)
    with pytest.raises(ValueError, match="vec_d"):
        tvq.KVQuantConfig(kv_bits=2).groups(30)
    for mod in (tvq, jvq):  # no grid: 12 channels a group, the fit's job
        with pytest.raises(ValueError, match="use fit_kv_codebooks"):
            mod.kv_grid_codebooks(4, 36, mod.KVQuantConfig(kv_bits=2,
                                                           residual=3))


@pytest.mark.parametrize("variant", ["outlier", "rms"])
@pytest.mark.parametrize("kv_bits,residual", GEOMETRIES)
def test_kv_encode_bit_equal_and_decode(kv_bits, residual, variant):
    rng = np.random.default_rng(kv_bits * 10 + residual)
    x = (rng.standard_normal((3, 7, 4, 32)) * 2).astype(np.float32)
    x[0, 0, 0, 5] = 40.0  # an outlier channel
    ref_cfg = jvq.KVQuantConfig(kv_bits=kv_bits, residual=residual,
                                variant=variant)
    cb = np.asarray(jvq.kv_grid_codebooks(4, 32, ref_cfg))
    ji, js = jvq.kv_encode(jnp.asarray(x), jnp.asarray(cb), variant)
    ti, ts = tvq.kv_encode(_t(x), _t(cb), variant)
    assert ti.dtype == torch.uint8
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(
        tvq.kv_decode(ti, ts, _t(cb)).numpy(),
        np.asarray(jvq.kv_decode(ji, js, jnp.asarray(cb))),
        rtol=1e-6, atol=1e-6)


# --------------------------------------------------- params and caches


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    # the reference salts its synthetic quantization key with
    # hash(str(shape)), which changes with the process's hash seed: pin
    # it, so every process (every xdist worker) holds the same params
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(jm.init(KEY), method="synthetic", key=KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    conv = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t),
                                     device="cpu")
    return {"jm": jm, "jcfg": jcfg, "jparams": vq, "cfg": cfg,
            "m": build_model(cfg), "params": conv(vq), "conv": conv}


@pytest.mark.parametrize("kv_bits", [4, 2])
def test_attach_kv_codebooks_matches_reference(setup, kv_bits):
    kvq = tvq.KVQuantConfig(kv_bits=kv_bits)
    jp = jq.attach_kv_codebooks(setup["jparams"], setup["jcfg"],
                                jvq.KVQuantConfig(kv_bits=kv_bits))
    mine = tq.attach_kv_codebooks(setup["params"], setup["cfg"], kvq)
    carried = setup["conv"](jp)  # from_jax_params unstacks the kv_cb leaves
    want = np.asarray(jq.kv_codebook_tree(jp)["body"]["k"])
    for tree in (mine, carried):
        got = tq.kv_codebook_tree(tree)
        assert set(got) == {"body"}
        for n in ("k", "v"):
            np.testing.assert_array_equal(got["body"][n].numpy(), want)
        assert set(tree["layers"][0]["attn"]["kv_cb"]) == {"k", "v"}
    assert "kv_cb" not in setup["params"]["layers"][0]["attn"]
    with pytest.raises(ValueError, match="kv_cb"):
        tq.kv_codebook_tree(setup["params"])


def _fp_cache(seed, L=2, B=1, S=12, Hk=4, hd=32):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, B, S, Hk, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, S, Hk, hd)).astype(np.float32)
    return {"body": {"k": k, "v": v, "len": np.full((L, B), S, np.int32)}}


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(_t, tree))


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for n in want:
        if isinstance(want[n], dict):
            _assert_tree_equal(got[n], want[n])
            continue
        assert str(got[n].dtype).replace("torch.", "") == str(want[n].dtype)
        np.testing.assert_array_equal(_np(got[n]), _np(want[n]))


@pytest.mark.parametrize("kv_bits", [8, 4, 2])
def test_prefill_cache_quantized_and_padded_as_reference(kv_bits):
    jc, tc = _both(_fp_cache(kv_bits))
    if kv_bits == 8:
        want = jkv.quantize_prefill_cache_int8(jc)
        got = tkv.quantize_prefill_cache_int8(tc)
    else:
        jk = jvq.KVQuantConfig(kv_bits=kv_bits)
        tk = tvq.KVQuantConfig(kv_bits=kv_bits)
        cb = np.asarray(jvq.kv_grid_codebooks(4, 32, jk))
        cbs = np.broadcast_to(cb, (2,) + cb.shape)
        want = jkv.encode_prefill_cache(
            jc, {"body": {"k": jnp.asarray(cbs), "v": jnp.asarray(cbs)}}, jk)
        tcbs = {"body": {"k": _t(cbs), "v": _t(cbs)}}
        got = tkv.encode_prefill_cache(tc, tcbs, tk)
        # an encoded node passes through
        assert tkv.encode_prefill_cache(got, tcbs, tk)["body"] is got["body"]
    _assert_tree_equal(got, want)
    padded = tkv.pad_prefill_cache(got, 32, true_len=9)
    _assert_tree_equal(padded, jkv.pad_prefill_cache(want, 32, true_len=9))
    body = padded["body"]
    assert body["k_s"].shape == (2, 1, 32, 4) and body["k"].shape[2] == 32
    assert not body["k_s"][:, :, 12:].any() and (body["len"] == 9).all()


def _layer(tree):
    """Layer 0's attention params of a stacked JAX param tree."""
    return jax.tree_util.tree_map(lambda a: a[0], tree["layers"]["attn"])


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("kv_bits", [8, 4, 2])
def test_decode_attention_over_compressed_cache(setup, kv_bits, impl):
    """Two decode steps of ``attention_fwd`` over a prefilled compressed
    cache (rows of lengths 5 and 9): same outputs, same cache rows."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp = setup["jparams"]
    jk = tk = None
    if kv_bits != 8:
        jk, tk = (jvq.KVQuantConfig(kv_bits=kv_bits),
                  tvq.KVQuantConfig(kv_bits=kv_bits))
        jp = jq.attach_kv_codebooks(jp, jcfg, jk)
    tp = setup["conv"](jp)["layers"][0]["attn"]
    jpl = _layer(jp)
    fp = _fp_cache(kv_bits, L=1, B=2, S=16)
    fp["body"]["len"][:] = [5, 9]
    jc, tc = _both(fp)
    if tk is None:
        jc = jkv.quantize_prefill_cache_int8(jc)["body"]
        tc = tkv.quantize_prefill_cache_int8(tc)["body"]
    else:
        cbs = {"body": {n: jpl["kv_cb"][n][None] for n in ("k", "v")}}
        jc = jkv.encode_prefill_cache(jc, cbs, jk)["body"]
        tc = tkv.encode_prefill_cache(
            tc, {"body": {n: tp["kv_cb"][n][None] for n in ("k", "v")}},
            tk)["body"]
    jc = {n: a[0] for n, a in jc.items()}
    tc = {n: t[0] for n, t in tc.items()}
    jrc = jcm.RunConfig(mode="decode", remat=False, kv_vq=jk)
    trc = RunConfig(mode="decode", kv_vq=tk,
                    plan_policy=PlanPolicy(impl=impl))
    rng = np.random.default_rng(kv_bits)
    for step in range(2):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([[5 + step], [9 + step]], np.int32)
        jy, jc = jcm.attention_fwd(jpl, jnp.asarray(x), jrc, jcfg,
                                   positions=jnp.asarray(pos), cache=jc)
        ty, tc2 = tcm.attention_fwd(tp, _t(x), trc, cfg, positions=_t(pos),
                                    cache=tc)
        assert tc2 is tc  # updated in place
        want = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        _assert_tree_equal(tc, jc)


# --------------------------------------------------------------- planner


@pytest.mark.parametrize("impl,int8_backend,kvq_backend", [
    ("torch", "int8_torch", "kvq_dequant_torch"),
    ("cuda", "int8_cuda", "kvq_flash_cuda"),
])
def test_planner_kinds_resolve_one_backend_per_impl(impl, int8_backend,
                                                    kvq_backend):
    pol = PlanPolicy(impl=impl, int8_prefill=True)
    x = torch.zeros((3, 64))
    node = {"w": torch.zeros((64, 128))}
    assert plan_mod.plan_node(node, x, mode="prefill",
                              policy=pol).backend == int8_backend
    assert plan_mod.plan_node(node, x, mode="decode",
                              policy=pol).backend == "fp"
    assert plan_mod.plan_node(node, x, mode="prefill",
                              policy=PlanPolicy(impl=impl)).backend == "fp"
    spec = plan_mod.kvq_attention_spec(
        B=2, S=16, H=4, Hk=4, hd=32, idx_width=16, entries=256,
        x_dtype=torch.float32, out_dtype=torch.float32)
    assert (spec.M, spec.K, spec.N, spec.C, spec.V, spec.k, spec.d) == \
        (2, 16, 128, 4, 16, 256, 32)
    assert plan_mod.plan(spec, pol).backend == kvq_backend
    assert plan_mod.plan(spec, pol) is plan_mod.plan(spec, pol)
    with pytest.raises(ValueError, match="kind"):
        plan_mod.LinearSpec.for_dense(node["w"], M=1, x_dtype=torch.float32,
                                      out_dtype=torch.float32, kind="fp8")


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("int8_prefill", [False, True])
@pytest.mark.parametrize("kv_bits", [8, 4, 2])
def test_greedy_streams_identical_to_jax_engine(setup, kv_bits, int8_prefill):
    """More requests than slots, two prefill buckets; the port under
    impl="torch" and under impl="cuda" (its wrappers' plain versions on
    the CPU) against the reference's jnp engine."""
    rng = np.random.default_rng(kv_bits)
    prompts = [rng.integers(0, setup["cfg"].vocab_size, n).astype(np.int32)
               for n in (5, 9, 7, 4, 6)]
    jrc = jcm.RunConfig(mode="decode", remat=False, attn_chunk=16,
                        plan_policy=JaxPlanPolicy(int8_prefill=int8_prefill))
    want = JaxEngine(setup["jm"], setup["jparams"], jrc,
                     JaxEngineConfig(num_slots=2, max_len=32,
                                     kv_bits=kv_bits)).generate(prompts, 6)
    for impl in ("torch", "cuda"):
        rc = RunConfig(attn_chunk=16, plan_policy=PlanPolicy(
            impl=impl, int8_prefill=int8_prefill))
        eng = Engine(setup["m"], setup["params"], rc,
                     EngineConfig(num_slots=2, max_len=32, kv_bits=kv_bits),
                     device="cpu")
        assert eng.generate(prompts, 6) == want, impl
        body = eng.caches["body"]
        assert body["k"].dtype == (torch.int8 if kv_bits == 8 else torch.uint8)
        assert body["k_s"].dtype == torch.bfloat16
        fp_bytes = 2 * 2 * 2 * 32 * 4 * 32 * 4  # k+v, L, B, S, Hk, hd, fp32
        assert eng.metrics()["kv_bytes_in_use"] < fp_bytes / 3


def test_kv_bits_validation(setup):
    with pytest.raises(ValueError, match="kv_bits"):
        Engine(setup["m"], setup["params"], RunConfig(),
               EngineConfig(num_slots=1, max_len=32, kv_bits=3),
               device="cpu")
