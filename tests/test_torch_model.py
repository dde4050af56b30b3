"""Port of the dense transformer, held against the JAX reference on the
llama2 SMOKE config at fp32, with the reference's params converted (not
regenerated: the reference salts its synthetic quantization with the
process's string hash, pinned below). Logits must agree within 1e-4 *
max|logit| (fp32 reassociation through two layers of attention and VQ matmuls), for the
dense and the 2-bit VQ params, in prefill and in decode; and the port's
own token-by-token decode must reproduce its full-sequence forward."""
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
from repro.models import build_model as jax_build_model
from repro.models.common import RunConfig as JaxRunConfig
from repro.serve.kvcache import pad_prefill_cache as jax_pad_prefill_cache
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models import RunConfig, build_model
from repro_torch.serve.kvcache import pad_prefill_cache

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
B, S_PROMPT, N_GEN, CAP = 2, 12, 4, 32


def _stable_hash(s: str) -> int:
    """A process-independent stand-in for ``hash`` of a string."""
    return zlib.crc32(s.encode())


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    dense = jm.init(KEY)
    # the reference salts its synthetic quantization key with the
    # process's string hash; pinned, so the params (and which fp32 value
    # lands on an int8 rounding edge) do not change with the hash seed
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(dense, method="synthetic", key=KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    conv = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t),
                                     device="cpu")
    tokens = np.array(jax.random.randint(KEY, (B, S_PROMPT + N_GEN), 0,
                                           jcfg.vocab_size), np.int32)
    return {"jm": jm, "m": build_model(cfg), "tokens": tokens,
            "params": {"dense": (dense, conv(dense)), "vq": (vq, conv(vq))}}


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


def test_config_fields_match_reference():
    from repro.models.common import ModelConfig as JaxModelConfig
    from repro_torch.models.common import ModelConfig

    mine = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxModelConfig)}
    assert mine == ref
    assert dataclasses.asdict(get_smoke_config("llama2_7b")) == \
        dataclasses.asdict(jax_smoke_config("llama2_7b"))


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_prefill_logits_match_jax(models, kind):
    jp, tp = models["params"][kind]
    toks = models["tokens"][:, :S_PROMPT]
    want, _ = models["jm"].prefill(jp, {"tokens": jnp.asarray(toks)},
                                   JaxRunConfig(remat=False, attn_chunk=8))
    with torch.no_grad():
        got, cache = models["m"].prefill(tp, {"tokens": torch.from_numpy(toks)},
                                         RunConfig(attn_chunk=8))
    _close(got.numpy(), want)
    assert cache["body"]["k"].shape == (2, B, S_PROMPT, 4, 32)
    assert cache["body"]["len"].tolist() == [[S_PROMPT] * B] * 2


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_decode_logits_match_jax(models, kind):
    """Prefill, pad the cache, then N_GEN decode steps on both sides."""
    jp, tp = models["params"][kind]
    jm, m, toks = models["jm"], models["m"], models["tokens"]
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S_PROMPT])},
                       JaxRunConfig(remat=False, attn_chunk=8))
    jc = jax_pad_prefill_cache(jc, CAP)
    with torch.no_grad():
        _, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S_PROMPT])},
                          RunConfig(attn_chunk=8))
        tc = pad_prefill_cache(tc, CAP)
        for i in range(N_GEN):
            pos = S_PROMPT + i
            want, jc = jm.decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                                 jnp.full((B, 1), pos, jnp.int32), jc,
                                 JaxRunConfig(remat=False))
            got, tc = m.decode(tp, torch.from_numpy(toks[:, pos:pos + 1]),
                               torch.full((B, 1), pos, dtype=torch.int32), tc,
                               RunConfig())
            _close(got.numpy(), want)
    assert tc["body"]["len"].tolist() == [[S_PROMPT + N_GEN] * B] * 2


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_decode_reproduces_full_forward(models, kind):
    """The port on its own: prefill + token-by-token decode equals the
    full-sequence forward at every generated position."""
    _, tp = models["params"][kind]
    m, toks = models["m"], torch.from_numpy(models["tokens"])
    with torch.no_grad():
        full, _ = m.forward(tp, {"tokens": toks}, RunConfig(attn_chunk=8))
        pre, cache = m.prefill(tp, {"tokens": toks[:, :S_PROMPT]},
                               RunConfig(attn_chunk=8))
        _close(pre[:, -1].numpy(), full[:, S_PROMPT - 1].numpy())
        cache = pad_prefill_cache(cache, CAP)
        for i in range(N_GEN):
            pos = S_PROMPT + i
            got, cache = m.decode(tp, toks[:, pos:pos + 1],
                                  torch.full((B, 1), pos, dtype=torch.int32),
                                  cache, RunConfig())
            _close(got[:, 0].numpy(), full[:, pos].numpy())


def test_decode_plain_policy_matches_kernel_policy(models):
    """impl="torch" (the plain formulations the card is compared with)
    and impl="cuda" (kernel wrappers, plain on the CPU) give the same
    logits."""
    _, tp = models["params"]["vq"]
    m, toks = models["m"], torch.from_numpy(models["tokens"])
    outs = []
    for impl in ("cuda", "torch"):
        rc = RunConfig(attn_chunk=8).replace_policy(impl=impl)
        with torch.no_grad():
            _, cache = m.prefill(tp, {"tokens": toks[:, :S_PROMPT]}, rc)
            cache = pad_prefill_cache(cache, CAP)
            got, _ = m.decode(tp, toks[:, S_PROMPT:S_PROMPT + 1],
                              torch.full((B, 1), S_PROMPT, dtype=torch.int32),
                              cache, rc)
        outs.append(got.numpy())
    _close(outs[0], outs[1])


def test_mask_pad_vocab_and_unported_families():
    from repro_torch.models.common import ModelConfig

    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), vocab_size=500)
    m = build_model(cfg)
    out = m._mask_pad_vocab(torch.zeros(2, cfg.padded_vocab))
    assert out.shape == (2, 512) and out[0, 500].item() == np.float32(-1e30)
    with pytest.raises(NotImplementedError,
                       match="local windows are ported in RecurrentGemma"):
        build_model(ModelConfig(name="x", family="dense", num_layers=1,
                                d_model=8, num_heads=1, num_kv_heads=1,
                                d_ff=8, vocab_size=8, local_window=4))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(ModelConfig(name="x", family="ssm", num_layers=1,
                                d_model=8, num_heads=1, num_kv_heads=1,
                                d_ff=8, vocab_size=8))
    if not torch.cuda.is_available():  # no GPU: the default device raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            m.init(torch.Generator())


def test_planner_dispatch_by_mode_and_policy(models):
    """decode -> eva_fused, prefill -> dequant, dense -> fp; equal
    (spec, policy) pairs return the SAME plan; bad policies raise."""
    from repro_torch.core import ops
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.plan import PlanPolicy, plan_node

    _, tp = models["params"]["vq"]
    node = tp["layers"][0]["attn"]["wqkv"]
    x = torch.zeros((4, 1, 128))
    pol = PlanPolicy()
    dec = plan_node(node, x, mode="decode", policy=pol)
    pre = plan_node(node, x, mode="prefill", policy=pol)
    assert (dec.backend, pre.backend) == ("eva_fused", "dequant")
    assert dec.spec.splits == (128, 128, 128) and dec.spec.M == 4
    assert dec.cost.macs == ops.vq_gemm_macs(4, 128, 8, 2, 8)
    assert dec.cost.lookup_adds == ops.epilogue_adds(4, 128, 384, 2, 8)
    hits = plan_mod._PLANNER.cache_info().hits
    assert plan_node(node, x, mode="decode", policy=pol) is dec
    assert plan_mod._PLANNER.cache_info().hits == hits + 1
    forced = plan_node(node, x, mode="decode",
                       policy=PlanPolicy(vq_mode="dequant", impl="torch"))
    assert forced.backend == "dequant" and forced.policy.impl == "torch"
    dense = plan_node(tp["lm_head"], x, mode="decode", policy=pol)
    assert dense.backend == "fp" and dense.spec.kind == "dense"
    for bad in ({"vq_mode": "fast"}, {"impl": "pallas"}):
        with pytest.raises(ValueError):
            PlanPolicy(**bad)



def _cache_kind(models, kv_bits):
    """The reference's VQ params (with KV codebooks attached below 8
    bits), their conversion, and how each side turns a prefilled fp cache
    into the cache of ``kv_bits``."""
    from repro.core import quantize as jq
    from repro.core import vq as jvq
    from repro.serve import kvcache as jkv
    from repro_torch.core import quantize as tq
    from repro_torch.core import vq as tvq
    from repro_torch.serve import kvcache as tkv

    jp, _ = models["params"]["vq"]
    jk = tk = None
    if kv_bits < 8:
        jk = jvq.KVQuantConfig(kv_bits=kv_bits)
        tk = tvq.KVQuantConfig(kv_bits=kv_bits)
        jp = jq.attach_kv_codebooks(jp, models["jm"].cfg, jk)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    if kv_bits == 8:
        jenc, tenc = (jkv.quantize_prefill_cache_int8,
                      tkv.quantize_prefill_cache_int8)
    elif kv_bits < 8:
        jenc = lambda c: jkv.encode_prefill_cache(c, jq.kv_codebook_tree(jp), jk)
        tenc = lambda c: tkv.encode_prefill_cache(c, tq.kv_codebook_tree(tp), tk)
    else:
        jenc = tenc = lambda c: c
    return jp, tp, jk, tk, jenc, tenc


def _assert_cache_as_reference(got, want):
    """KV-VQ indices and their bf16 scales bit-equal; fp leaves within
    1e-5 * max|leaf| (fp32 reassociation upstream of the write). The
    int8 cache quantizes those fp32 rows itself, so a value that lands
    on a rounding edge may round one step apart: int8 codes within one
    step, on at most 2 % of the entries, and bf16 scales within one bf16
    step (a row written to the wrong slot is off by far more)."""
    assert set(got) == set(want)
    int8 = got["k"].dtype == torch.int8
    for name, w in want.items():
        w, g = np.asarray(w), got[name]
        g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
        w = w.astype(np.float32) if w.dtype == jnp.bfloat16 else w
        if int8 and name in ("k", "v"):
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, (name, diff.max())
            assert np.count_nonzero(diff) <= 0.02 * diff.size, (
                name, np.count_nonzero(diff), diff.size)
        elif int8 and name.endswith("_s"):
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=0,
                                       err_msg=name)
        elif np.issubdtype(w.dtype, np.integer) or name.endswith("_s"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_attention_window_past_capacity_drops_as_reference(models, kv_bits):
    """One attention layer of the SMOKE config decodes a 3-token window
    at len = capacity - 2 (rows of a prefilled fp, int8 or KV-VQ cache):
    the reference writes with mode="drop", so the window's first two rows
    land in the last two slots and the third is dropped. From the same
    inputs the port leaves the same cache and the same output."""
    from repro.models import common as jcm
    from repro_torch.models import common as tcm

    jp, tp, jk, tk, jenc, tenc = _cache_kind(models, kv_bits)
    jpl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    tpl = tp["layers"][0]["attn"]
    jcfg, cfg = models["jm"].cfg, models["m"].cfg
    rng = np.random.default_rng(kv_bits)
    cap, S, Hk, hd = S_PROMPT + 2, 3, cfg.num_kv_heads, cfg.head_dim
    L = cfg.num_layers  # the codebook tree spans every layer
    fp = {"body": {
        "k": rng.standard_normal((L, B, S_PROMPT, Hk, hd)).astype(np.float32),
        "v": rng.standard_normal((L, B, S_PROMPT, Hk, hd)).astype(np.float32),
        "len": np.full((L, B), S_PROMPT, np.int32)}}
    jc = jax_pad_prefill_cache(
        jenc(jax.tree_util.tree_map(jnp.asarray, fp)), cap)
    tc = pad_prefill_cache(
        tenc(jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), fp)),
        cap)
    jc = {n: a[0] for n, a in jc["body"].items()}
    tc = {n: t[0] for n, t in tc["body"].items()}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_PROMPT, S_PROMPT + S, dtype=np.int32),
                          (B, S)).copy()
    jy, jc = jcm.attention_fwd(jpl, jnp.asarray(x),
                               jcm.RunConfig(mode="decode", remat=False,
                                             kv_vq=jk),
                               jcfg, positions=jnp.asarray(pos), cache=jc)
    with torch.no_grad():
        ty, tc2 = tcm.attention_fwd(tpl, torch.from_numpy(x),
                                    RunConfig(mode="decode", kv_vq=tk), cfg,
                                    positions=torch.from_numpy(pos), cache=tc)
    assert tc2 is tc  # written in place
    _assert_cache_as_reference(tc, jc)
    want = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert tc["len"].tolist() == [S_PROMPT + S] * B


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_decode_window_past_capacity_drops_as_reference(models, kv_bits):
    """The whole SMOKE model decodes a 3-token window at len = capacity
    - 2 over its own prefilled fp, int8 or KV-VQ cache: the same cache as
    the JAX model (as ``_assert_cache_as_reference`` holds it) and the
    same logits: within 1e-4 * max|logit|, and over the int8 cache within
    max|logit| / 127, the size of one int8 step (an int8 code one step
    apart moves its K or V entry by up to 1/127 of the row's max)."""
    jm, m, toks = models["jm"], models["m"], models["tokens"]
    jp, tp, jk, tk, jenc, tenc = _cache_kind(models, kv_bits)
    cap, S = S_PROMPT + 2, 3
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S_PROMPT])},
                       JaxRunConfig(remat=False, attn_chunk=8))
    with torch.no_grad():
        _, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S_PROMPT])},
                          RunConfig(attn_chunk=8))
    jc, tc = jax_pad_prefill_cache(jenc(jc), cap), pad_prefill_cache(tenc(tc), cap)
    window = toks[:, S_PROMPT:S_PROMPT + S]
    pos = np.broadcast_to(np.arange(S_PROMPT, S_PROMPT + S, dtype=np.int32),
                          (B, S)).copy()
    want, jc = jm.decode(jp, jnp.asarray(window), jnp.asarray(pos), jc,
                         JaxRunConfig(remat=False, kv_vq=jk))
    with torch.no_grad():
        got, tc = m.decode(tp, torch.from_numpy(window), torch.from_numpy(pos),
                           tc, RunConfig(kv_vq=tk))
    _assert_cache_as_reference(tc["body"], jc["body"])
    assert tc["body"]["len"].tolist() == [[S_PROMPT + S] * B] * 2
    _close(got.numpy(), want, rel=1 / 127 if kv_bits == 8 else 1e-4)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("g_dtype", ["bfloat16", "float32"])
def test_rmsnorm_forms_agree_and_match_reference(g_dtype, x_dtype):
    """rmsnorm's two forms (an fp32 gain: the product then a cast; a bf16
    gain, the serving dtype of a stacked gain: the product rounded as it
    is stored) give bit for bit the same values for the same gain, and
    the reference's: bitwise at bf16 activations, within 1e-6 relative
    at fp32 (XLA's and torch's mean and rsqrt differ in the last ulp)."""
    from repro.models import common as jcm
    from repro_torch.models import common as tcm

    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    tg = torch.from_numpy(g).to(getattr(torch, g_dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    got = tcm.rmsnorm({"g": tg}, tx)
    assert got.dtype == tx.dtype
    assert torch.equal(got, tcm.rmsnorm({"g": tg.float()}, tx))
    want = np.asarray(jcm.rmsnorm({"g": jnp.asarray(g).astype(g_dtype)},
                                  jnp.asarray(x).astype(x_dtype))
                      .astype(jnp.float32))
    if x_dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
