"""The port's other dense configs, held against the JAX reference on the
CPU: llama3-8b (GQA g=2 at smoke, rope theta 5e5), qwen3-0.6b (qk_norm,
q_dim != d_model, theta 1e6), minitron-4b, qwen2-72b (qkv_bias, three
layers), a g=3 variant of minitron's smoke config (6 query heads over
2 kv heads) and a variant of qwen2's with head_dim 32 (its kv width
reaches the quantizer's 64, so wq|wk|wv group with their biases), built
identically in both packages.

  * every ported CONFIG / SMOKE equals the reference's field for field;
    the registry follows the reference's order, unported families raise;
  * rope frequencies at the configs' thetas equal the reference's;
  * with the same numpy params (``convert.from_jax_params``; the qkv
    biases drawn at random so the grouped bias matters): prefill and
    decode logits within 1e-4 * max|logit| (fp32 reassociation through
    the layers), dense and 2-bit VQ; the port's own grouping keeps the
    reference's concatenated bias;
  * greedy ``Engine`` streams IDENTICAL to the JAX engine's at fp32, with
    the fp cache and with kv_bits=4, the synthetic quantization's salt
    pinned as in tests/test_torch_kvvq.py;
  * ``count_vq_layers`` / ``compressed_model_bytes`` / ``param_count``.
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
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.models.api import param_count as jax_param_count
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro.serve.kvcache import pad_prefill_cache as jax_pad_prefill_cache
from repro_torch import configs as tconfigs
from repro_torch.convert import from_jax_params
from repro_torch.core import quantize as tq
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as tcm
from repro_torch.models.api import param_count, param_tensors
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve.kvcache import pad_prefill_cache

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
NEW = ["llama3_8b", "qwen3_0_6b", "minitron_4b", "qwen2_72b"]
ARCHS = NEW + ["minitron_g3", "qwen2_grouped"]
B, S_PROMPT, N_GEN, CAP = 2, 12, 3, 32


def _stable_hash(s: str) -> int:
    """A process-independent stand-in for ``hash`` of a string."""
    return zlib.crc32(s.encode())


def _smoke(mod, arch):
    """``arch``'s smoke config at fp32 from ``mod`` (either registry);
    minitron_g3: minitron's with 6 query heads over 2 kv heads;
    qwen2_grouped: qwen2's with head_dim 32."""
    if arch == "minitron_g3":
        cfg = dataclasses.replace(mod.get_smoke_config("minitron_4b"),
                                  num_heads=6, num_kv_heads=2)
    elif arch == "qwen2_grouped":
        cfg = dataclasses.replace(mod.get_smoke_config("qwen2_72b"),
                                  head_dim=32)
    else:
        cfg = mod.get_smoke_config(arch)
    return dataclasses.replace(cfg, dtype="float32")


def _conv(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _random_biases(tree, seed):
    """The dense tree with every bias leaf drawn from numpy (the
    initializer's are zeros, which would hide a lost or misplaced bias)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape)
                                    .astype(np.float32) * 0.5)
                        if k == "b" else walk(v)) for k, v in node.items()}
        return node

    return walk(tree)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = _smoke(jconfigs, arch)
    jm = jax_build_model(jcfg)
    dense = _random_biases(jm.init(KEY), 1)
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(dense, method="synthetic", key=KEY)
    cfg = _smoke(tconfigs, arch)
    tokens = np.array(jax.random.randint(KEY, (B, S_PROMPT + N_GEN), 0,
                                         jcfg.vocab_size), np.int32)
    return {"jm": jm, "jcfg": jcfg, "m": build_model(cfg), "cfg": cfg,
            "tokens": tokens,
            "params": {"dense": (dense, _conv(dense)), "vq": (vq, _conv(vq))}}


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


# ----------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", NEW)
def test_config_and_smoke_equal_reference(arch):
    for name in ("get_config", "get_smoke_config"):
        mine = getattr(tconfigs, name)(arch)
        want = getattr(jconfigs, name)(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(want), name
    # dashed ids resolve as in the reference
    assert tconfigs.get_config(arch.replace("_", "-")) == \
        tconfigs.get_config(arch)


def test_registry_order_and_unported_families():
    """Every configuration of the reference, in its order, field for
    field; an unknown architecture raises."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(tconfigs.ARCH_IDS) == set(NEW) | {
        "llama2_7b", "mixtral_8x22b", "deepseek_v2_lite_16b", "xlstm_125m",
        "recurrentgemma_2b", "whisper_medium", "llama_3_2_vision_11b"}
    assert {a: dataclasses.asdict(c)
            for a, c in tconfigs.all_configs().items()} == \
        {a: dataclasses.asdict(jconfigs.get_config(a))
         for a in tconfigs.ARCH_IDS}
    for get in (tconfigs.get_config, tconfigs.get_smoke_config):
        with pytest.raises(ValueError, match="unknown architecture"):
            get("llama-3.2-vision-90b")


@pytest.mark.parametrize("theta", [10000.0, 500000.0, 1000000.0])
@pytest.mark.parametrize("hd", [16, 32, 128])
def test_rope_matches_reference_at_large_theta(theta, hd):
    np.testing.assert_array_equal(tcm.rope_freqs(hd, theta, "cpu").numpy(),
                                  np.asarray(jcm.rope_freqs(hd, theta)))
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    want = np.asarray(jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tcm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         theta).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("kind", ["dense", "vq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, kind):
    """Prefill, pad the cache, then N_GEN decode steps on both sides."""
    s = _setup(arch)
    jp, tp = s["params"][kind]
    jm, m, toks = s["jm"], s["m"], s["tokens"]
    jrc = jcm.RunConfig(remat=False, attn_chunk=8)
    want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S_PROMPT])}, jrc)
    with torch.no_grad():
        got, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S_PROMPT])},
                            RunConfig(attn_chunk=8))
    _close(got.numpy(), want)
    cfg = s["cfg"]
    assert tc["body"]["k"].shape == (cfg.num_layers, B, S_PROMPT,
                                     cfg.num_kv_heads, cfg.head_dim)
    jc, tc = jax_pad_prefill_cache(jc, CAP), pad_prefill_cache(tc, CAP)
    with torch.no_grad():
        for i in range(N_GEN):
            pos = S_PROMPT + i
            want, jc = jm.decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                                 jnp.full((B, 1), pos, jnp.int32), jc,
                                 jcm.RunConfig(remat=False))
            got, tc = m.decode(tp, torch.from_numpy(toks[:, pos:pos + 1]),
                               torch.full((B, 1), pos, dtype=torch.int32), tc,
                               RunConfig())
            _close(got.numpy(), want)


@pytest.mark.parametrize("arch", ["qwen2_72b", "qwen2_grouped", "qwen3_0_6b",
                                  "minitron_g3"])
def test_port_quantize_groups_as_reference(arch):
    """The port's own pass on the same dense params: the same keys,
    grouped splits, dense leaves and (concatenated) biases as the
    reference's; only the synthetic indices and codebooks differ
    (another generator)."""
    s = _setup(arch)
    cfg = s["cfg"]
    mine = tq.quantize_params(s["params"]["dense"][1], cfg,
                              method="synthetic",
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    want = s["params"]["vq"][1]
    for lm, lw in zip(mine["layers"], want["layers"]):
        assert set(lm["mlp"]) == set(lw["mlp"]) == {"gu", "down"}
        assert set(lm["attn"]) == set(lw["attn"])
        for name in lw["attn"]:
            nm, nw = lm["attn"][name], lw["attn"][name]
            assert set(nm) == set(nw), name
            if "vq" in nw:
                vm, vw = nm["vq"], nw["vq"]
                assert (vm.K, vm.N, vm.splits) == (vw.K, vw.N, vw.splits)
                assert vm.idx.shape == vw.idx.shape
            for leaf in ("b", "w", "g"):
                if leaf in nw:
                    torch.testing.assert_close(nm[leaf], nw[leaf], rtol=0,
                                               atol=0)
    attn = want["layers"][0]["attn"]
    grouped = "wqkv" in attn
    assert grouped == (cfg.kv_dim >= 64)
    if grouped:
        assert attn["wqkv"]["vq"].splits == (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)
    if cfg.qkv_bias:
        b = attn["wqkv"]["b"] if grouped else attn["wq"]["b"]
        assert b.abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_match_reference(arch):
    s = _setup(arch)
    jvq, tvq_ = s["params"]["vq"]
    L = s["cfg"].num_layers
    # the reference counts one stacked node per site, the port one a layer
    assert tq.count_vq_layers(tvq_) == L * jq.count_vq_layers(jvq)
    for kind in ("dense", "vq"):
        jt, tt = s["params"][kind]
        assert param_count(tt) == jax_param_count(jt)
    # bytes: index bytes + fp32 codebooks + fp32 scales per layer and site,
    # against 2 bytes a dense weight
    vq_b, dense_b = tq.compressed_model_bytes(tvq_)
    want_vq = want_dense = 0
    for layer in tvq_["layers"]:
        for node in (*layer["attn"].values(), *layer["mlp"].values()):
            if isinstance(node, dict) and "vq" in node:
                v = node["vq"]
                want_vq += v.idx.numel() + v.codebooks.numel() * 4 + v.N * 4
                want_dense += v.K * v.N * 2
    assert (vq_b, dense_b) == (want_vq, want_dense)
    if L == 2:  # the reference's stacked count reads C off the layer axis
        assert (vq_b, dense_b) == jq.compressed_model_bytes(jvq)


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("kv_bits", [16, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_identical_to_jax_engine(arch, kv_bits):
    """More requests than slots, two prefill buckets; the port under
    impl="cuda" (its wrappers' plain versions on the CPU) against the
    reference's jnp engine."""
    s = _setup(arch)
    rng = np.random.default_rng(kv_bits)
    prompts = [rng.integers(0, s["cfg"].vocab_size, n).astype(np.int32)
               for n in (5, 9, 7, 4, 6)]
    jrc = jcm.RunConfig(mode="decode", remat=False, attn_chunk=16)
    want = JaxEngine(s["jm"], s["params"]["vq"][0], jrc,
                     JaxEngineConfig(num_slots=2, max_len=32,
                                     kv_bits=kv_bits)).generate(prompts, 6)
    eng = Engine(s["m"], s["params"]["vq"][1], RunConfig(attn_chunk=16),
                 EngineConfig(num_slots=2, max_len=32, kv_bits=kv_bits),
                 device="cpu")
    assert eng.generate(prompts, 6) == want


@pytest.mark.parametrize("arch", ["qwen2_grouped", "qwen3_0_6b", "minitron_g3"])
def test_meta_block_init_quantizes(arch):
    """``init(block_device="meta")`` + synthetic quantization, the full-
    width route (smoke configs whose block linears all reach the
    quantizer's 64): every block linear becomes a VQ node of the
    reference's shape, the qkv biases are real zeros on the device."""
    s = _setup(arch)
    cfg = s["cfg"]
    gen = torch.Generator().manual_seed(0)
    params = s["m"].quantize(s["m"].init(gen, device="cpu",
                                         block_device="meta"),
                             method="synthetic", generator=gen, device="cpu")
    want = s["params"]["vq"][1]
    assert tq.count_vq_layers(params) == tq.count_vq_layers(want)
    for lm, lw in zip(params["layers"], want["layers"]):
        for part in ("attn", "mlp"):
            assert set(lm[part]) == set(lw[part])
            for name, node in lw[part].items():
                if "vq" in node:
                    assert lm[part][name]["vq"].idx.shape == node["vq"].idx.shape
                if "b" in node:
                    b = lm[part][name]["b"]
                    assert not b.is_meta and not b.any()
    assert not any(t.is_meta for t in param_tensors(params))
