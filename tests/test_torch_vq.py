"""Port of the VQ weight core and the quantization pass, held against the
JAX reference: converted VQWeights dequantize to the reference's W_hat
(fp32, atol=1e-6: both sides gather the same centroids and add them in
the same order), and ``quantize_params`` groups the same families with
the same splits."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import ops as jax_ops
from repro.core import vq as jax_vq
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import ops
from repro_torch.core.vq import (VQWeight, dequantize, split_grouped,
                                 synthetic_vq)
from repro_torch.models import build_model

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("K,N,C,splits", [
    (64, 96, 1, ()), (128, 384, 2, (128, 128, 128)), (96, 80, 4, ()),
    (256, 192, 2, (64, 128)),
])
def test_dequantize_matches_jax(K, N, C, splits):
    jvq = jax_vq.synthetic_vq(KEY, K, N, C=C, splits=splits)
    jvq = dataclasses.replace(
        jvq, scale=jax.random.uniform(KEY, (N,), minval=0.5, maxval=1.5))
    vq = from_jax_params(_np_tree(jvq), device="cpu")
    assert (vq.K, vq.N, vq.C, vq.V, vq.splits) == (K, N, C, K // 8, splits)
    np.testing.assert_allclose(dequantize(vq).numpy(),
                               np.asarray(jax_vq.dequantize(jvq)), rtol=0,
                               atol=1e-6)
    x = np.random.default_rng(0).standard_normal((3, K)).astype(np.float32)
    np.testing.assert_allclose(
        ops.dequant_matmul(torch.from_numpy(x), vq).numpy(),
        np.asarray(jax_ops.dequant_matmul(jnp.asarray(x), jvq)),
        rtol=1e-5, atol=1e-5)
    for a, b in zip(split_grouped(vq), jax_vq.split_grouped(jvq)):
        assert (a.N, a.splits) == (b.N, b.splits)
        np.testing.assert_array_equal(a.idx.numpy(), np.asarray(b.idx))
        np.testing.assert_allclose(dequantize(a).numpy(),
                                   np.asarray(jax_vq.dequantize(b)), atol=1e-6)


def test_split_grouped_outputs_and_costs():
    vq = synthetic_vq(torch.Generator().manual_seed(0), 64, 96,
                      splits=(32, 64), device="cpu")
    y = torch.arange(2 * 96, dtype=torch.float32).reshape(2, 96)
    a, b = ops.split_grouped_outputs(y, vq)
    assert a.shape == (2, 32) and b.shape == (2, 64)
    assert torch.equal(torch.cat([a, b], dim=-1), y)
    assert ops.vq_gemm_macs(4, 4096, 8, 2, 8) == jax_ops.vq_gemm_macs(4, 4096, 8, 2, 8)
    assert ops.epilogue_adds(4, 4096, 12288, 2, 8) == \
        jax_ops.epilogue_adds(4, 4096, 12288, 2, 8)


def test_synthetic_vq_is_seeded_and_valid():
    mk = lambda s: synthetic_vq(torch.Generator().manual_seed(s), 128, 40,
                                C=2, device="cpu")
    a, b, c = mk(1), mk(1), mk(2)
    assert a.idx.dtype == torch.uint8 and a.idx.shape == (2, 16, 40)
    assert a.codebooks.shape == (2, 8, 256) and a.codebooks.dtype == torch.float32
    assert torch.equal(a.idx, b.idx) and torch.equal(a.codebooks, b.codebooks)
    assert not torch.equal(a.idx, c.idx)
    assert torch.equal(a.scale, torch.ones(40))
    with pytest.raises(ValueError):
        synthetic_vq(torch.Generator(), 128, 40, splits=(10, 10), device="cpu")


def _vq_layout(node, path=()):
    """{path: (K, N, splits, idx shape)} of every VQ leaf, per layer."""
    out = {}
    if isinstance(node, (VQWeight, jax_vq.VQWeight)):
        out[path] = (node.K, node.N, tuple(node.splits),
                     tuple(node.idx.shape[-3:]))
    elif isinstance(node, dict):
        for k, v in node.items():
            out.update(_vq_layout(v, path + (k,)))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            out.update(_vq_layout(v, path + (i,)))
    return out


def test_quantize_params_groups_like_jax():
    jcfg = jax_smoke_config("llama2_7b")
    jparams = jax_build_model(jcfg).quantize(
        jax_build_model(jcfg).init(KEY), method="synthetic", key=KEY)
    cfg = get_smoke_config("llama2_7b")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    qp = model.quantize(model.init(gen, device="cpu"), method="synthetic",
                        generator=gen, device="cpu")
    # the reference stacks layers; the port lists them
    jlayers = {path[1:]: v for path, v in _vq_layout(jparams).items()}
    for i in range(cfg.num_layers):
        mine = {p[2:]: v for p, v in _vq_layout(qp).items() if p[1] == i}
        assert mine == jlayers
    assert set(qp["layers"][0]["attn"]) == set(jparams["layers"]["attn"])
    assert qp["layers"][0]["attn"]["wqkv"]["vq"].splits == (128, 128, 128)
    assert qp["layers"][0]["mlp"]["gu"]["vq"].splits == (384, 384)
    for name in ("embedding", "lm_head"):
        leaf = next(iter(qp[name].values()))
        jleaf = next(iter(jparams[name].values()))
        assert str(leaf.dtype).endswith(str(jleaf.dtype))


def test_quantize_builds_from_meta_block_weights():
    """A full model quantizes from shapes alone: block weights on the
    meta device never hold values; a dense leaf that must be kept does."""
    cfg = get_smoke_config("llama2_7b")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cpu", block_device="meta")
    assert params["layers"][0]["mlp"]["down"]["w"].is_meta
    qp = model.quantize(params, method="synthetic", generator=gen,
                        device="cpu")
    vq = qp["layers"][1]["mlp"]["down"]["vq"]
    assert vq.idx.device.type == "cpu" and (vq.K, vq.N) == (384, 128)
    with pytest.raises(ValueError, match="meta device"):  # fit needs values
        model.quantize(params, method="fit", device="cpu")
    params["final_norm"]["g"] = torch.empty(cfg.d_model, device="meta")
    with pytest.raises(ValueError, match="meta"):
        model.quantize(params, method="synthetic", generator=gen,
                       device="cpu")


def test_from_jax_params_unstacks_layers():
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    jparams = jm.quantize(jm.init(KEY), method="synthetic", key=KEY)
    qp = from_jax_params(_np_tree(jparams), device="cpu")
    assert isinstance(qp["layers"], list) and len(qp["layers"]) == 2
    jl = jparams["layers"]
    for i, lp in enumerate(qp["layers"]):
        np.testing.assert_array_equal(lp["attn"]["wqkv"]["vq"].idx.numpy(),
                                      np.asarray(jl["attn"]["wqkv"]["vq"].idx[i]))
        np.testing.assert_array_equal(lp["mlp_norm"]["g"].numpy(),
                                      np.asarray(jl["mlp_norm"]["g"][i]))
    assert qp["embedding"]["emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        qp["embedding"]["emb"].float().numpy(),
        np.asarray(jparams["embedding"]["emb"].astype(jnp.float32)))
