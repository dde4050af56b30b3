"""The port's sharding rules (``repro_torch/runtime/sharding.py``) against
the reference's (``repro/runtime/sharding.py``) on the production meshes,
given as axis sizes to the port and as an ``AbstractMesh`` to the
reference (no devices): for every arch at full width, dense and
quantized, ``param_pspecs`` and ``opt_pspecs`` (ZeRO-1) of the port's
meta-device params, in the stacked layout, equal the reference's on its
``eval_shape`` params, spec for spec (a VQWeight's metadata included);
``cache_pspecs`` of the decode caches (128 x 32768, and one long-context
slot) and of a paged cache, and ``batch_pspecs`` of the train, prefill
and decode inputs, too. Then the port's own surface: the ZeRO-1 owners
of a per-layer list, ``to_placements`` and ``train_shardings``."""
import types

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.runtime import sharding as jshd
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import sharding as tshd

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _abstract(axes):
    """The reference's mesh, as ``tests/test_distributed.py`` builds it
    across jax API revisions."""
    try:
        return AbstractMesh(tuple(axes.items()))
    except TypeError:
        return AbstractMesh(tuple(axes.values()), tuple(axes))


def _flat(tree, prefix=""):
    """path -> spec (a tuple) of a spec tree of either package."""
    out = {}
    if isinstance(tree, PartitionSpec):
        out[prefix] = tuple(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
    elif all(hasattr(tree, f) for f in ("idx", "codebooks", "scale", "K")):
        for f in ("idx", "codebooks", "scale"):
            out.update(_flat(getattr(tree, f), f"{prefix}/{f}"))
        out[f"{prefix}/meta"] = (tree.K, tree.N, tree.d, tree.n,
                                 tuple(tree.splits))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}/{f}"))
    else:
        out[prefix] = tree
    return out


def _equal(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))[:10]
    bad = {k: (g[k], w[k]) for k in g if g[k] != w[k]}
    assert not bad, list(bad.items())[:5]
    return len(g)


def test_production_meshes():
    assert make_production_mesh() == MESHES["single"]
    assert make_production_mesh(multi_pod=True) == MESHES["multi"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_reference(arch, quantized, mesh):
    axes = MESHES[mesh]
    jm = jbuild_model(jget_config(arch))
    jparams = jm.param_specs(quantized=quantized)
    want = jshd.param_pspecs(jparams, _abstract(axes))
    tparams = build_model(get_config(arch)).param_specs(quantized=quantized)
    got = tshd.param_pspecs(tparams, axes)
    assert _equal(got, want) > 5
    _equal(tshd.opt_pspecs(got, tparams, axes),
           jshd.opt_pspecs(want, jparams, _abstract(axes)))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_reference(arch, mesh):
    axes = MESHES[mesh]
    jm, tm = jbuild_model(jget_config(arch)), build_model(get_config(arch))
    for batch, seq in ((128, 32768), (1, 4096)):
        _equal(tshd.cache_pspecs(tm.cache_specs(batch, seq), axes),
               jshd.cache_pspecs(jm.cache_specs(batch, seq), _abstract(axes)))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        _, tin = tm.input_specs(shape)
        _, jin = jm.input_specs(shape)
        tin.pop("caches", None), jin.pop("caches", None)
        _equal(tshd.batch_pspecs(tin, axes),
               jshd.batch_pspecs(jin, _abstract(axes)))
    # a batch the DP axes do not divide, and a 0-d input
    odd = {"x": torch.empty((24, 3), device="meta"),
           "s": torch.empty((), device="meta")}
    _equal(tshd.batch_pspecs(odd, axes), jshd.batch_pspecs(
        {"x": jax.ShapeDtypeStruct((24, 3), np.float32),
         "s": jax.ShapeDtypeStruct((), np.float32)}, _abstract(axes)))


@pytest.mark.parametrize("arch", ["llama3_8b", "deepseek_v2_lite_16b"])
def test_paged_cache_specs_equal_reference(arch):
    """A paged node's arenas and block table replicated, its ``len`` on
    the batch rule (the port's arenas carry one sink block more, which
    no spec sees)."""
    axes = MESHES["multi"]
    want = jshd.cache_pspecs(jsteps.serve_cache_specs(
        jbuild_model(jget_config(arch)), 32, 4096, paged=True),
        _abstract(axes))
    got = tshd.cache_pspecs(tsteps.serve_cache_specs(
        build_model(get_config(arch)), 32, 4096, paged=True), axes)
    _equal(got, want)


def test_zero1_owners_blocks_of_layers():
    """Layer i of a segment belongs to data rank i // (L / |data|) where
    the stacked spec shards L over data; leaves of fewer stacked dims
    (norm gains, the embedding) and a non-dividing L are replicated."""
    cfg = get_smoke_config("qwen3_0_6b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="meta")
    L = len(params["layers"])
    for data in (1, L, L + 1):
        own = tshd.zero1_owners(params, {"data": data, "model": 1})
        assert own["embedding"]["emb"] is None
        for i, lp in enumerate(own["layers"]):
            assert lp["attn_norm"]["g"] is None
            want = i // (L // data) if L % data == 0 else None
            assert lp["attn"]["wq"]["w"] == want
            assert lp["mlp"]["down"]["w"] == want


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tshd.to_placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert tshd.to_placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="shards two dims"):
        tshd.to_placements(("data", "data"), mesh)


def test_train_shardings_equal_reference():
    axes = MESHES["multi"]
    jm = jbuild_model(jget_config("qwen3_0_6b"))
    jp = jm.param_specs()
    from repro.optim import AdamWConfig as JAdamWConfig, adamw_init as jinit

    jopt = jax.eval_shape(lambda p: jinit(p, JAdamWConfig()), jp)
    _, jin = jm.input_specs("train_4k")
    want = jsteps.train_shardings(jm, _abstract(axes), jp, jopt, jin)
    tm = build_model(get_config("qwen3_0_6b"))
    tp = tm.param_specs()
    topt = adamw_init(tp, AdamWConfig())
    _, tin = tm.input_specs("train_4k")
    got = tsteps.train_shardings(tm, axes, tp, topt, tin)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _equal(g, w)
