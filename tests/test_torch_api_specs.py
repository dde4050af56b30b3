"""Port of the model facade's dry-run and training surface
(``models/api.py``: ``SHAPES``, ``param_specs``, ``cache_specs``,
``input_specs``, ``supports_shape``, ``loss`` with ``_mask_pad_vocab``;
``models/common.cross_entropy_loss``), held against the JAX reference:

  * the specs trees: every leaf's shape and dtype equal to the
    reference's ``eval_shape`` tree (the port's tensors on the ``meta``
    device, its layer lists stacked as the reference stacks them), dense
    and quantized, for every config; the caches in every layout but
    int4, whose packed values are half as wide;
  * the loss within 1e-6 of the reference's on the same fp32 params and
    batch, with and without a loss mask, over a padded vocabulary;
  * no module of the port still defers to ROADMAP A7 or A8.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import _flatten_with_paths as jflatten
from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import vq as jvq
from repro.models import api as japi
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params, to_reference_layout
from repro_torch.core.vq import KVQuantConfig
from repro_torch.models import RunConfig, build_model
from repro_torch.models import api as tapi
from repro_torch.models.common import cross_entropy_loss

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCHS = sorted(ARCH_IDS)


def _layout(tree, stack=False):
    """path -> (shape, dtype name) of every leaf (the checkpoint grammar
    of both packages; ``stack``: the port's layer lists stacked first)."""
    if stack:
        return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for p, t in flatten_with_paths(to_reference_layout(tree))
                if not p.endswith("__vqmeta__")}
    return {p: (tuple(t.shape), str(t.dtype))
            for p, t in jflatten(tree) if not p.endswith("__vqmeta__")}


def test_shapes_equal_reference():
    assert tapi.SHAPES == japi.SHAPES


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, quantized):
    want = jax_build_model(jax_smoke_config(arch)).param_specs(
        quantized=quantized)
    got = build_model(get_smoke_config(arch)).param_specs(quantized=quantized)
    leaves = [t for _, t in flatten_with_paths(got)]
    assert leaves and all(t.is_meta for t in leaves
                          if isinstance(t, torch.Tensor))
    assert _layout(got, stack=True) == _layout(want)


@pytest.mark.parametrize("layout", ["fp", "int8", "kvq4", "kvq2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, layout):
    jm = jax_build_model(jax_smoke_config(arch))
    m = build_model(get_smoke_config(arch))
    kw, jkw = {}, {}
    if layout == "int8":
        kw = jkw = {"kv_int8": True}
    elif layout.startswith("kvq"):
        bits = int(layout[3:])
        kw = {"kvq": KVQuantConfig(kv_bits=bits)}
        jkw = {"kvq": jvq.KVQuantConfig(kv_bits=bits)}
    if layout == "int8" and m.cfg.use_mla:  # the port refuses, the ref
        with pytest.raises(ValueError, match="MLA"):  # keeps an fp latent
            m.cache_specs(3, 32, **kw)
        return
    want = jm.cache_specs(3, 32, **jkw)
    got = m.cache_specs(3, 32, **kw)
    assert _layout(got, stack=True) == _layout(want)


@pytest.mark.parametrize("arch", ["llama2_7b", "llama3_8b", "mixtral_8x22b"])
def test_int4_cache_specs_pack_two_values_a_byte(arch):
    want = _layout(jax_build_model(jax_smoke_config(arch)).cache_specs(
        2, 16, kv_int4=True))
    got = _layout(build_model(get_smoke_config(arch)).cache_specs(
        2, 16, kv_int4=True), stack=True)
    assert set(got) == set(want)
    for path, (shape, dt) in want.items():
        if dt == "int4":
            assert got[path] == (shape[:-1] + (shape[-1] // 2,), "int8")
        else:
            assert got[path] == (shape, dt), path


@pytest.mark.parametrize("shape", sorted(japi.SHAPES))
@pytest.mark.parametrize("arch", ["llama2_7b", "whisper_medium",
                                  "llama_3_2_vision_11b", "xlstm_125m",
                                  "mixtral_8x22b"])
def test_input_specs_and_supports_shape_equal_reference(arch, shape):
    jm = jax_build_model(jax_smoke_config(arch))
    m = build_model(get_smoke_config(arch))
    assert m.supports_shape(shape) == jm.supports_shape(shape)
    jkind, jspecs = jm.input_specs(shape, global_batch=2)
    kind, specs = m.input_specs(shape, global_batch=2)
    assert kind == jkind and set(specs) == set(jspecs)
    for name, w in jspecs.items():
        if name == "caches":
            assert _layout(specs[name], stack=True) == _layout(w)
        else:
            g = specs[name]
            assert g.is_meta and tuple(g.shape) == w.shape, name
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), name


def test_supports_shape_every_config():
    for arch in ARCHS:
        jm = jax_build_model(jax_smoke_config(arch))
        m = build_model(get_smoke_config(arch))
        for shape in japi.SHAPES:
            assert m.supports_shape(shape) == jm.supports_shape(shape), (
                arch, shape)


@pytest.fixture(scope="module")
def lm():
    """llama2 SMOKE at fp32 with a 500-token vocabulary (padded to 512)."""
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32",
                               vocab_size=500)
    jm = jax_build_model(jcfg)
    jp = jm.init(KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32",
                              vocab_size=500)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 500, (2, 12)).astype(np.int32)
    return {"jm": jm, "jp": jp, "m": build_model(cfg),
            "tp": from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu"),
            "tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "mask": (rng.random((2, 12)) > 0.3).astype(np.float32)}


@pytest.mark.parametrize("masked", [False, True])
def test_loss_equals_reference(lm, masked):
    batch = {"tokens": lm["tokens"], "labels": lm["labels"]}
    if masked:
        batch["loss_mask"] = lm["mask"]
    want = float(lm["jm"].loss(
        lm["jp"], {k: jnp.asarray(v) for k, v in batch.items()},
        jcm.RunConfig(remat=False, attn_chunk=8)))
    with torch.no_grad():
        got = lm["m"].loss(lm["tp"], {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                           RunConfig(attn_chunk=8)).item()
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


def test_cross_entropy_loss_equals_reference():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.5).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = float(jcm.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m)))
        got = cross_entropy_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 None if m is None else torch.from_numpy(m))
        assert abs(got.item() - want) <= 1e-6 * max(1.0, abs(want))


def test_mask_pad_vocab_equals_reference(lm):
    x = np.random.default_rng(1).standard_normal((2, 3, 512)).astype(
        np.float32)
    np.testing.assert_array_equal(
        lm["m"]._mask_pad_vocab(torch.from_numpy(x)).numpy(),
        np.asarray(lm["jm"]._mask_pad_vocab(jnp.asarray(x))))


def test_no_module_defers_to_a7_or_a8():
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for path in root.rglob("*.py"):
        text = path.read_text()
        for item in ("ROADMAP A7", "ROADMAP A8"):
            assert item not in text, (path, item)
