"""The port's MoE layer (``repro_torch/models/common.py`` ``moe_fwd``,
``moe_route``, ``_expert_ffn``) held against the JAX reference's
(``repro/models/common.py:961-1099``) on the CPU at fp32, on layer 0 of
mixtral's SMOKE config (4 experts, top-2) with the reference's params
converted (the synthetic quantization's salt pinned):

  * routing bit-equal: the top-k expert ids (equal gates: the lower id
    first, as ``lax.top_k``), the keep mask and each choice's position in
    its expert's buffer, computed from the same fp32 router logits;
  * ``moe_fwd`` within 1e-5 x max|y| (fp32 reassociation: the dispatch and
    combine are exact, the experts' matmuls are not) on the one-hot
    einsum route (T = 4, decode) and the scatter route (T = 1024, above
    the reference's 2^22 switch), dense and 2-bit VQ, gate|up grouped
    into ``gu`` and not; with all gates equal; with a capacity too small
    for the traffic (choices dropped); with two shared experts;
  * the expert layout: ``convert`` carries the (L, E, ...) expert leaves
    and the router both ways bit for bit, and ``CheckpointManager``
    writes the reference's files for a mixtral SMOKE tree and restores
    the reference's bit for bit;
  * the port's own quantization and counts: experts stacked on E,
    ``gu`` grouped per expert, the router dense; ``count_vq_layers``,
    ``compressed_model_bytes`` and ``param_count`` count every expert.
"""
import dataclasses
import functools
import os
import zipfile
import zlib
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
from repro.models.api import param_count as jax_param_count
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import from_jax_params, to_reference_layout
from repro_torch.core import quantize as tq
from repro_torch.core.vq import VQWeight, vq_index
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as tcm
from repro_torch.models.api import param_count

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCH = "mixtral_8x22b"


def _stable_hash(s: str) -> int:
    """A process-independent stand-in for ``hash`` of a string."""
    return zlib.crc32(s.encode())


def _cfg(mod, **kw):
    return dataclasses.replace(mod.get_smoke_config(ARCH), dtype="float32",
                               **kw)


def _conv(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(shared: int = 0):
    """The reference's SMOKE params (``shared`` shared experts): dense, VQ
    with gate|up grouped, VQ ungrouped; each with its conversion."""
    jcfg = _cfg(jconfigs, num_shared_experts=shared)
    jm = jax_build_model(jcfg)
    dense = jm.init(KEY)
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(dense, method="synthetic", key=KEY)
        flat = jq.quantize_params(dense, jcfg, method="synthetic", key=KEY,
                                  group_projections=False)
    trees = {"dense": dense, "vq": vq, "vq_ungrouped": flat}
    return {"jcfg": jcfg, "cfg": _cfg(tconfigs, num_shared_experts=shared),
            "jm": jm, "params": {k: (t, _conv(t)) for k, t in trees.items()}}


def _layer0(s, kind):
    """Layer 0's MoE params in both packages."""
    jp, tp = s["params"][kind]
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"]),
            tp["layers"][0]["moe"])


def _x(T, D, seed):
    return np.random.default_rng(seed).standard_normal((1, T, D)).astype(
        np.float32)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)


def _reference_route(logits, jcfg):
    """The reference's routing lines (``models/common.py:1053-1066``) on
    the same fp32 logits: topi, keep and the positions."""
    T, E, k = logits.shape[0], jcfg.num_experts, jcfg.top_k
    gates = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    topv, topi = jax.lax.top_k(gates, k)
    cap = min(max(1, int(np.ceil(T * k / E * jcfg.capacity_factor))), T)
    flat = jax.nn.one_hot(topi, E, dtype=jnp.float32).reshape(T * k, E)
    pos = jnp.einsum("se,se->s", jnp.cumsum(flat, axis=0) - flat,
                     flat).astype(jnp.int32)
    return (np.asarray(topi), np.asarray(pos < cap), np.asarray(pos),
            np.asarray(topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)))


def _run_both(s, jmoe, tmoe, x, mode, jcfg=None, cfg=None):
    jcfg, cfg = jcfg or s["jcfg"], cfg or s["cfg"]
    want = jcm.moe_fwd(jmoe, jnp.asarray(x),
                       jcm.RunConfig(mode=mode, remat=False), jcfg)
    with torch.no_grad():
        got = tcm.moe_fwd(tmoe, torch.from_numpy(x), RunConfig(mode=mode),
                          cfg)
    return got.numpy(), np.asarray(want)


# ----------------------------------------------------------------- routing


@pytest.mark.parametrize("T", [1, 4, 64, 1024])
def test_routing_bit_equal_to_reference(T):
    s = _setup()
    jmoe, tmoe = _layer0(s, "vq")
    x = _x(T, s["cfg"].d_model, T)[0]
    logits = x @ np.asarray(jmoe["router"]["wr"])
    topi, topv, pos, keep, cap = tcm.moe_route(torch.from_numpy(logits),
                                               s["cfg"])
    want_i, want_keep, want_pos, want_v = _reference_route(logits, s["jcfg"])
    np.testing.assert_array_equal(topi.numpy(), want_i)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_allclose(topv.numpy(), want_v, rtol=1e-6, atol=0)
    assert cap == tcm.moe_capacity(s["cfg"], T)


@pytest.mark.parametrize("T", [4, 9])
def test_equal_gates_take_the_lower_experts_first(T):
    """A zero router: every gate equal. ``lax.top_k`` keeps the lower
    ids first, so every token picks experts 0 and 1 (equal weights)
    and the later tokens overflow their capacity; the port's stable
    sort does the same, and the layer's output matches."""
    s = _setup()
    jmoe, tmoe = _layer0(s, "vq")
    jmoe = {**jmoe, "router": {"wr": jnp.zeros_like(jmoe["router"]["wr"])}}
    tmoe = {**tmoe, "router": {"wr": torch.zeros_like(tmoe["router"]["wr"])}}
    logits = np.zeros((T, s["cfg"].num_experts), np.float32)
    topi, topv, pos, keep, cap = tcm.moe_route(torch.from_numpy(logits),
                                               s["cfg"])
    assert (topi.numpy() == [0, 1]).all()
    assert (topv.numpy() == 0.5).all()
    want_i, want_keep, want_pos, _ = _reference_route(logits, s["jcfg"])
    np.testing.assert_array_equal(topi.numpy(), want_i)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    assert not keep.all()
    got, want = _run_both(s, jmoe, tmoe, _x(T, s["cfg"].d_model, 3), "decode")
    _close(got, want)


# ------------------------------------------------------------------ moe_fwd


@pytest.mark.parametrize("kind", ["dense", "vq", "vq_ungrouped"])
@pytest.mark.parametrize("T,mode", [(4, "decode"), (1024, "prefill")],
                         ids=["einsum", "scatter"])
def test_moe_fwd_matches_reference(T, mode, kind):
    s = _setup()
    E, k = s["cfg"].num_experts, s["cfg"].top_k
    cap = tcm.moe_capacity(s["cfg"], T)
    assert (T * k * E * cap <= 1 << 22) == (mode == "decode")
    jmoe, tmoe = _layer0(s, kind)
    assert ("gu" in tmoe["experts"]) == (kind == "vq")
    got, want = _run_both(s, jmoe, tmoe, _x(T, s["cfg"].d_model, T), mode)
    assert got.shape == want.shape == (1, T, s["cfg"].d_model)
    _close(got, want)


@pytest.mark.parametrize("T,mode", [(16, "decode"), (1024, "prefill")],
                         ids=["einsum", "scatter"])
def test_capacity_overflow_drops_as_reference(T, mode):
    """capacity_factor 0.25: each expert's buffer holds an eighth of the
    choices, so most are dropped (weight 0), on both routes."""
    s = _setup()
    jcfg = dataclasses.replace(s["jcfg"], capacity_factor=0.25)
    cfg = dataclasses.replace(s["cfg"], capacity_factor=0.25)
    jmoe, tmoe = _layer0(s, "vq")
    x = _x(T, cfg.d_model, T + 1)
    _, _, _, keep, _ = tcm.moe_route(
        torch.from_numpy(x[0] @ np.asarray(jmoe["router"]["wr"])), cfg)
    assert keep.float().mean() < 0.5
    got, want = _run_both(s, jmoe, tmoe, x, mode, jcfg, cfg)
    _close(got, want)


@pytest.mark.parametrize("kind", ["dense", "vq"])
@pytest.mark.parametrize("T,mode", [(4, "decode"), (1024, "prefill")],
                         ids=["einsum", "scatter"])
def test_shared_experts_match_reference(T, mode, kind):
    s = _setup(shared=2)
    jmoe, tmoe = _layer0(s, kind)
    assert "shared" in tmoe
    if kind == "vq":
        assert tmoe["shared"]["gu"]["vq"].N == 2 * 2 * s["cfg"].moe_d_ff
    got, want = _run_both(s, jmoe, tmoe, _x(T, s["cfg"].d_model, 5), mode)
    _close(got, want)


@pytest.mark.parametrize("T", [4, 64])
def test_expert_ffn_runs_every_expert_at_its_capacity(T, monkeypatch):
    """Every expert's linears run once a layer over its cap rows, empty
    ones included, each on a 2-D VQWeight whose indices are a contiguous
    view of the stack (the kernels' layout)."""
    s = _setup()
    _, tmoe = _layer0(s, "vq")
    seen = []
    real = tcm.linear

    def spy(p, x, rc, **kw):
        if "vq" in p:
            seen.append((x.shape[0], p["vq"].idx.dim(),
                         p["vq"].idx.is_contiguous(), p["vq"].N))
        return real(p, x, rc, **kw)

    monkeypatch.setattr(tcm, "linear", spy)
    with torch.no_grad():
        tcm.moe_fwd(tmoe, torch.from_numpy(_x(T, s["cfg"].d_model, 0)),
                    RunConfig(mode="decode"), s["cfg"])
    cap, E, dff = tcm.moe_capacity(s["cfg"], T), s["cfg"].num_experts, 256
    assert seen == [(cap, 3, True, 2 * dff), (cap, 3, True, 128)] * E


# ------------------------------------------------------- layout and files


def _leaves(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
    elif isinstance(tree, VQWeight) or hasattr(tree, "codebooks"):
        for f in ("idx", "codebooks", "scale"):
            out[f"{prefix}/{f}"] = np.asarray(getattr(tree, f))
        out[f"{prefix}/meta"] = (tree.K, tree.N, tree.d, tree.n,
                                 tuple(tree.splits))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = (tree.view(torch.int16).numpy()
                       if tree.dtype == torch.bfloat16 else tree.numpy())
    else:
        a = np.asarray(tree)
        out[prefix] = a.view(np.int16) if a.dtype.name == "bfloat16" else a
    return out


def _assert_same(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k, b in w.items():
        a = g[k]
        if isinstance(b, tuple):
            assert a == b, k
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("kind", ["dense", "vq", "vq_ungrouped"])
def test_convert_carries_experts_both_ways(kind):
    s = _setup()
    jp, tp = s["params"][kind]
    layer = tp["layers"][0]["moe"]
    E, D = s["cfg"].num_experts, s["cfg"].d_model
    assert tuple(layer["router"]["wr"].shape) == (D, E)
    node = layer["experts"]["gu" if kind == "vq" else "gate"]
    leaf = node["vq"].idx if "vq" in node else node["w"]
    assert leaf.shape[0] == E
    _assert_same(to_reference_layout(tp), jp)


@pytest.mark.parametrize("kind", ["dense", "vq"])
def test_checkpoint_round_trips_byte_for_byte(kind, tmp_path):
    """The port writes the reference's files for a mixtral SMOKE tree
    (the same manifest and npz members), and restores the reference's
    checkpoint bit for bit."""
    s = _setup()
    jp, tp = s["params"][kind]
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(2, {"params": jp})
    CheckpointManager(str(tmp_path / "port")).save(2, {"params": tp})
    ref, port = (tmp_path / d / "step_0000000002" for d in ("ref", "port"))
    assert (port / "MANIFEST.json").read_bytes() == \
        (ref / "MANIFEST.json").read_bytes()
    with zipfile.ZipFile(port / "params.npz") as a, \
            zipfile.ZipFile(ref / "params.npz") as b:
        assert a.namelist() == b.namelist()
        for name in b.namelist():
            assert a.read(name) == b.read(name), name
    step, state = CheckpointManager(str(tmp_path / "ref")).restore(
        device="cpu")
    assert step == 2
    _assert_same(state["params"], tp)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))


# ------------------------------------------------- quantization and counts


def test_port_quantize_stacks_experts_and_groups_gu():
    s = _setup()
    cfg = s["cfg"]
    mine = tq.quantize_params(s["params"]["dense"][1], cfg,
                              method="synthetic",
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
    want = s["params"]["vq"][1]
    E, dff, D = cfg.num_experts, cfg.moe_d_ff, cfg.d_model
    for lm, lw in zip(mine["layers"], want["layers"]):
        assert set(lm["moe"]) == set(lw["moe"]) == {"router", "experts"}
        assert set(lm["moe"]["experts"]) == {"gu", "down"}
        torch.testing.assert_close(lm["moe"]["router"]["wr"],
                                   lw["moe"]["router"]["wr"], rtol=0, atol=0)
        for name in ("gu", "down"):
            vm, vw = lm["moe"]["experts"][name]["vq"], lw["moe"]["experts"][
                name]["vq"]
            assert (vm.K, vm.N, vm.splits) == (vw.K, vw.N, vw.splits)
            assert vm.idx.shape == vw.idx.shape
            assert vm.codebooks.shape == vw.codebooks.shape == (E, 2, 8, 256)
            assert vm.lead == E
        gu = lm["moe"]["experts"]["gu"]["vq"]
        assert gu.splits == (dff, dff) and gu.K == D
        # the experts' indices differ: independent draws on E
        assert not torch.equal(gu.idx[0], gu.idx[1])
        e1 = vq_index(gu, 1)
        assert e1.idx.shape == (2, D // 8, 2 * dff) and e1.idx.is_contiguous()
        assert torch.equal(e1.idx, gu.idx[1]) and e1.splits == gu.splits


def test_meta_block_init_quantizes_experts():
    """``init(block_device="meta")`` (the full-width route): the experts
    are built from their shapes, the router is drawn on the device."""
    s = _setup()
    m = build_model(s["cfg"])
    gen = torch.Generator().manual_seed(0)
    raw = m.init(gen, device="cpu", block_device="meta")
    assert raw["layers"][0]["moe"]["experts"]["gate"]["w"].is_meta
    assert not raw["layers"][0]["moe"]["router"]["wr"].is_meta
    params = m.quantize(raw, method="synthetic", generator=gen, device="cpu")
    assert tq.count_vq_layers(params) == tq.count_vq_layers(
        s["params"]["vq"][1])


@pytest.mark.parametrize("kind", ["vq", "vq_ungrouped"])
def test_counts_cover_every_expert(kind):
    s = _setup()
    jp, tp = s["params"][kind]
    cfg = s["cfg"]
    L, E = cfg.num_layers, cfg.num_experts
    # attention: wqkv (or wq, wk, wv, wo); experts: gu, down (or gate, up,
    # down), each E linears
    attn_sites = 2 if kind == "vq" else 4
    expert_sites = 2 if kind == "vq" else 3
    assert tq.count_vq_layers(tp) == L * (attn_sites + E * expert_sites)
    assert param_count(tp) == jax_param_count(jp)
    vq_b, dense_b = tq.compressed_model_bytes(tp)
    want_vq = want_dense = 0
    for node in tq.vq_nodes(tp):
        v = node["vq"]
        want_vq += v.idx.numel() + v.codebooks.numel() * 4 + v.scale.numel() * 4
        want_dense += v.idx.numel() // v.C // v.V * v.K * 2
    assert (vq_b, dense_b) == (want_vq, want_dense)
