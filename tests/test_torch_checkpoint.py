"""The port's checkpoint manager against the reference's
(``repro/checkpoint/manager.py``) on the CPU, with quantized SMOKE params
of the dense configs (bf16 embedding and head, grouped ``wqkv``/``gu``
splits, qwen2's qkv biases drawn at random, the KV-VQ codebooks):

  * a checkpoint the JAX manager writes restores in the port bit for bit
    (dtypes included, bf16 leaves read from their '<V2' bits), in the
    port's per-layer layout, and serves the JAX engine's greedy tokens;
  * the port writes the reference's files: the same MANIFEST.json and,
    member for member, the same .npy bytes (header, dtype string, data)
    in every group's npz;
  * the JAX manager restores what the port wrote, leaf for leaf (every
    leaf but bf16, which the reference's own restore cannot read);
  * the manager's mechanics: atomic rename, keep-K, async save then
    wait, ``.tmp`` directories ignored, FileNotFoundError on an empty
    directory, NotImplementedError on a VQ-Logits head (which the
    reference pickles into a file its own restore refuses), and a port
    round trip (tuples, None, scalars, bf16) bit for bit;
  * optimizer state (the ``__adamw__`` node, with and without fp32
    master copies): the reference's restored by the port, the port's
    files byte-equal to the reference's and restored by it.
"""
import dataclasses
import json
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
from repro.core import vq as jvq
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import (CheckpointManager, flatten_with_paths,
                                    unflatten_from_paths)
from repro_torch.convert import from_jax_params, to_reference_layout
from repro_torch.core import quantize as tq
from repro_torch.core import vq as tvq
from repro_torch.core.vq import VQWeight
from repro_torch.models import RunConfig, build_model
from repro_torch.optim import AdamWState as TAdamWState
from repro_torch.serve import Engine, EngineConfig

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCHS = ["llama3_8b", "qwen3_0_6b", "qwen2_72b", "qwen2_grouped"]


def _stable_hash(s: str) -> int:
    return zlib.crc32(s.encode())


def _smoke(mod, arch):
    if arch == "qwen2_grouped":  # kv width 64: wq|wk|wv group with biases
        return dataclasses.replace(mod.get_smoke_config("qwen2_72b"),
                                   head_dim=32, dtype="float32")
    return dataclasses.replace(mod.get_smoke_config(arch), dtype="float32")


def _jax_params(arch, kv_bits=None):
    jcfg = _smoke(jconfigs, arch)
    jm = jax_build_model(jcfg)
    rng = np.random.default_rng(1)
    dense = jm.init(KEY)

    def biases(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape)
                                    .astype(np.float32)) if k == "b"
                        else biases(v)) for k, v in node.items()}
        return node

    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(biases(dense), method="synthetic", key=KEY)
    if kv_bits:
        vq = jq.attach_kv_codebooks(vq, jcfg, jvq.KVQuantConfig(kv_bits=kv_bits))
    return jm, jcfg, vq


def _conv(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _leaves(tree, prefix=""):
    """path -> tensor of a port tree (VQWeight fields and metadata too)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
    elif isinstance(tree, VQWeight):
        for f in ("idx", "codebooks", "scale"):
            out[f"{prefix}/{f}"] = getattr(tree, f)
        out[f"{prefix}/meta"] = (tree.K, tree.N, tree.d, tree.n, tree.splits)
    else:
        out[prefix] = tree
    return out


def _assert_bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k, b in w.items():
        a = g[k]
        if not isinstance(b, torch.Tensor):
            assert a == b, k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k


def _npz_members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


# ------------------------------------------- the reference's checkpoints


@pytest.mark.parametrize("arch", ARCHS)
def test_restores_reference_checkpoint_bit_for_bit_and_serves(arch, tmp_path):
    jm, jcfg, jp = _jax_params(arch)
    jmanager.CheckpointManager(str(tmp_path)).save(3, {"params": jp})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    step, state = mgr.restore(device="cpu")
    assert step == 3 and set(state) == {"params"}
    params = state["params"]
    want = _conv(jp)
    _assert_bitwise(params, want)
    assert params["embedding"]["emb"].dtype == torch.bfloat16
    attn = params["layers"][0]["attn"]
    assert isinstance(params["layers"], list)
    assert len(params["layers"]) == jcfg.num_layers
    if "wqkv" in attn:
        cfg = _smoke(tconfigs, arch)
        assert attn["wqkv"]["vq"].splits == (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 7)]
    jrc = jcm.RunConfig(mode="decode", remat=False, attn_chunk=16)
    tokens = JaxEngine(jm, jp, jrc, JaxEngineConfig(num_slots=2, max_len=32)
                       ).generate(prompts, 5)
    eng = Engine(build_model(_smoke(tconfigs, arch)), params,
                 RunConfig(attn_chunk=16), EngineConfig(num_slots=2, max_len=32),
                 device="cpu")
    assert eng.generate(prompts, 5) == tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_port_writes_the_reference_files(arch, tmp_path):
    """Same tree, both managers: equal manifests and npz members. The
    port's params carry their own KV-VQ codebooks (one tensor shared by
    the layers), written stacked as the reference's."""
    _, jcfg, jp = _jax_params(arch)
    kvq = jvq.KVQuantConfig(kv_bits=4)
    jp = jq.attach_kv_codebooks(jp, jcfg, kvq)
    params = tq.attach_kv_codebooks(_conv(jq.attach_kv_codebooks(
        jp, jcfg, kvq)), _smoke(tconfigs, arch), tvq.KVQuantConfig(kv_bits=4))
    jstate = {"params": jp, "extra": {"step": jnp.asarray(7), "none": None,
                                      "seq": (jnp.arange(3),)}}
    state = {"params": params,
             "extra": {"step": torch.tensor(7, dtype=torch.int32), "none": None,
                       "seq": (torch.arange(3, dtype=torch.int32),)}}
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(5, jstate)
    CheckpointManager(str(tmp_path / "port")).save(5, state)
    ref, port = (tmp_path / d / "step_0000000005" for d in ("ref", "port"))
    assert (port / "MANIFEST.json").read_bytes() == \
        (ref / "MANIFEST.json").read_bytes()
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for group in ("params", "extra"):
        mine = _npz_members(port / f"{group}.npz")
        want = _npz_members(ref / f"{group}.npz")
        assert list(mine) == list(want)
        for name, data in want.items():
            assert mine[name] == data, (group, name)
    headers = [d[:128] for d in _npz_members(port / "params.npz").values()]
    assert any(b"'descr': '<V2'" in h for h in headers)  # the bf16 leaves


@pytest.mark.parametrize("arch", ["qwen2_grouped", "qwen3_0_6b"])
def test_reference_restores_port_checkpoint(arch, tmp_path):
    """Every leaf but bf16 (the reference cannot read its own bf16
    leaves): the port's tree with those leaves widened to fp32."""
    _, _, jp = _jax_params(arch)
    params = _conv(jp)
    widened = jax.tree_util.tree_map(
        lambda a: a.astype(np.float32) if a.dtype == jnp.bfloat16 else a, jp)
    for node in (params["embedding"], params["lm_head"]):
        for k, t in node.items():
            node[k] = t.float()
    CheckpointManager(str(tmp_path)).save(1, {"params": params})
    step, state = jmanager.CheckpointManager(str(tmp_path)).restore()
    got = state["params"]
    assert step == 1
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(widened)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(widened)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    vq = got["layers"]["attn"]["wo"]["vq"]
    assert isinstance(vq, jvq.VQWeight)
    assert vq.splits == jp["layers"]["attn"]["wo"]["vq"].splits


def test_flatten_paths_equal_reference():
    _, _, jp = _jax_params("qwen3_0_6b")
    mine = [p for p, _ in flatten_with_paths(to_reference_layout(_conv(jp)))]
    want = [p for p, _ in jmanager.flatten_with_paths(jp)]
    assert mine == want
    assert any("/__vq__/__vqmeta__" in p for p in mine)


# ----------------------------------------------------------- mechanics


def _state(scale=1.0):
    return {"params": {"x": torch.ones(4) * scale,
                       "h": torch.arange(6, dtype=torch.float32)
                       .bfloat16().reshape(2, 3),
                       "layers": [{"w": torch.full((2,), float(i)),
                                   "vq": tvq.synthetic_vq(
                                       torch.Generator().manual_seed(i), 16, 8,
                                       splits=(4, 4), device="cpu")}
                                  for i in range(3)],
                       "none": None, "seq": (torch.tensor(1), torch.tensor(2))},
            "extra": {"step": torch.tensor(7)}}


def test_round_trip_bit_exact():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        state = _state()
        mgr.save(7, state)
        step, got = mgr.restore(device="cpu")
        assert step == 7
        _assert_bitwise(got, state)
        assert got["params"]["seq"] == (torch.tensor(1), torch.tensor(2))
        assert got["params"]["none"] is None
        assert got["params"]["layers"][2]["vq"].splits == (4, 4)
        # on disk the layers are one node stacked on L
        step_dir = os.path.join(d, "step_0000000007")
        with open(os.path.join(step_dir, "MANIFEST.json")) as f:
            paths = json.load(f)["groups"]["params"]
        with np.load(os.path.join(step_dir, "params.npz")) as z:
            assert z[f"a{paths.index('/layers/w')}"].shape == (3, 2)
            assert z[f"a{paths.index('/layers/vq/__vq__/idx')}"].shape == \
                (3, 2, 2, 8)
            assert z[f"a{paths.index('/h')}"].dtype == np.dtype("V2")
        if not torch.cuda.is_available():  # the default device is the card
            with pytest.raises(RuntimeError, match="device='cpu'"):
                mgr.restore()


def test_atomic_rename_keeps_the_last_valid_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0))
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    with mock.patch("os.rename", side_effect=OSError("crash")):
        with pytest.raises(OSError, match="crash"):
            mgr.save(2, _state(2.0))
    assert os.path.isdir(tmp_path / "step_0000000002.tmp")
    assert mgr.all_steps() == [1]
    step, got = mgr.restore(device="cpu")
    assert step == 1 and float(got["params"]["x"][0]) == 1.0
    mgr.save(2, _state(2.0))  # a later save replaces the stale .tmp
    assert mgr.all_steps() == [1, 2]
    assert not os.path.exists(tmp_path / "step_0000000002.tmp")


def test_keep_k_and_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": {"x": torch.ones(2) * s}})
    assert mgr.all_steps() == [3, 4]
    step, st = mgr.restore(3, device="cpu")
    assert step == 3 and float(st["params"]["x"][0]) == 3.0


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    x = torch.ones(4)
    mgr.save(1, {"params": {"x": x}})
    x.fill_(5.0)  # the host snapshot was taken before the thread started
    mgr.wait()
    assert mgr.latest_step() == 1
    _, st = mgr.restore(device="cpu")
    assert torch.equal(st["params"]["x"], torch.ones(4))
    mgr.save(2, {"params": {"x": x}}, block=True)
    assert mgr.all_steps() == [1, 2]


def test_tmp_dirs_and_empty_directory(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")
    os.makedirs(tmp_path / "step_0000000005.tmp")
    (tmp_path / "step_0000000005.tmp" / "params.npz").write_bytes(b"junk")
    assert mgr.latest_step() is None
    os.makedirs(tmp_path / "step_0000000006")  # no MANIFEST: invalid too
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")


def _adamw_states(use_master):
    """The reference's AdamWState after two updates of qwen3 SMOKE at fp32
    (nonzero m and v; with ``use_master`` fp32 master copies), its dense
    params, and both as the port's trees."""
    jcfg = _smoke(jconfigs, "qwen3_0_6b")
    jm = jax_build_model(jcfg)
    jp = jm.init(KEY)
    cfg = AdamWConfig(lr=1e-2, use_master=use_master)
    st = adamw_init(jp, cfg)
    toks = jnp.asarray(np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 8)), jnp.int32)
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, axis=1)}
    rc = jcm.RunConfig(remat=False, attn_chunk=8)
    for _ in range(2):
        grads = jax.grad(lambda p: jm.loss(p, batch, rc))(jp)
        jp, st, _ = adamw_update(grads, st, jp, cfg)
    state = TAdamWState(step=torch.tensor(int(st.step), dtype=torch.int32),
                        m=_conv(st.m), v=_conv(st.v),
                        master=None if st.master is None else _conv(st.master))
    return jp, st, _conv(jp), state


def test_optimizer_state_raises(tmp_path):
    """Optimizer state no longer raises: the reference's ``__adamw__``
    node, written by the JAX manager beside the params, restores in the
    port as an ``AdamWState`` (step, m, v; no master) bit for bit, and
    ``unflatten_from_paths`` rebuilds one from the reference's paths."""
    jp, jst, params, state = _adamw_states(False)
    jmanager.CheckpointManager(str(tmp_path)).save(
        1, {"params": jp, "opt": jst})
    step, got = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 1 and isinstance(got["opt"], TAdamWState)
    assert got["opt"].master is None
    _assert_bitwise(got["opt"], state)
    _assert_bitwise(got["params"], params)
    flat = dict(jmanager.flatten_with_paths({"opt": jst}))
    rebuilt = unflatten_from_paths(flat)["opt"]
    assert isinstance(rebuilt, TAdamWState) and rebuilt.master is None
    assert int(rebuilt.step) == 2


@pytest.mark.parametrize("use_master", [False, True])
def test_adamw_state_files_equal_reference(tmp_path, use_master):
    """The port writes the reference's files for an AdamWState: the same
    MANIFEST.json (``__adamw__/{step,m,v,master}`` paths, ``master``
    ``__none__`` when absent) and the same npz members, byte for byte."""
    jp, jst, params, state = _adamw_states(use_master)
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(
        3, {"params": jp, "opt": jst})
    CheckpointManager(str(tmp_path / "port")).save(
        3, {"params": params, "opt": state})
    ref, port = (tmp_path / d / "step_0000000003" for d in ("ref", "port"))
    manifest = (ref / "MANIFEST.json").read_bytes()
    assert (port / "MANIFEST.json").read_bytes() == manifest
    assert (b"/__adamw__/master/__none__" in manifest) != use_master
    for group in ("params", "opt"):
        mine = _npz_members(port / f"{group}.npz")
        want = _npz_members(ref / f"{group}.npz")
        assert list(mine) == list(want)
        for name, data in want.items():
            assert mine[name] == data, (group, name)


@pytest.mark.parametrize("use_master", [False, True])
def test_adamw_state_round_trips(tmp_path, use_master):
    """Both directions: the reference restores what the port wrote (every
    leaf equal to its own state's), the port restores what the reference
    wrote and what it wrote itself, bit for bit."""
    jp, jst, params, state = _adamw_states(use_master)
    CheckpointManager(str(tmp_path / "port")).save(
        4, {"params": params, "opt": state})
    _, back = jmanager.CheckpointManager(str(tmp_path / "port")).restore()
    assert isinstance(back["opt"], AdamWState)
    assert jax.tree_util.tree_structure(back["opt"]) == \
        jax.tree_util.tree_structure(jst)
    for a, b in zip(jax.tree_util.tree_leaves(back["opt"]),
                    jax.tree_util.tree_leaves(jst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, mine = CheckpointManager(str(tmp_path / "port")).restore(device="cpu")
    _assert_bitwise(mine["opt"], state)
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(
        4, {"params": jp, "opt": jst})
    _, got = CheckpointManager(str(tmp_path / "ref")).restore(device="cpu")
    _assert_bitwise(got["opt"], state)
    assert (got["opt"].master is None) != use_master


@pytest.mark.parametrize("async_save", [False, True])
def test_vq_logits_head_refused_by_name(tmp_path, async_save):
    """``save`` of a tree with a ``vql`` node raises NotImplementedError
    naming the node, before it writes anything; the reference writes
    the head as one pickled object leaf, which its own restore refuses."""
    from repro.core import logits_vq as jlvq
    from repro_torch.core import logits_vq as tlvq

    head = tlvq.synthetic_logits_vq(torch.Generator().manual_seed(0), 64,
                                    512, 16, device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    params = {"lm_head": {"vql": head}, "final_norm": {"g": torch.ones(64)}}
    with pytest.raises(NotImplementedError, match="/params/lm_head/vql"):
        mgr.save(3, {"params": params})
    assert os.listdir(tmp_path) == [] and mgr.latest_step() is None
    jhead = jlvq.synthetic_logits_vq(KEY, 64, 512, 16)
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(
        1, {"params": {"lm_head": {"vql": jhead}}})
    with pytest.raises(ValueError, match="allow_pickle"):
        jmanager.CheckpointManager(str(tmp_path / "ref")).restore()

