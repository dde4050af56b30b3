"""xLSTM-125M in the port (``repro_torch/models/xlstm.py``) held against the
JAX reference (``repro/models/xlstm.py``) on the CPU at fp32, on its
SMOKE config (one group: an mLSTM and an sLSTM block, d_model 64, 2
heads), with the reference's params converted (the synthetic
quantization's salt pinned):

  * the config and registry, field for field the reference's;
  * the recurrences from the same numpy inputs: ``mlstm_sequential``,
    ``mlstm_chunkwise`` (chunks 4/8/16, S 3-40, a nonzero initial state)
    and ``slstm_scan`` (``rz`` fp32 and bf16, as served) within 1e-5 x
    max|y|, each state leaf too; the port's chunkwise form against its
    own sequential one (the reference's property test) within 1e-4;
  * both block forwards (prefill, then decode from the prefill's state;
    grouped VQ, ungrouped VQ and dense) within 1e-5 x max|y|, and the
    grouped ``wqkv`` equal to its split members (the reference's
    ``test_xlstm_mlstm_grouped_matches_split_members``, 1e-4);
  * the model: prefill logits (and ``lm_head_last_only``) and 3 decode
    steps from the prefill's state within 1e-5 x max|logit|; prefill +
    step-by-step decode equal to the full forward, and EVA equal to
    dequant (``tests/test_decode_consistency.py``, 1e-4);
  * the port's own quantization: ``wqkv`` grouped under the ``w_if``
    anchor, sLSTM's linears never; at full xlstm-125m width the quantized
    tree's dtypes and shapes equal the reference's
    ``param_specs(quantized=True)`` leaf for leaf (``w_if`` and ``rz``
    bf16 by their stacked size), with 54 VQ linears;
  * ``convert`` and the checkpoint files carry ``"groups"`` both ways,
    byte for byte;
  * B1's and B3's launch shapes at every xlstm linear, and B6's operand
    padding at sLSTM's N = 4 gates (the real columns bitwise equal).
"""
import dataclasses
import functools
import os
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
from repro.models import xlstm as jx
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import to_reference_layout
from repro_torch.core import quantize as tq
from repro_torch.core.plan import PlanPolicy
from repro_torch.core.vq import split_grouped
from repro_torch.kernels.dequant_gemv.ops import (ROWS_PER_STAGE, TOKEN_TILES,
                                                  launch_shape)
from repro_torch.kernels.eva_lookup import tiles
from repro_torch.kernels.fused_vq_matmul.ops import select_split
from repro_torch.kernels.int8_gemm import int8_gemm_ref
from repro_torch.kernels.int8_gemm.ops import N_ALIGN, pad_to_tiles
from repro_torch.kernels.oc_lookup.ops import select_lookup_split
from repro_torch.kernels.vq_gemm.ops import ROWS_MAX as B4_ROWS_MAX
from repro_torch.kernels.vq_gemm.ops import launch_shape as b4_shape
from repro_torch.models import RunConfig, build_model
from repro_torch.models import xlstm as tx

from test_torch_checkpoint import _assert_bitwise, _npz_members
from test_torch_mla import KEY, _close, _conv, _stable_hash, _t
from test_torch_moe import _assert_same

torch.set_num_threads(1)
ARCH = "xlstm_125m"


@functools.lru_cache(maxsize=None)
def setup():
    """The reference's SMOKE model at fp32: dense params, 2-bit VQ params
    (salt pinned) grouped and ungrouped, each with its conversion."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    dense = jm.init(KEY)
    with mock.patch.object(jq, "hash", _stable_hash, create=True):
        vq = jm.quantize(dense, method="synthetic", key=KEY)
        flat = jq.quantize_params(dense, jcfg, method="synthetic", key=KEY,
                                  group_projections=False)
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32")
    trees = {"dense": dense, "vq": vq, "vq_ungrouped": flat}
    return {"jcfg": jcfg, "cfg": cfg, "jm": jm, "m": build_model(cfg),
            "params": {k: (t, _conv(t)) for k, t in trees.items()}}


def _block(s, kind, name):
    """Group 0's block ``name`` in both packages."""
    jp, tp = s["params"][kind]
    return (jax.tree_util.tree_map(lambda a: a[0], jp["groups"][name]),
            tp["groups"][0][name])


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close_tree(got, want, rel=1e-5):
    assert set(got) == set(want)
    for n in want:
        assert tuple(got[n].shape) == tuple(np.shape(want[n])), n
        _close(got[n].numpy(), want[n], rel)


def test_config_and_registry_equal_reference():
    for name in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(tconfigs, name)(ARCH)) == \
            dataclasses.asdict(getattr(jconfigs, name)(ARCH)), name
    assert tconfigs.get_config("xlstm-125m") == tconfigs.get_config(ARCH)
    ids = tconfigs.ARCH_IDS
    assert ids.index("whisper_medium") + 1 == ids.index(ARCH) == \
        ids.index("deepseek_v2_lite_16b") - 1
    model = build_model(tconfigs.get_config(ARCH))
    assert model.module is tx


# ---------------------------------------------------------------- recurrences


def _mlstm_inputs(seed, B, S, H, hd, scale_state=0.1):
    """The reference's property-test inputs, drawn with numpy: q/k/v,
    log i~, log f = log_sigmoid(2 z) and a nonzero state."""
    rng = _rng(seed)
    q, k, v = (_f32(rng, B, S, H, hd) for _ in range(3))
    li = _f32(rng, B, S, H, scale=2.0)
    lf = np.asarray(jax.nn.log_sigmoid(_f32(rng, B, S, H, scale=2.0)))
    st = {"C": _f32(rng, B, H, hd, hd, scale=scale_state),
          "n": np.abs(_f32(rng, B, H, hd)), "m": _f32(rng, B, H, scale=0.5)}
    return (q, k, v, li, lf), st


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mlstm_sequential_matches_reference(seed):
    args, st = _mlstm_inputs(seed, 2, 7, 2, 4)
    want, wst = jx.mlstm_sequential(*map(jnp.asarray, args),
                                    {n: jnp.asarray(a) for n, a in st.items()})
    got, gst = tx.mlstm_sequential(*map(_t, args),
                                   {n: _t(a) for n, a in st.items()})
    _close(got.numpy(), want)
    _close_tree(gst, {n: np.asarray(a) for n, a in wst.items()})


@pytest.mark.parametrize("S,chunk", [(3, 4), (8, 4), (13, 4), (17, 8),
                                     (24, 8), (5, 16), (33, 16), (40, 16)])
def test_mlstm_chunkwise_matches_reference(S, chunk):
    args, st = _mlstm_inputs(S * 31 + chunk, 2, S, 2, 4)
    jst = {n: jnp.asarray(a) for n, a in st.items()}
    want, wst = jx.mlstm_chunkwise(*map(jnp.asarray, args), jst, chunk=chunk)
    got, gst = tx.mlstm_chunkwise(*map(_t, args),
                                  {n: _t(a) for n, a in st.items()},
                                  chunk=chunk)
    _close(got.numpy(), want)
    _close_tree(gst, {n: np.asarray(a) for n, a in wst.items()})
    # the reference's property: chunkwise == sequential, rtol/atol 1e-4
    seq, sst = tx.mlstm_sequential(*map(_t, args),
                                   {n: _t(a) for n, a in st.items()})
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gst["C"].numpy(), sst["C"].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rz_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 9])
def test_slstm_scan_matches_reference(S, rz_dtype):
    """``rz`` bf16 (the served tree) against an fp32 h: the reference's
    einsum promotes, the port upcasts; both exact."""
    B, H, hd = 2, 2, 8
    rng = _rng(S)
    z, o = _f32(rng, B, S, H * hd), _f32(rng, B, S, H * hd)
    i, f = _f32(rng, B, S, H, scale=2.0), _f32(rng, B, S, H, scale=2.0)
    st = {"c": _f32(rng, B, H, hd), "n": np.abs(_f32(rng, B, H, hd)) + 0.1,
          "h": _f32(rng, B, H, hd, scale=0.5), "m": _f32(rng, B, H)}
    rz = _f32(rng, H, hd, hd) / np.sqrt(hd)
    jrz = jnp.asarray(rz).astype(rz_dtype)
    trz = _t(rz).to(getattr(torch, rz_dtype))
    want, wst = jx.slstm_scan({"rz": jrz}, *map(jnp.asarray, (z, i, f, o)),
                              {n: jnp.asarray(a) for n, a in st.items()},
                              H, hd)
    got, gst = tx.slstm_scan({"rz": trz}, *map(_t, (z, i, f, o)),
                             {n: _t(a) for n, a in st.items()}, H, hd)
    _close(got.numpy(), want)
    _close_tree(gst, {n: np.asarray(a) for n, a in wst.items()})


# --------------------------------------------------------------------- blocks


@pytest.mark.parametrize("kind", ["vq", "vq_ungrouped", "dense"])
@pytest.mark.parametrize("name", ["b0_mlstm", "b1_slstm"])
def test_block_forwards_match_reference(name, kind):
    """Prefill over 11 tokens from no state (attn_chunk 4: three chunks,
    the last padded), then one decode step from the prefill's state."""
    s = setup()
    jb, tb = _block(s, kind, name)
    assert ("wqkv" in tb) == (name == "b0_mlstm" and kind == "vq")
    jfwd, tfwd = ((jx.mlstm_block_fwd, tx.mlstm_block_fwd)
                  if name == "b0_mlstm" else
                  (jx.slstm_block_fwd, tx.slstm_block_fwd))
    x = _f32(_rng(5), 2, 12, s["cfg"].d_model)
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=4)
    trc = RunConfig(mode="prefill", attn_chunk=4)
    want, wst = jfwd(jb, jnp.asarray(x[:, :11]), jrc, s["jcfg"])
    with torch.no_grad():
        got, gst = tfwd(tb, _t(x[:, :11]), trc, s["cfg"])
    _close(got.numpy(), want)
    _close_tree(gst, {n: np.asarray(a) for n, a in wst.items()})
    want, wst = jfwd(jb, jnp.asarray(x[:, 11:]), jrc.replace(mode="decode"),
                     s["jcfg"], wst)
    with torch.no_grad():
        got, gst = tfwd(tb, _t(x[:, 11:]), trc.replace(mode="decode"),
                        s["cfg"], gst)
    _close(got.numpy(), want)
    _close_tree(gst, {n: np.asarray(a) for n, a in wst.items()})


def test_grouped_wqkv_equals_split_members():
    """The reference's grouped-VQ test in the port: one mLSTM block
    quantized with its q|k|v grouped (anchored by ``w_if``), then split
    back into members; the block's output equal within 1e-4."""
    s = setup()
    _, tb = _block(s, "vq", "b0_mlstm")
    assert tb["wqkv"]["vq"].splits == (128, 128, 128)
    split = {k: v for k, v in tb.items() if k != "wqkv"}
    for name, member in zip(("wq", "wk", "wv"),
                            split_grouped(tb["wqkv"]["vq"])):
        split[name] = {"vq": member}
    x = _t(_f32(_rng(3), 2, 3, s["cfg"].d_model))
    rc = RunConfig(mode="decode", plan_policy=PlanPolicy(vq_mode="eva"))
    with torch.no_grad():
        yg, _ = tx.mlstm_block_fwd(tb, x, rc, s["cfg"])
        ys, _ = tx.mlstm_block_fwd(split, x, rc, s["cfg"])
    np.testing.assert_allclose(yg.numpy(), ys.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------- model


@pytest.mark.parametrize("kind", ["vq", "dense"])
def test_logits_match_jax(kind):
    """Prefill logits of 20 tokens on two rows (and the last token's under
    ``lm_head_last_only``); then 3 decode steps from the prefill's state,
    the cache updated in place."""
    s = setup()
    jp, tp = s["params"][kind]
    toks = _rng(7).integers(0, 512, (2, 23)).astype(np.int32)
    jrc = jcm.RunConfig(mode="prefill", remat=False, attn_chunk=8)
    trc = RunConfig(mode="prefill", attn_chunk=8)
    want, jc = s["jm"].prefill(jp, {"tokens": jnp.asarray(toks[:, :20])}, jrc)
    with torch.no_grad():
        got, tc = s["m"].prefill(tp, {"tokens": _t(toks[:, :20])}, trc)
        last, _ = s["m"].prefill(tp, {"tokens": _t(toks[:, :20])},
                                 trc.replace(lm_head_last_only=True))
    _close(got.numpy(), want)
    assert torch.equal(last, got[:, -1:])
    ptrs = {n: t.data_ptr() for node in tc.values() for n, t in node.items()}
    for i in range(3):
        pos = 20 + i
        want, jc = s["jm"].decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                                  jnp.full((2, 1), pos, jnp.int32), jc,
                                  jrc.replace(mode="decode"))
        with torch.no_grad():
            got, tc2 = s["m"].decode(tp, _t(toks[:, pos:pos + 1]),
                                     torch.full((2, 1), pos,
                                                dtype=torch.int32),
                                     tc, trc.replace(mode="decode"))
        assert tc2 is tc
        _close(got.numpy(), want)
    for name, node in jc.items():
        _close_tree(tc[name], {n: np.asarray(a) for n, a in node.items()})
    assert {n: t.data_ptr() for node in tc.values()
            for n, t in node.items()} == ptrs


def test_prefill_then_decode_equals_full_forward():
    """``tests/test_decode_consistency.py`` in the port: the train-mode
    forward over 12 tokens against a prefill of 8 and 4 decode steps,
    rtol/atol 1e-4."""
    s = setup()
    _, tp = s["params"]["dense"]
    toks = _t(_rng(11).integers(0, 512, (2, 12)).astype(np.int32))
    with torch.no_grad():
        full, _ = s["m"].forward(tp, {"tokens": toks},
                                 RunConfig(mode="train", attn_chunk=8))
        pre, cache = s["m"].prefill(tp, {"tokens": toks[:, :8]},
                                    RunConfig(attn_chunk=8))
        np.testing.assert_allclose(pre[:, -1].numpy(), full[:, 7].numpy(),
                                   rtol=1e-4, atol=1e-4)
        for t in range(8, 12):
            got, cache = s["m"].decode(tp, toks[:, t:t + 1],
                                       torch.full((2, 1), t,
                                                  dtype=torch.int32),
                                       cache, RunConfig())
            np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                       rtol=1e-4, atol=1e-4)


def test_eva_decode_equals_dequant():
    """The paper's exactness claim at model level, on the VQ params: one
    decode step through EVA and through the dequant baseline from the
    same prefill state, rtol/atol 1e-4."""
    s = setup()
    _, tp = s["params"]["vq"]
    toks = _t(_rng(13).integers(0, 512, (2, 9)).astype(np.int32))
    step = (toks[:, 8:], torch.full((2, 1), 8, dtype=torch.int32))
    out = {}
    with torch.no_grad():
        for mode in ("eva", "dequant"):
            rc = RunConfig(plan_policy=PlanPolicy(vq_mode=mode))
            _, cache = s["m"].prefill(tp, {"tokens": toks[:, :8]}, rc)
            out[mode], _ = s["m"].decode(tp, *step, cache, rc)
    np.testing.assert_allclose(out["eva"].numpy(), out["dequant"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_init_cache_equals_reference():
    """The recurrent state's layout and values (sLSTM's ``n`` = 1e-6),
    whatever ``max_len``; ``kv_int8`` and ``kvq`` are ignored."""
    s = setup()
    want = s["jm"].init_cache(3, 17)
    for kw in ({}, {"kv_int8": True}):
        got = s["m"].init_cache(3, 99, device="cpu", **kw)
        assert set(got) == set(want) == {"b0_mlstm", "b1_slstm"}
        for name, node in want.items():
            assert set(got[name]) == set(node)
            for n, a in node.items():
                assert got[name][n].dtype == torch.float32
                np.testing.assert_array_equal(got[name][n].numpy(),
                                              np.asarray(a))


# --------------------------------------------------------------- quantization


def _port_dense(cfg, device="cpu", block_device=None):
    gen = torch.Generator().manual_seed(0)
    return build_model(cfg).init(gen, device=device,
                                 block_device=block_device), gen


def test_port_quantize_groups_mlstm_qkv_only():
    """The port's own pass on its own params: the mLSTM's q|k|v group
    under ``w_if``, never sLSTM's linears; ``w_if``/``wi``/``wf`` and
    ``rz`` stay dense."""
    cfg = tconfigs.get_smoke_config(ARCH)
    dense, gen = _port_dense(cfg)
    qp = tq.quantize_params(dense, cfg, method="synthetic",
                            generator=gen, device="cpu")
    m, sl = qp["groups"][0]["b0_mlstm"], qp["groups"][0]["b1_slstm"]
    assert m["wqkv"]["vq"].splits == (128, 128, 128)
    assert not {"wq", "wk", "wv"} & set(m)
    assert set(m["w_if"]) == {"w", "b"}
    assert {k for k in sl if isinstance(sl[k], dict) and "vq" in sl[k]} == \
        {"wz", "wo", "out"}
    assert {"w", "b"} == set(sl["wi"]) == set(sl["wf"])
    assert "vq" in sl["ffn"]["up"] and "b" in sl["ffn"]["up"]
    assert tq.count_vq_layers(qp) == 4 + 5


def _shapes(tree, prefix=""):
    """path -> (shape, dtype name) of every leaf (VQWeight fields too)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "idx") and hasattr(tree, "codebooks"):
        return {f"{prefix}/{f}": _shapes(getattr(tree, f))[""]
                for f in ("idx", "codebooks", "scale")}
    dt = tree.dtype
    return {prefix: (tuple(tree.shape),
                     str(dt).replace("torch.", ""))}


@pytest.fixture(scope="module")
def full_width():
    """xlstm-125m at full width in the port: block projections from their
    shapes (meta), quantized synthetically on the CPU (0.2 GB)."""
    cfg = tconfigs.get_config(ARCH)
    dense, gen = _port_dense(cfg, block_device="meta")
    return cfg, tq.quantize_params(dense, cfg, method="synthetic",
                                   generator=gen, device="cpu")


def test_quantized_dtypes_equal_reference_param_specs(full_width):
    """The serving-dtype rule: a dense fp32 leaf goes bf16 when
    its STACKED size (the reference's) is >= 65536: ``w_if`` (6, 1536,
    8) and ``rz`` (6, 4, 192, 192) bf16, ``wi``/``wf``, norms and biases
    fp32; every leaf's shape and dtype the reference's."""
    cfg, qp = full_width
    want = _shapes(jax_build_model(jconfigs.get_config(ARCH)).param_specs(
        quantized=True))
    got = _shapes(to_reference_layout(qp))
    assert got == want
    assert want["/groups/b0_mlstm/w_if/w"] == ((6, 1536, 8), "bfloat16")
    assert want["/groups/b1_slstm/rz"] == ((6, 4, 192, 192), "bfloat16")
    assert want["/groups/b1_slstm/wi/w"] == ((6, 768, 4), "float32")


def test_vq_counts_at_full_width(full_width):
    """54 VQ linears (9 a group: up_h, up_g, wqkv, down; wz, wo, out, the
    FFN's up and down) and their bytes."""
    cfg, qp = full_width
    assert tq.count_vq_layers(qp) == 54
    vq_b, dense_b = tq.compressed_model_bytes(qp)
    weights = 6 * (2 * 768 * 1536 + 1536 * 4608 + 1536 * 768
                   + 3 * 768 * 768 + 2 * 768 * 1024)
    assert dense_b == 2 * weights
    assert weights // 4 < vq_b < weights // 4 + 54 * 2 * (8 * 256 * 4 + 4608 * 4)


# ------------------------------------------------- conversion and checkpoints


@pytest.mark.parametrize("kind", ["dense", "vq", "vq_ungrouped"])
def test_convert_carries_groups_both_ways(kind):
    s = setup()
    jp, tp = s["params"][kind]
    assert isinstance(tp["groups"], list) and len(tp["groups"]) == 1
    assert set(tp["groups"][0]) == {"b0_mlstm", "b1_slstm"}
    _assert_same(to_reference_layout(tp), jp)


@pytest.mark.parametrize("kind", ["vq", "dense"])
def test_checkpoint_files_byte_for_byte(kind, tmp_path):
    """The port writes the reference's files for an xlstm SMOKE tree (its
    ``groups`` stacked), and restores the reference's checkpoint bit for
    bit."""
    s = setup()
    jp, tp = s["params"][kind]
    jmanager.CheckpointManager(str(tmp_path / "ref")).save(2, {"params": jp})
    CheckpointManager(str(tmp_path / "port")).save(2, {"params": tp})
    ref, port = (tmp_path / d / "step_0000000002" for d in ("ref", "port"))
    assert (port / "MANIFEST.json").read_bytes() == \
        (ref / "MANIFEST.json").read_bytes()
    assert b"groups/b1_slstm/rz" in (ref / "MANIFEST.json").read_bytes()
    mine, want = (_npz_members(d / "params.npz") for d in (port, ref))
    assert list(mine) == list(want)
    for name, data in want.items():
        assert mine[name] == data, name
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    step, state = CheckpointManager(str(tmp_path / "ref")).restore(
        device="cpu")
    assert step == 2
    _assert_bitwise(state["params"], tp)


# --------------------------------------------------------------- launch shapes


def _linears(cfg):
    """(name, K, N) of every VQ linear of an xlstm group."""
    D, di = cfg.d_model, 2 * cfg.d_model
    ffn = int(4 / 3 * D) // 8 * 8
    return [("up_h|up_g", D, di), ("wqkv", di, 3 * di), ("down", di, D),
            ("wz|wo|out", D, D), ("ffn_up", D, ffn), ("ffn_down", ffn, D)]


@pytest.mark.parametrize("arch", ["full", "smoke"])
def test_b1_launch_shape_at_every_xlstm_linear(arch):
    """The fused kernel's tile model places every decode linear at M 1-4
    (N = 768 is ragged at the 1024-column tile and 1.5 tiles of 512):
    covers V and N, fits 227 KB, one wave of the card."""
    cfg = (tconfigs.get_config if arch == "full"
           else tconfigs.get_smoke_config)(ARCH)
    for name, K, N in _linears(cfg):
        V = K // 8
        for M in (1, 2, 4):
            t = select_split(M, V, N, C=2, sm_count=132)
            assert t.splits * t.slabs_per_split * t.vl >= V, name
            assert t.smem == tiles.smem_bytes(2, t.mw, t.bn, t.stages,
                                              True) <= 227 * 1024
            assert -(-N // t.bn) * t.bn >= N
            assert tiles.grid_ctas(t, M, N) <= 132 * t.groups, (name, M, t)


@pytest.mark.parametrize("arch", ["full", "smoke"])
def test_split_launch_shapes_at_every_xlstm_linear(arch):
    """The split-pinned planner's pair at every decode linear, M 1-4:
    vq_gemm's grid writes each (codebook, row) of M x V once, and
    oc_lookup's tile model covers V and N (N = 768 ragged at the
    1024-column tile), fits 227 KB without codebooks or x rows, and keeps
    its split workspace under 64 MB."""
    cfg = (tconfigs.get_config if arch == "full"
           else tconfigs.get_smoke_config)(ARCH)
    for name, K, N in _linears(cfg):
        V = K // 8
        for M in (1, 2, 4):
            rows, ctas = b4_shape(M * V, 132)
            assert 1 <= rows <= B4_ROWS_MAX and \
                (ctas - 1) * rows < M * V <= ctas * rows, (name, M)
            t = select_lookup_split(M, V, N, C=2, sm_count=132)
            assert t.splits * t.slabs_per_split * t.vl >= V, (name, M)
            assert t.smem == tiles.smem_bytes(2, t.mw, t.bn, t.stages,
                                              False) <= 227 * 1024
            assert -(-N // t.bn) * t.bn >= N
            if t.groups > 1:
                assert t.groups * M * N * 4 <= 64 << 20, (name, M, t)


@pytest.mark.parametrize("M", [5, 32, 200])
def test_b3_launch_shape_at_every_xlstm_linear(M):
    """dequant_gemv's launch at an exact-length prefill of M tokens: a
    token tile that holds M (tiles of 256 above) and between one K split
    and one a stage."""
    for name, K, N in _linears(tconfigs.get_config(ARCH)):
        T, splits = launch_shape(M, K // 8, N, 132)
        assert T in TOKEN_TILES and T >= min(M, TOKEN_TILES[-1]), (name, T)
        assert 1 <= splits <= -(-(K // 8) // ROWS_PER_STAGE), (name, splits)


@pytest.mark.parametrize("M", [1, 20, 200])
def test_b6_pads_the_n4_gates_and_keeps_the_real_columns(M):
    """sLSTM's ``wi``/``wf`` under INT8 prefill: K = 768, N = 4. The
    wrapper pads wq/ws to N_ALIGN columns of zeros; the plain version
    over the padded operands, sliced to N, is bitwise the unpadded one,
    and the padded columns are zero."""
    rng = _rng(M)
    xq = _t(rng.integers(-127, 128, (M, 768)).astype(np.int8))
    wq = _t(rng.integers(-127, 128, (768, 4)).astype(np.int8))
    xs, ws = _t(_f32(rng, M, 1) ** 2), _t(_f32(rng, 1, 4) ** 2)
    pxq, pwq, pxs, pws = pad_to_tiles(xq, wq, xs, ws)
    assert tuple(pwq.shape) == (768, N_ALIGN) and tuple(pws.shape) == \
        (1, N_ALIGN) and pxq is xq
    y = int8_gemm_ref(pxq, pwq, pxs, pws)
    assert torch.equal(y[:, :4], int8_gemm_ref(xq, wq, xs, ws))
    assert not y[:, 4:].any()
