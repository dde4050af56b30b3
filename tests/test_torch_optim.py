"""The port's optimizers (``repro_torch/optim``) against the reference's
(``repro/optim``) on the CPU, on the same fp32 (and bf16) numpy inputs:

  * AdamW without and with fp32 master copies, with and without the
    global-norm clip, over a nested tree (a list of per-layer dicts as
    the port holds layers): params, m, v, master and the norm within
    1e-6 relative (fp32 reassociation) after five steps; a VQWeight node
    and a leaf without a gradient are left as they are;
  * SGD with momentum, ``global_norm``, ``clip_by_global_norm`` and the
    three schedules at the same tolerance;
  * the reference's substrate properties: convergence on a quadratic,
    master weights that move where bf16 updates cannot, the clip;
  * ``compress._quantize_leaf`` bit-equal to the reference's (round half
    to even included), ``compression_ratio`` and ``init_error_feedback``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as jopt
from repro.optim import compress as jcompress
from repro_torch import optim as topt
from repro_torch.core.vq import VQWeight
from repro_torch.optim import compress as tcompress

torch.set_num_threads(1)
REL = 1e-6


def _tree(rng, dtype=np.float32):
    mk = lambda *s: rng.standard_normal(s).astype(dtype)
    return {"emb": mk(6, 4), "layers": [{"w": mk(4, 5), "g": mk(5)}
                                        for _ in range(2)],
            "head": {"w": mk(4, 3)}}


def _jax(tree):
    """The reference's layout of ``_tree``: the layer list stacked."""
    return {"emb": jnp.asarray(tree["emb"]),
            "layers": {k: jnp.asarray(np.stack([lp[k] for lp in
                                                tree["layers"]]))
                       for k in ("w", "g")},
            "head": {"w": jnp.asarray(tree["head"]["w"])}}


def _torch(tree):
    conv = lambda a: (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                      if a.dtype.name == "bfloat16" else torch.from_numpy(a))
    return {"emb": conv(tree["emb"]),
            "layers": [{k: conv(v) for k, v in lp.items()}
                       for lp in tree["layers"]],
            "head": {"w": conv(tree["head"]["w"])}}


def _close(got, want, rel=REL):
    """Every leaf of a port tree against the reference's stacked tree."""
    g = {"emb": got["emb"], "head": got["head"]["w"],
         **{f"layers.{k}": torch.stack([lp[k] for lp in got["layers"]])
            for k in ("w", "g")}}
    w = {"emb": want["emb"], "head": want["head"]["w"],
         **{f"layers.{k}": want["layers"][k] for k in ("w", "g")}}
    for k in g:
        a = g[k].float().numpy()
        b = np.asarray(w[k], np.float32)
        np.testing.assert_allclose(a, b, rtol=rel, atol=rel * np.abs(b).max(),
                                   err_msg=k)


@pytest.mark.parametrize("use_master,clip", [(False, 1.0), (False, 0.0),
                                             (True, 1.0)])
def test_adamw_equals_reference(use_master, clip):
    rng = np.random.default_rng(0)
    dt = np.dtype(jnp.bfloat16) if use_master else np.float32
    p0 = _tree(rng, dt)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip, use_master=use_master)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp, tp = _jax(p0), _torch(p0)
    jst, tst = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    for step in range(5):
        g = _tree(np.random.default_rng(10 + step))
        g["emb"] *= 3.0  # a global norm above the clip
        scale = 0.5 + 0.1 * step
        jp, jst, jn = jopt.adamw_update(_jax(g), jst, jp, jcfg, scale)
        tp2, tst2, tn = topt.adamw_update(_torch(g), tst, tp, tcfg, scale)
        # new tensors: the step before is untouched
        assert all(a is not b for a, b in zip(topt.float_leaves(tp),
                                              topt.float_leaves(tp2)))
        tp, tst = tp2, tst2
        np.testing.assert_allclose(tn.item(), float(jn), rtol=REL)
    assert int(tst.step) == int(jst.step) == 5
    assert tst.step.dtype == torch.int32
    _close(tp, jp), _close(tst.m, jst.m), _close(tst.v, jst.v)
    if use_master:
        _close(tst.master, jst.master)
        assert tp["emb"].dtype == torch.bfloat16
    else:
        assert tst.master is None


def test_adamw_leaves_vq_and_gradless_leaves():
    vq = VQWeight(idx=torch.zeros((2, 1, 64), dtype=torch.uint8),
                  codebooks=torch.zeros((2, 8, 256)), scale=torch.ones(64),
                  K=8, N=64)
    params = {"vq": vq, "w": torch.ones(3), "frozen": torch.ones(2)}
    cfg = topt.AdamWConfig(lr=0.1)
    st = topt.adamw_init(params, cfg)
    assert st.m["vq"] is None and st.m["w"].shape == (3,)
    new, st2, _ = topt.adamw_update({"vq": None, "w": torch.ones(3),
                                     "frozen": None}, st, params, cfg)
    assert new["vq"] is vq and new["frozen"] is params["frozen"]
    assert st2.m["frozen"] is st.m["frozen"]
    assert not torch.equal(new["w"], params["w"])


def test_sgd_equals_reference():
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    cfg = dict(lr=0.05, momentum=0.9, grad_clip=1.0)
    jp, tp = _jax(p0), _torch(p0)
    jst = jopt.sgd_init(jp, jopt.SGDConfig(**cfg))
    tst = topt.sgd_init(tp, topt.SGDConfig(**cfg))
    for step in range(4):
        g = _tree(np.random.default_rng(20 + step))
        jp, jst, jn = jopt.sgd_update(_jax(g), jst, jp,
                                      jopt.SGDConfig(**cfg), 0.7)
        tp, tst, tn = topt.sgd_update(_torch(g), tst, tp,
                                      topt.SGDConfig(**cfg), 0.7)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=REL)
    _close(tp, jp), _close(tst.mom, jst.mom)
    assert int(tst.step) == 4


def test_global_norm_and_clip_equal_reference():
    g = _tree(np.random.default_rng(2))
    np.testing.assert_allclose(topt.global_norm(_torch(g)).item(),
                               float(jopt.global_norm(_jax(g))), rtol=REL)
    for max_norm in (0.5, 1e3):
        tc, tn = topt.clip_by_global_norm(_torch(g), max_norm)
        jc, jn = jopt.clip_by_global_norm(_jax(g), max_norm)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=REL)
        _close(tc, jc)


@pytest.mark.parametrize("name,kw", [
    ("warmup_cosine", dict(warmup_steps=10, total_steps=100)),
    ("warmup_cosine", dict(warmup_steps=0, total_steps=7, min_ratio=0.2)),
    ("warmup_linear", dict(warmup_steps=10, total_steps=100)),
    ("warmup_linear", dict(warmup_steps=3, total_steps=20, min_ratio=0.3)),
    ("constant", dict()),
])
def test_schedules_equal_reference(name, kw):
    for step in (0, 1, 3, 9, 10, 11, 50, 99, 100, 130):
        want = float(getattr(jopt, name)(step, **kw))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = getattr(topt, name)(arg, **kw)
            assert got.dtype == torch.float32
            assert abs(got.item() - want) <= REL * max(1.0, abs(want)), (
                name, step, got.item(), want)


def test_converges_on_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"x": torch.zeros(3)}
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    opt = topt.adamw_init(params, cfg)
    for _ in range(200):
        grads = {"x": 2 * (params["x"] - target)}
        params, opt, _ = topt.adamw_update(grads, opt, params, cfg)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(), atol=1e-2)


def test_master_weights_beat_bf16_updates():
    """fp32 master copies accumulate updates far below bf16 resolution."""
    params = {"x": torch.ones(8, dtype=torch.bfloat16)}
    cfg = topt.AdamWConfig(lr=1e-5, weight_decay=0.0, grad_clip=0.0,
                           use_master=True)
    opt = topt.adamw_init(params, cfg)
    g = {"x": torch.ones(8)}
    for _ in range(100):
        params, opt, _ = topt.adamw_update(g, opt, params, cfg)
    assert float((opt.master["x"] - 1.0).abs().max()) > 5e-4
    assert torch.isfinite(params["x"].float()).all()
    # without master copies the bf16 param never leaves 1.0
    plain = {"x": torch.ones(8, dtype=torch.bfloat16)}
    pcfg = topt.AdamWConfig(lr=1e-5, weight_decay=0.0, grad_clip=0.0)
    popt = topt.adamw_init(plain, pcfg)
    for _ in range(100):
        plain, popt, _ = topt.adamw_update(g, popt, plain, pcfg)
    assert torch.equal(plain["x"], torch.ones(8, dtype=torch.bfloat16))


def test_grad_clip():
    clipped, norm = topt.clip_by_global_norm({"x": torch.full((4,), 100.0)},
                                             1.0)
    assert norm.item() == pytest.approx(200.0)
    assert torch.linalg.norm(clipped["x"]).item() == pytest.approx(1.0,
                                                                   rel=1e-5)


def test_quantize_leaf_bit_equal():
    rng = np.random.default_rng(3)
    cases = [rng.standard_normal((7, 33)).astype(np.float32) * 3,
             np.zeros((5,), np.float32),
             # exact halves of the scale: round half to even
             (np.arange(-8, 9, dtype=np.float32) + 0.5) * (4.0 / 127.0),
             np.asarray([1e-30, -2e-30, 0.0], np.float32)]
    for g in cases:
        tq, ts = tcompress._quantize_leaf(torch.from_numpy(g))
        jq, js = jcompress._quantize_leaf(jnp.asarray(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == float(js)


def test_compression_ratio_and_error_feedback():
    g = _tree(np.random.default_rng(4))
    flat = {"a": g["emb"], "b": g["head"]["w"]}
    assert topt.compression_ratio({k: torch.from_numpy(v)
                                   for k, v in flat.items()}) == \
        jopt.compression_ratio({k: jnp.asarray(v) for k, v in flat.items()})
    leaves = topt.float_leaves(_torch(g))
    total = sum(x.numel() for x in leaves)
    assert topt.compression_ratio(_torch(g)) == (total + 4 * len(leaves)) / (
        4 * total)
    ef = topt.init_error_feedback(_torch(g))
    assert all(e.dtype == torch.float32 and not e.any()
               for e in topt.float_leaves(ef))
