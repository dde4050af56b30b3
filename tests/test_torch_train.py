"""Training in the port (``optim``, ``data``, ``launch/steps.py``,
``launch/train.py``, ``runtime/fault_tolerance.py``, remat in the models)
against the JAX reference on the CPU:

  * every family (each ``ARCH_IDS`` SMOKE config at fp32): the train-mode
    loss within 1e-6 relative and every gradient leaf within 1e-4 of its
    leaf's largest magnitude (plus 1e-6 of the largest gradient of the
    model: a few leaves are zero up to rounding, e.g. a cross-attention
    key bias, whose gradient softmax cancels) against
    ``jax.value_and_grad(model.loss)`` on the same params
    (``convert.from_jax_params``) and batch;
  * qwen3-0.6b SMOKE, three steps of ``make_train_step`` against the
    reference's: loss, gnorm and lr_scale (0 at step 0, as
    ``warmup_cosine`` starts) within 1e-5, and m, v and the params after
    the last step (see ``test_three_train_steps_equal_reference`` for
    the tolerances and the near-zero gradients excluded);
  * remat: the same gradients with and without it, bit for bit, in every
    family, the layers recomputed in the backward;
  * ``accum_steps=2`` against one step of the whole batch and against the
    reference's ``accum_steps=2``;
  * ``train``: the synthetic task is learned (the reference's
    ``test_system`` rule), a ``fail_at`` run equals an uninterrupted one
    exactly (losses and final params), ``run_with_restarts`` keeps the
    reference's semantics, and the CLI prints the reference's lines;
  * trained, then fitted (``quantize(method="fit")``), then held to the
    reference's three loss conditions (``tests/test_system.py``).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import DataConfig as JDataConfig, global_batch_at as jbatch_at
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build_model as jax_build_model
from repro.models import common as jcm
from repro.optim import AdamWConfig as JAdamWConfig, adamw_init as jadamw_init
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.data import DataConfig, global_batch_at
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import RunConfig, build_model
from repro_torch.models import common as cm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               float_leaves, map_leaves)
from repro_torch.runtime import run_with_restarts

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
EXTRA = {"whisper": ("frames", 24), "vision": ("image_embeds", 12)}
LOSS_REL = 1e-6
GRAD_REL = 1e-4     # of a leaf's largest gradient
GRAD_FLOOR = 1e-6   # of the model's largest gradient
LR = 1e-2           # of the step comparisons
SMALL_GRAD = 1e-3   # of a leaf's largest: a param not held after the steps
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(KEY)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return jm, jp, build_model(cfg), from_jax_params(_np(jp), device="cpu")


def _batch(cfg, rng, B=2, S=16):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family in EXTRA:
        name, rows = EXTRA[cfg.family]
        batch[name] = rng.standard_normal((B, rows, cfg.d_model)).astype(
            np.float32)
    return batch


def _grads(model, params, batch, rc):
    """(loss, gradient tree) of the port's train-mode loss."""
    live = [x.detach().requires_grad_(True) for x in float_leaves(params)]
    it = iter(live)
    p = map_leaves(lambda x: next(it), params)
    loss = model.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()},
                      rc)
    it = iter(torch.autograd.grad(loss, live))
    return loss.detach(), map_leaves(lambda x: next(it), params)


def _assert_grads_close(got, want):
    """Port gradients against the reference's, converted."""
    g, w = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert g.keys() == w.keys()
    top = max(t.abs().max().item() for t in w.values() if t is not None)
    for k, b in w.items():
        a = g[k]
        tol = GRAD_REL * b.abs().max().item() + GRAD_FLOOR * top
        assert (a - b).abs().max().item() <= tol, (k, tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_equal_reference(arch):
    jm, jp, m, tp = _models(arch)
    batch = _batch(m.cfg, np.random.default_rng(0))
    jl, jg = jax.value_and_grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()},
        jcm.RunConfig(attn_chunk=8)))(jp)
    loss, grads = _grads(m, tp, batch, RunConfig(attn_chunk=8))
    assert abs(loss.item() - float(jl)) <= LOSS_REL * abs(float(jl))
    _assert_grads_close(grads, from_jax_params(_np(jg), device="cpu"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_grads_bit_equal(arch, monkeypatch):
    """``remat`` changes where activations come from, not their values:
    the loss and every gradient bit for bit; with it each layer (group)
    runs again in the backward."""
    m = build_model(dataclasses.replace(get_smoke_config(arch),
                                        dtype="float32"))
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(m.cfg, np.random.default_rng(1))
    calls = []
    wrap = cm.remat_layer

    def counting(fn, rc):
        def run(*a, **kw):
            calls.append(1)
            return fn(*a, **kw)
        return wrap(run, rc)

    monkeypatch.setattr(cm, "remat_layer", counting)
    out = {}
    for remat in (False, True):
        calls.clear()
        out[remat] = _grads(m, params, batch, RunConfig(attn_chunk=8,
                                                        remat=remat))
        out[remat] = out[remat] + (len(calls),)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(float_leaves(out[False][1]), float_leaves(out[True][1])):
        assert torch.equal(a, b)
    assert out[True][2] == 2 * out[False][2] > 0   # recomputed once each


def _jax_steps(jm, jp, dcfg, steps, accum=1, total=10, warmup=2):
    jcfg = JAdamWConfig(lr=LR)
    step = jax.jit(jmake_train_step(jm, jcfg, jcm.RunConfig(attn_chunk=8),
                                    total_steps=total, warmup=warmup,
                                    accum_steps=accum))
    opt, metrics = jadamw_init(jp, jcfg), []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in jbatch_at(dcfg, i).items()}
        jp, opt, met = step(jp, opt, batch)
        metrics.append({k: float(v) for k, v in met.items()})
    return jp, opt, metrics


def _port_steps(m, tp, dcfg, steps, accum=1, total=10, warmup=2):
    cfg = AdamWConfig(lr=LR)
    step = make_train_step(m, cfg, RunConfig(attn_chunk=8), total_steps=total,
                           warmup=warmup, accum_steps=accum)
    opt, metrics = adamw_init(tp, cfg), []
    for i in range(steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in global_batch_at(dcfg, i).items()}
        tp, opt, met = step(tp, opt, batch)
        metrics.append({k: v.item() for k, v in met.items()})
    return tp, opt, metrics


def test_three_train_steps_equal_reference():
    """Three steps of qwen3-0.6b SMOKE (lr 1e-2, warmup 2 of 10): the
    metrics within 1e-5; m within 1e-4 and v within 1e-3 of their leaf's
    largest magnitude; the params within 1e-5 relative and 1e-4 x lr
    absolute wherever the reference's gradient at every step of its
    trajectory is 0 or above SMALL_GRAD of its leaf's largest. Adam's early
    steps move a param by about lr x g / |g| (the ratio of the steps'
    gradients), so an absolute gradient error e (fp32 reassociation)
    moves it by about lr x e / |g|: a gradient near zero, whose sign may
    even flip, moves it by up to 2 lr. Those elements (4.1% of the
    model's, most of them in the head) are not held."""
    jm, jp, m, tp = _models("qwen3_0_6b")
    dcfg = dict(vocab_size=m.cfg.vocab_size, seq_len=16, global_batch=4)
    jp2, jopt, jmet = _jax_steps(jm, jp, JDataConfig(**dcfg), 3)
    tp2, topt, tmet = _port_steps(m, tp, DataConfig(**dcfg), 3)
    assert tmet[0]["lr_scale"] == jmet[0]["lr_scale"] == 0.0
    for a, b in zip(tmet, jmet):
        for k in ("loss", "gnorm", "lr_scale"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (k, a, b)
    assert int(topt.step) == 3
    conv = lambda t: dict(flatten_with_paths(from_jax_params(_np(t),
                                                             device="cpu")))
    for got, want, rel in ((topt.m, jopt.m, 1e-4), (topt.v, jopt.v, 1e-3)):
        g, w = dict(flatten_with_paths(got)), conv(want)
        for k in w:
            tol = rel * w[k].abs().max().item()
            assert (g[k] - w[k]).abs().max().item() <= tol, k
    # the elements whose gradient is near zero at some step of the
    # reference's trajectory
    small, p = {}, jp
    for i in range(3):
        jb = JDataConfig(**dcfg)
        p_next, _, _ = _jax_steps(jm, jp, jb, i) if i else (jp, None, None)
        batch = {k: jnp.asarray(v) for k, v in jbatch_at(jb, i).items()}
        g = conv(jax.grad(lambda q: jm.loss(q, batch, jcm.RunConfig(
            attn_chunk=8)))(p_next))
        for k, t in g.items():
            low = (t != 0) & (t.abs() <= SMALL_GRAD * t.abs().max())
            small[k] = low if k not in small else small[k] | low
    g, w = dict(flatten_with_paths(tp2)), conv(jp2)
    held = total = 0
    for k in w:
        keep = ~small[k]
        held, total = held + int(keep.sum()), total + keep.numel()
        np.testing.assert_allclose(g[k][keep].numpy(), w[k][keep].numpy(),
                                   rtol=1e-5, atol=1e-4 * LR, err_msg=k)
    # 409107 of 426752 held: 11k of the excluded 17.6k are lm_head
    # columns of tokens no label names (softmax gradients ~1/V)
    assert held >= 0.95 * total, (held, total)


def test_accum_steps_equal_whole_batch_and_reference():
    jm, jp, m, tp = _models("qwen3_0_6b")
    dcfg = dict(vocab_size=m.cfg.vocab_size, seq_len=16, global_batch=4)
    one = _port_steps(m, tp, DataConfig(**dcfg), 2)
    two = _port_steps(m, tp, DataConfig(**dcfg), 2, accum=2)
    ref = _jax_steps(jm, jp, JDataConfig(**dcfg), 2, accum=2)
    for a, b, r in zip(one[2], two[2], ref[2]):
        for k in ("loss", "gnorm"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(a[k]), (k, a, b)
            assert abs(r[k] - b[k]) <= 1e-5 * abs(r[k]), (k, r, b)
    for a, b in zip(float_leaves(one[1].m), float_leaves(two[1].m)):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()


def test_adamw_over_the_models_params_leaves_vq_alone():
    """A quantized model's VQWeight nodes carry no optimizer state and
    come out of an update as they went in."""
    m = build_model(get_smoke_config("llama2_7b"))
    gen = torch.Generator().manual_seed(0)
    q = m.quantize(m.init(gen, device="cpu"), method="synthetic",
                   generator=gen, device="cpu")
    st = adamw_init(q, AdamWConfig())
    vq = q["layers"][0]["attn"]["wqkv"]["vq"]
    assert st.m["layers"][0]["attn"]["wqkv"]["vq"] is None
    grads = map_leaves(torch.ones_like, q)
    new, _, _ = adamw_update(grads, st, q, AdamWConfig())
    assert new["layers"][0]["attn"]["wqkv"]["vq"] is vq


COMMON = dict(smoke=True, seq_len=16, global_batch=4, lr=3e-3, log_every=0,
              device="cpu")


def test_train_learns_synthetic_task():
    """The reference's ``test_system`` rule: the first loss above 0.8 ln V,
    the last below 0.6 of the first."""
    out = train("qwen3-0.6b", smoke=True, steps=40, seq_len=32,
                global_batch=8, lr=3e-3, log_every=0, device="cpu")
    losses = [out["losses"][s] for s in sorted(out["losses"])]
    v = get_smoke_config("qwen3-0.6b").vocab_size
    assert losses[0] > 0.8 * np.log(v)
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])


def test_injected_failure_resumes_exactly(tmp_path):
    """A mid-run data failure, restarted from the checkpoint, gives the
    uninterrupted run's losses and final params bit for bit (the
    reference holds the final loss to 1e-5)."""
    ref = train("qwen3-0.6b", steps=10, ckpt_dir=str(tmp_path / "ref"),
                ckpt_every=4, **COMMON)
    out = train("qwen3-0.6b", steps=10, ckpt_dir=str(tmp_path / "ft"),
                ckpt_every=4, fail_at=6, max_restarts=2, **COMMON)
    assert out["restarts"] == 1 and ref["restarts"] == 0
    assert out["losses"] == ref["losses"]
    a, b = (dict(flatten_with_paths(r["params"])) for r in (out, ref))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_restart_driver_semantics():
    calls = []

    def loop(start):
        calls.append(start)
        if len(calls) < 3:
            raise RuntimeError("node lost")
        return 10

    stats = run_with_restarts(loop, max_restarts=5, on_failure=lambda e, n: 5)
    assert stats.restarts == 2 and calls == [0, 5, 5]
    assert stats.failures == ["RuntimeError: node lost"] * 2

    def always(start):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="exceeded"):
        run_with_restarts(always, max_restarts=2)

    class ControllerBug(Exception):
        pass

    def bad_callback(err, n):
        raise ControllerBug("callback exploded")

    with pytest.raises(ControllerBug) as exc_info:
        run_with_restarts(always, max_restarts=5, on_failure=bad_callback)
    assert exc_info.value.__context__ is None   # no implicit chaining

    calls.clear()
    stats = run_with_restarts(lambda s: calls.append(s) or (
        len(calls) < 2 and (_ for _ in ()).throw(RuntimeError("x"))),
        max_restarts=3)
    assert stats.restarts == 1 and stats.last_resume_step == 0
    assert calls == [0, 0]


def test_cli_prints_the_reference_lines(tmp_path):
    # one intra-op thread, as this process: the same sums in the same order
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--steps", "10", "--seq-len", "16", "--device", "cpu",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "5", "--fail-at", "7"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [ln.split()[1] for ln in steps] == ["5", "10"]
    assert all(len(ln.split()) == 6 and ln.split()[2] == "loss"
               and ln.split()[4] == "gnorm" for ln in steps)
    assert lines[-1].startswith("final loss: ")
    assert lines[-1].endswith(" restarts: 1")
    want = train("qwen3-0.6b", steps=10, seq_len=16, log_every=0,
                 device="cpu")["final_loss"]
    assert lines[-1] == f"final loss: {want:.4f} restarts: 1"


def test_trained_then_fitted_model_within_reference_bounds():
    """The reference's ``test_quantize_then_serve_trained_model``: qwen3
    SMOKE at fp32 trained 15 steps (lr 3e-3), fitted to 2-bit VQ, then
    the dense and the EVA losses on the batch of step 99: the VQ loss
    finite, below 1.2 ln V, and not below the dense loss. (The fit's
    k-means draws are the port's own, so the losses are not the
    reference's.)"""
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), dtype="float32")
    m = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = m.init(gen, device="cpu")
    ocfg = AdamWConfig(lr=3e-3)
    opt = adamw_init(params, ocfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=8)
    rc = RunConfig(mode="train", remat=False, attn_chunk=8)
    for step in range(15):
        _, grads = _grads(m, params, global_batch_at(dcfg, step), rc)
        params, opt, _ = adamw_update(grads, opt, params, ocfg)
    qparams = m.quantize(params, method="fit",
                         generator=torch.Generator().manual_seed(1),
                         device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in global_batch_at(dcfg, 99).items()}
    with torch.no_grad():
        dense = m.loss(params, batch, rc).item()
        vq = m.loss(qparams, batch, rc.replace_policy(vq_mode="eva")).item()
    assert np.isfinite(vq)
    assert vq < np.log(cfg.vocab_size) * 1.2
    assert dense <= vq


def test_model_axis_refused_naming_a10():
    """A ``model`` axis of 2, refused until ROADMAP A10's tensor
    parallelism: on a fake 2-rank process group (rank 0; its collectives
    do nothing, so only the structure is held here, the numbers in
    ``tests/test_torch_tensor_parallel.py``) the step takes the params
    as DTensors, rank 0 holding half the vocabulary's rows of ``emb``,
    and returns them so, with a finite loss."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh

    m = build_model(dataclasses.replace(get_smoke_config("qwen3_0_6b"),
                                        dtype="float32"))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        step = make_train_step(m, AdamWConfig(), RunConfig(attn_chunk=8),
                               mesh=make_mesh((1, 2), ("data", "model")))
        whole = m.init(torch.Generator().manual_seed(0), device="cpu")
        params = step.dp.shard_params(whole)
        emb = params["embedding"]["emb"]
        assert isinstance(emb, DTensor)
        assert emb.to_local().shape[0] == m.cfg.padded_vocab // 2
        batch = {k: torch.from_numpy(v) for k, v in global_batch_at(
            DataConfig(vocab_size=m.cfg.vocab_size, seq_len=16,
                       global_batch=2), 0).items()}
        new, _, met = step(params, step.dp.shard_opt(
            whole, adamw_init(whole, AdamWConfig())), batch)
        assert torch.isfinite(met["loss"])
        assert isinstance(new["embedding"]["emb"], DTensor)
    finally:
        dist.destroy_process_group()


def test_valid_dp_sizes_equal_reference():
    from repro.runtime import valid_dp_sizes as jvalid
    from repro_torch.runtime import valid_dp_sizes

    for gb, n, mp in ((256, 512, 16), (8, 4, 1), (12, 8, 2), (7, 6, 3)):
        assert valid_dp_sizes(gb, n, mp) == jvalid(gb, n, mp)


def test_bf16_params_with_master_copies_train():
    """bf16 params (``use_master``): the backward runs through the bf16
    rmsnorm gain and the head's fp32-accumulated product, and the step
    moves the fp32 masters and the bf16 params."""
    m = build_model(get_smoke_config("qwen3_0_6b"))
    params = map_leaves(lambda t: t.to(torch.bfloat16),
                        m.init(torch.Generator().manual_seed(0),
                               device="cpu"))
    cfg = AdamWConfig(lr=1e-2, use_master=True)
    step = make_train_step(m, cfg, RunConfig(attn_chunk=8), total_steps=4,
                           warmup=1)
    opt = adamw_init(params, cfg)
    batch = {k: torch.from_numpy(v) for k, v in global_batch_at(
        DataConfig(vocab_size=m.cfg.vocab_size, seq_len=16, global_batch=2),
        0).items()}
    for _ in range(2):
        new, opt, met = step(params, opt, batch)
    assert np.isfinite(met["loss"].item()) and met["gnorm"].item() > 0
    assert all(t.dtype == torch.bfloat16 for t in float_leaves(new))
    assert all(t.dtype == torch.float32 for t in float_leaves(opt.master))
    assert not torch.equal(new["lm_head"]["w"], params["lm_head"]["w"])


def test_rmsnorm_bf16_gain_backward_equals_its_forward():
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    g = torch.randn(8).to(torch.bfloat16)
    want = cm.rmsnorm({"g": g}, x)
    gg = g.clone().requires_grad_(True)
    got = cm.rmsnorm({"g": gg}, x)
    assert torch.equal(got, want)
    got.float().sum().backward()
    assert gg.grad is not None and torch.isfinite(gg.grad.float()).all()


def test_serving_steps_equal_the_model_calls():
    """``make_prefill_step`` / ``make_decode_step`` /
    ``make_serve_decode_step`` against ``Model.prefill`` / ``decode`` on
    llama2 SMOKE at fp32; the meta-device cache and state specs."""
    from repro_torch.launch import steps
    from repro_torch.serve import api as serve_api

    m = build_model(dataclasses.replace(get_smoke_config("llama2_7b"),
                                        dtype="float32"))
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    rc = RunConfig(attn_chunk=8)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, m.cfg.vocab_size, (2, 8)).astype(np.int32))
    with torch.no_grad():
        last, caches = steps.make_prefill_step(m, rc)(params,
                                                      {"tokens": toks})
        want, _ = m.prefill(params, {"tokens": toks}, rc)
        assert torch.equal(last, want[:, -1:])
        full = m.init_cache(2, 16, device="cpu")
        for name, t in caches["body"].items():
            if name != "len":
                full["body"][name][:, :, :t.shape[2]] = t
        full["body"]["len"][:] = 8
        other = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in full.items()}
        nxt = last[:, 0, :m.cfg.vocab_size].argmax(-1).to(torch.int32)
        pos = torch.full((2,), 8, dtype=torch.int32)
        logits, _ = steps.make_decode_step(m, rc)(params, nxt[:, None],
                                                  pos[:, None], full)
        tok, done, bad, _ = steps.make_serve_decode_step(m, rc)(
            params, other, nxt, pos, [None, None],
            torch.ones(2), torch.zeros(2, dtype=torch.int32), torch.ones(2),
            [True, True], torch.full((2, serve_api.MAX_STOP_IDS), -1,
                                     dtype=torch.int32),
            torch.full((2,), 5, dtype=torch.int32),
            torch.ones(2, dtype=torch.bool), torch.zeros(2))
    assert torch.equal(tok, logits[:, 0, :m.cfg.vocab_size].argmax(-1).to(
        tok.dtype))
    assert not done.any() and not bad.any()
    specs = steps.serve_state_specs(4)
    assert all(t.is_meta and t.shape[0] == 4 for t in specs.values())
    assert specs["stop_ids"].shape == (4, serve_api.MAX_STOP_IDS)
    cs = steps.serve_cache_specs(m, 4, 64)
    assert cs["body"]["k"].is_meta and cs["body"]["k"].shape[1:3] == (4, 64)
    paged = steps.serve_cache_specs(m, 4, 64, paged=True, block_size=16)
    assert "block_table" in paged["body"] and paged["body"]["k"].is_meta
