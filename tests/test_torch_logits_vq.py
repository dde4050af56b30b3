"""Port of the VQ-Logits LM head (``repro_torch/core/logits_vq.py``, the
``vq_logits`` planner kind, ``core.quantize.attach_vq_logits_head``) and
of the k-means it is fitted with (``core.vq.kmeans``), held against the
JAX reference on the same numpy inputs:

  * ``expand`` equals its definition, and the reference's expansion of
    the same head bit for bit;
  * the gather backend equals the dense oracle (and the reference's
    gather) within 1e-6: not bitwise, since the two formulations sum in
    different orders (the reference's own bitwise test fails under jax
    0.9.0, ROADMAP);
  * planner rankings, predicted times (rel 1e-12) and cost terms equal
    to the reference's at decode and prefill shapes;
  * ``attach_vq_logits_head``'s guards, its idempotent re-fit (within
    rtol 1e-4, atol 1e-5), and
    ``fit_logits_vq`` recovering a clustered head (rtol 1e-4, atol
    1e-5); k-means' assignment step bit-equal to the reference's, its
    update within fp32 rounding (rtol 1e-6, atol 1e-6), a clustered set
    recovered exactly;
  * a smoke transformer scoring through the reference's synthetic head,
    converted: logits within 1e-5 of the JAX model's and of the same
    port model with ``{"w": expand(head)}``; the engine's greedy stream
    with ``{"vql"}`` equal to the one with ``{"w": expand}`` and to the
    JAX engine's;
  * ``preplan_params`` plans ``vql`` nodes (fp32 logits) as the
    reference does; ``convert`` carries the head both ways.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import logits_vq as jlvq
from repro.core import plan as jplan
from repro.core import vq as jvq
from repro.models import build_model as jax_build_model
from repro.models.common import RunConfig as JaxRunConfig
from repro.serve import Engine as JaxEngine, EngineConfig as JaxEngineConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params, to_reference_layout
from repro_torch.core import logits_vq as lvq
from repro_torch.core import plan as plan_mod
from repro_torch.core import quantize
from repro_torch.core import vq as tvq
from repro_torch.models import RunConfig, build_model
from repro_torch.models.api import param_tensors
from repro_torch.serve import Engine, EngineConfig

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
PORT_NAME = {"vql_gather_jnp": "vql_gather_torch",
             "vql_dequant_jnp": "vql_dequant_torch"}


def _conv(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _jax_head(d, v, kc, seed=0):
    """The reference's synthetic head and the port's conversion of it."""
    head = jlvq.synthetic_logits_vq(jax.random.PRNGKey(seed), d, v, kc)
    return head, _conv(head)


# ------------------------------------------------------------ the head


def test_expand_matches_definition_and_reference():
    jhead, head = _jax_head(16, 64, 7)
    assert isinstance(head, lvq.VQLogitsHead)
    assert (head.D, head.Kc, head.V) == (16, 7, 64)
    assert head.assign.dtype == torch.int32
    w = lvq.expand(head)
    for v in range(64):
        assert torch.equal(w[:, v],
                           head.scale[v] * head.codebook[:, head.assign[v]])
    assert np.array_equal(w.numpy(), np.asarray(jlvq.expand(jhead)))
    g = torch.Generator().manual_seed(3)
    own = lvq.synthetic_logits_vq(g, 16, 64, 7, dtype=torch.bfloat16)
    assert own.codebook.dtype == torch.bfloat16
    assert own.scale.dtype == torch.float32 and bool((own.scale == 1).all())
    assert int(own.assign.min()) >= 0 and int(own.assign.max()) < 7


def test_gather_equals_dense_oracle_within_tolerance():
    jhead, head = _jax_head(32, 128, 9)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 32)),
                 np.float32)
    spec = lvq.vq_logits_spec(head, M=4, x_dtype=torch.float32,
                              out_dtype=torch.float32)
    policy = plan_mod.PlanPolicy()
    xt = torch.from_numpy(x)
    y_g = lvq._plan_vql_gather(spec, policy).run(xt, head).numpy()
    y_d = lvq._plan_vql_dequant(spec, policy).run(xt, head).numpy()
    y_ref = x @ np.asarray(jlvq.expand(jhead))
    jspec = jlvq.vq_logits_spec(jhead, M=4, x_dtype=jnp.float32,
                                out_dtype=jnp.float32)
    y_jg = np.asarray(jlvq._plan_vql_gather(jspec, jplan.PlanPolicy()).run(
        jnp.asarray(x), jhead))
    for got in (y_g, y_d):
        np.testing.assert_allclose(got, y_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y_g, y_jg, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,D,V,kc", [(1, 64, 512, 16), (4, 4096, 32000, 2048),
                                      (16, 4096, 32000, 2048),
                                      (512, 4096, 32000, 2048),
                                      (4, 32, 128, 128)])
def test_ranking_and_costs_equal_reference(M, D, V, kc, dtype):
    spec = plan_mod.LinearSpec(M=M, K=D, N=V, kind="vq_logits", x_dtype=dtype,
                               out_dtype="float32", k=kc)
    want = jplan.Planner(calibration=None).plan(
        jplan.LinearSpec(M=M, K=D, N=V, kind="vq_logits", x_dtype=dtype,
                         out_dtype="float32", k=kc), jplan.PlanPolicy())
    for impl in ("cuda", "torch"):
        got = plan_mod.Planner(calibration=None).plan(
            spec, plan_mod.PlanPolicy(impl=impl))
        assert got.backend == PORT_NAME[want.backend]
        assert [b for b, _ in got.ranking] == [PORT_NAME[b]
                                               for b, _ in want.ranking]
        assert [u for _, u in got.ranking] == [u for _, u in want.ranking]
        assert got.predicted_us == pytest.approx(want.predicted_us, rel=1e-12)
        assert got.cost.__dict__ == want.cost.__dict__


def test_plan_node_dispatches_the_gather():
    _, head = _jax_head(64, 512, 16)
    x = torch.ones((2, 3, 64))
    pl = plan_mod.plan_node({"vql": head}, x, mode="decode",
                            policy=plan_mod.PlanPolicy(),
                            out_dtype=torch.float32)
    assert pl.spec.kind == "vq_logits" and pl.spec.M == 6 and pl.spec.k == 16
    assert pl.backend == "vql_gather_torch"
    y = pl.execute(x, head)
    assert y.shape == (2, 3, 512) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), (x @ lvq.expand(head)).numpy(),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- k-means and fit


def _clustered(kc, d, v, seed):
    """(w (d, v), directions (kc, d), assignment (v,)): columns along kc
    unit directions with scales in [0.5, 2)."""
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((kc, d)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    assign = rng.integers(0, kc, v)
    scales = rng.uniform(0.5, 2.0, v).astype(np.float32)
    return (dirs[assign] * scales[:, None]).T.copy(), dirs, assign


def test_assign_bit_equal_and_update_equal_reference():
    rng = np.random.default_rng(5)
    points = rng.standard_normal((300, 8)).astype(np.float32)
    cents = rng.standard_normal((16, 8)).astype(np.float32)
    want = np.asarray(jvq._assign(jnp.asarray(points), jnp.asarray(cents)))
    got = tvq._assign(torch.from_numpy(points), torch.from_numpy(cents))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # every centroid keeps points (no random re-seed on either side)
    assign = np.arange(300) % 16
    rng.shuffle(assign)
    want = np.asarray(jvq._update(jnp.asarray(points), jnp.asarray(assign), 16,
                                  KEY))
    got = tvq._update(torch.from_numpy(points),
                      torch.from_numpy(assign.astype(np.int32)), 16,
                      torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # an empty centroid is re-seeded from one of the points
    assign[assign == 3] = 4
    got = tvq._update(torch.from_numpy(points),
                      torch.from_numpy(assign.astype(np.int32)), 16,
                      torch.Generator().manual_seed(0)).numpy()
    assert any(np.array_equal(got[3], p) for p in points)


def test_kmeans_recovers_a_clustered_set():
    _, dirs, assign = _clustered(5, 12, 200, seed=6)
    points = torch.from_numpy(dirs[assign])
    cents, got = tvq.kmeans(torch.Generator().manual_seed(1), points, 5,
                            iters=10)
    got = got.numpy()
    # the same partition, and each centroid its cluster's direction
    for c in range(5):
        members = np.unique(got[assign == c])
        assert members.size == 1
        np.testing.assert_allclose(cents[members[0]].numpy(), dirs[c],
                                   rtol=1e-5, atol=1e-6)


def test_fit_reconstructs_clustered_head():
    w, _, _ = _clustered(4, 16, 64, seed=2)
    head = lvq.fit_logits_vq(torch.Generator().manual_seed(4),
                             torch.from_numpy(w), 4, iters=30)
    assert head.Kc == 4 and head.assign.dtype == torch.int32
    np.testing.assert_allclose(lvq.expand(head).numpy(), w, rtol=1e-4,
                               atol=1e-5)


@pytest.fixture(scope="module")
def smoke():
    """llama2 SMOKE at fp32, dense, the reference's params converted."""
    jcfg = dataclasses.replace(jax_smoke_config("llama2_7b"), dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(KEY)
    cfg = dataclasses.replace(get_smoke_config("llama2_7b"), dtype="float32")
    return {"jm": jm, "jp": jp, "m": build_model(cfg), "tp": _conv(jp),
            "cfg": cfg}


def test_attach_pass_idempotent_and_guarded(smoke):
    params, m = smoke["tp"], smoke["m"]
    q = quantize.attach_vq_logits_head(params, 32)
    head = q["lm_head"]["vql"]
    assert head.Kc == 32 and head.D == m.cfg.d_model
    assert head.V == m.cfg.padded_vocab and "w" in params["lm_head"]
    # idempotent: a re-fit of an attached head starts from its implied
    # dense weight, whose normalized columns are the head's 32 codewords
    again = quantize.attach_vq_logits_head(q, 32)["lm_head"]["vql"]
    np.testing.assert_allclose(lvq.expand(again).numpy(),
                               lvq.expand(head).numpy(), rtol=1e-4, atol=1e-5)
    assert quantize.attach_vq_logits_head(q, 16)["lm_head"]["vql"].Kc == 16
    tied = {k: v for k, v in params.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="lm_head"):
        quantize.attach_vq_logits_head(tied, 8)
    vq_head = dict(params, lm_head={"vq": None})
    with pytest.raises(ValueError, match="weight-VQ"):
        quantize.attach_vq_logits_head(vq_head, 8)
    # a compressed head passes the block quantization untouched
    g = torch.Generator().manual_seed(0)
    qq = m.quantize(q, method="synthetic", generator=g, device="cpu")
    assert qq["lm_head"]["vql"] is head
    assert head.codebook.data_ptr() in {t.data_ptr()
                                        for t in param_tensors(qq)}


# ------------------------------------------------ through the model


def _with_head(params, node):
    out = dict(params)
    out["lm_head"] = node
    return out


def test_smoke_transformer_logits_equal_jax_with_reference_head(smoke):
    cfg = smoke["cfg"]
    jhead = jlvq.synthetic_logits_vq(jax.random.PRNGKey(5), cfg.d_model,
                                     cfg.padded_vocab, 24)
    head = _conv(jhead)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(6), (2, 7), 0,
                                       cfg.vocab_size, jnp.int32))
    want, _ = smoke["jm"].prefill(_with_head(smoke["jp"], {"vql": jhead}),
                                  {"tokens": jnp.asarray(toks)},
                                  JaxRunConfig(mode="prefill", remat=False))
    rc = RunConfig()
    t = torch.from_numpy(toks)
    got, _ = smoke["m"].prefill(_with_head(smoke["tp"], {"vql": head}),
                                {"tokens": t}, rc)
    dense, _ = smoke["m"].prefill(
        _with_head(smoke["tp"], {"w": lvq.expand(head)}), {"tokens": t}, rc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_engine_stream_with_vql_head_equals_dense_and_jax(smoke):
    cfg = smoke["cfg"]
    jhead = jlvq.synthetic_logits_vq(jax.random.PRNGKey(7), cfg.d_model,
                                     cfg.padded_vocab, 24)
    head = _conv(jhead)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 8, 6)]

    def serve(node):
        eng = Engine(smoke["m"], _with_head(smoke["tp"], node),
                     RunConfig(attn_chunk=16),
                     EngineConfig(num_slots=2, max_len=32), device="cpu")
        decode = {pl.backend for path, pl in eng.plans["decode"]
                  if path == ("lm_head",)}
        return eng.generate(prompts, 6), decode

    got, backends = serve({"vql": head})
    assert backends == {"vql_gather_torch"}
    dense, _ = serve({"w": lvq.expand(head)})
    jeng = JaxEngine(smoke["jm"], _with_head(smoke["jp"], {"vql": jhead}),
                     JaxRunConfig(mode="decode", remat=False, attn_chunk=16),
                     JaxEngineConfig(num_slots=2, max_len=32))
    assert got == dense == jeng.generate(prompts, 6)


def test_preplan_covers_vql_nodes_as_reference():
    jhead, head = _jax_head(64, 512, 16)
    want = jplan.preplan_params({"lm_head": {"vql": jhead}},
                                jplan.PlanPolicy(), mode="decode", m=2,
                                act_dtype=jnp.bfloat16)
    got = plan_mod.preplan_params({"lm_head": {"vql": head}},
                                  plan_mod.PlanPolicy(), mode="decode", m=2,
                                  act_dtype=torch.bfloat16)
    assert [p for p, _ in got] == [("lm_head",)] == [p for p, _ in want]
    (_, pl), (_, jpl) = got[0], want[0]
    assert pl.spec.kind == jpl.spec.kind == "vq_logits"
    assert (pl.spec.out_dtype, pl.spec.x_dtype) == ("float32", "bfloat16")
    assert (pl.spec.out_dtype, pl.spec.x_dtype) == (jpl.spec.out_dtype,
                                                    jpl.spec.x_dtype)
    assert pl.backend == PORT_NAME[jpl.backend]


def test_convert_carries_the_head_both_ways():
    jhead, head = _jax_head(16, 64, 7)
    tree = from_jax_params(jax.tree_util.tree_map(
        np.asarray, {"lm_head": {"vql": jhead},
                     "layers": {"g": np.ones((2, 3), np.float32)}}),
        device="cpu")
    assert len(tree["layers"]) == 2
    got = tree["lm_head"]["vql"]
    for f in ("codebook", "assign", "scale"):
        a, b = getattr(got, f), np.asarray(getattr(jhead, f))
        assert str(a.dtype).endswith(b.dtype.name) and np.array_equal(a, b)
    back = to_reference_layout(tree)
    assert back["lm_head"]["vql"] is got
