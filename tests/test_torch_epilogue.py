"""Port of the plain EVA formulations (``core/ops.py``: the four
epilogues, ``select_epilogue`` and the block sizers, ``eva_matmul`` /
``vq_matmul``) and their plan backends (``core/plan.py``: ``eva_direct``
| ``eva_flat`` | ``eva_blocked`` | ``eva_recon`` under ``impl="torch"``,
``plan_vq``, ``PlanPolicy``'s epilogue and block_v), held against the
JAX reference (``impl="jnp"``) on the same synthetic VQ weights and
inputs: outputs within fp32 reassociation (rtol = atol = 1e-5: both sum
the same gathered products in another order), the same backend and
resolved config, the same selections and the same validation errors.
Under ``impl="cuda"`` every decode and prefill site of every smoke
config keeps the backend it had before these backends were added."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS
from repro.core import ops as jops
from repro.core import plan as jplan
from repro.core import vq as jvq
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import ops
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import PlanPolicy
from repro_torch.models import build_model

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)

# (K, N, splits): odd V (K=80 -> V=10, K=88 -> V=11), N that pad against
# the block sizes below, one grouped family with odd member widths
SHAPES = [(80, 70, ()), (88, 132, ()), (96, 96, (50, 26, 20))]
EPILOGUE_ARGS = [
    ("direct", "auto"), ("flat", "auto"), ("blocked", 4), ("blocked", 8),
    ("blocked", 32), ("blocked", "auto"), ("recon", 4), ("recon", "auto"),
    ("auto", "auto"),
]


def _mk(K, N, splits, M):
    jv = jvq.synthetic_vq(KEY, K, N, d=8, n=8, C=2, splits=splits)
    jv = dataclasses.replace(jv, scale=jax.random.uniform(
        KEY, (N,), minval=0.5, maxval=1.5))
    x = np.array(jax.random.normal(jax.random.fold_in(KEY, K * N + M),
                                    (M, K), jnp.float32))
    vq = from_jax_params(jax.tree_util.tree_map(np.asarray, jv),
                         device="cpu")
    return x, jv, vq


@pytest.mark.parametrize("K,N,splits", SHAPES)
@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("epilogue,block_v", EPILOGUE_ARGS)
def test_eva_matmul_equals_reference(K, N, splits, M, epilogue, block_v):
    x, jv, vq = _mk(K, N, splits, M)
    want = jops.eva_matmul(jnp.asarray(x), jv, epilogue=epilogue,
                           block_v=block_v, out_dtype=jnp.float32)
    got = ops.eva_matmul(torch.from_numpy(x), vq, epilogue=epilogue,
                         block_v=block_v, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jpol = jplan.PlanPolicy(vq_mode="eva", impl="jnp", epilogue=epilogue,
                            block_v=None if block_v == "auto" else block_v)
    pol = PlanPolicy(vq_mode="eva", impl="torch", epilogue=epilogue,
                     block_v=None if block_v == "auto" else block_v)
    jpl = jplan.plan_vq(jnp.asarray(x), jv, jpol)
    pl = plan_mod.plan_vq(torch.from_numpy(x), vq, pol)
    assert (pl.backend, pl.config) == (jpl.backend, jpl.config)
    for f in ("macs", "lookup_adds", "weight_bytes", "launches"):
        assert getattr(pl.cost, f) == getattr(jpl.cost, f)


@pytest.mark.parametrize("kind", ops.EPILOGUES)
def test_epilogue_exec_matches_dequant_oracle_with_leading_dims(kind):
    """(2, 3, K) activations, bf16 out: each formulation against the
    dequantized weight."""
    x, _, vq = _mk(96, 96, (50, 26, 20), 6)
    xt = torch.from_numpy(x).reshape(2, 3, 96)
    got = ops.eva_epilogue_exec(xt, vq, kind=kind, block_v=4,
                                out_dtype=torch.float32)
    want = ops.dequant_matmul(xt, vq, out_dtype=torch.float32)
    assert got.shape == (2, 3, 96)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    half = ops.eva_epilogue_exec(xt, vq, kind=kind, block_v=4,
                                 out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16


def test_compute_output_codebook_equals_reference():
    x, jv, vq = _mk(88, 132, (), 5)
    np.testing.assert_allclose(
        ops.compute_output_codebook(torch.from_numpy(x), vq).numpy(),
        np.asarray(jops.compute_output_codebook(jnp.asarray(x), jv)), **TOL)
    with pytest.raises(ValueError, match="unknown epilogue kind"):
        ops.eva_epilogue_exec(torch.from_numpy(x), vq, kind="scan")


@pytest.mark.parametrize("M", [1, 2, 4, 7, 8, 12, 16, 64])
def test_select_epilogue_sweep_equals_reference(M):
    for V in (8, 10, 512, 1376, 2048):
        for N in (64, 4096, 11008, 12288, 22016, 44032):
            for C, d in ((2, 8), (1, 8), (4, 4)):
                args = (M, V, N, C, 256, d)
                assert ops.select_epilogue(*args) == \
                    jops.select_epilogue(*args), args
                assert ops.auto_block_v(M, V, N, C) == \
                    jops.auto_block_v(M, V, N, C)
                assert ops.auto_recon_block_v(V, N, d) == \
                    jops.auto_recon_block_v(V, N, d)
                assert ops.epilogue_gather_bytes(M, V, N, C) == \
                    jops.epilogue_gather_bytes(M, V, N, C)


def test_cache_constants_equal_reference():
    for name in ("EPILOGUES", "EPILOGUE_CACHE_BYTES", "EPILOGUE_SLAB_BYTES",
                 "RECON_SLAB_BYTES", "_MIN_BLOCK_V"):
        assert getattr(ops, name) == getattr(jops, name), name


@pytest.mark.parametrize("kw", [
    {"epilogue": "bogus"}, {"block_v": True}, {"block_v": 0},
    {"block_v": -3}, {"block_v": "8"}, {"block_v": 2.0},
    {"epilogue": "direct", "block_v": 8}, {"epilogue": "auto", "block_v": 8},
    {"epilogue": "flat", "block_v": 8},
])
def test_policy_validation_errors_equal_reference(kw):
    with pytest.raises(ValueError) as want:
        jplan.PlanPolicy(vq_mode="eva", impl="jnp", **kw)
    with pytest.raises(ValueError) as got:
        PlanPolicy(vq_mode="eva", impl="torch", **kw)
    assert str(got.value) == str(want.value).replace("'jnp'", "'torch'")


def test_policies_both_accept():
    """block_v with the v-blocked epilogues, with dequant (no epilogue)
    and under the kernels' impl."""
    for kw in ({"epilogue": "blocked", "block_v": 8},
               {"epilogue": "recon", "block_v": 8},
               {"vq_mode": "dequant", "block_v": 8}):
        full = {"vq_mode": "eva", **kw}
        jplan.PlanPolicy(impl="jnp", **full)
        PlanPolicy(impl="torch", **full)
    jplan.PlanPolicy(vq_mode="eva", impl="pallas", block_v=8)
    PlanPolicy(vq_mode="eva", impl="cuda", block_v=8)


def test_wrapper_surface_equals_reference():
    x, jv, vq = _mk(80, 70, (), 3)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ref = ops.dequant_matmul(xt, vq, out_dtype=torch.float32)
    # a bare int block_v selects the v-blocked gather; defaults are auto
    for kw in ({"block_v": 5}, {}):
        got = ops.eva_matmul(xt, vq, out_dtype=torch.float32, **kw)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    assert ops._eva_policy_args(None, 5, "torch") == \
        jops._eva_policy_args(None, 5, "jnp") == ("blocked", 5)
    assert ops._eva_policy_args(None, 5, "cuda") == \
        jops._eva_policy_args(None, 5, "pallas") == ("auto", 5)
    for mod, arr in ((ops, xt), (jops, xj)):
        with pytest.raises(ValueError, match="removed"):
            mod.eva_matmul(arr, vq if mod is ops else jv, block_v=None)
        with pytest.raises(ValueError, match="unknown vq matmul mode"):
            mod.vq_matmul(arr, vq if mod is ops else jv, mode="int4")
    for mode in ("eva", "dequant"):
        got = ops.vq_matmul(xt, vq, mode=mode, out_dtype=torch.float32)
        want = jops.vq_matmul(xj, jv, mode=mode, out_dtype=jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cuda_impl_runs_the_kernels_backends():
    """``impl="cuda"``: the kernels' backends only (on CPU tensors their
    wrappers' plain versions), and a plain epilogue request is refused,
    as the reference refuses one under ``impl="pallas"``."""
    x, _, vq = _mk(96, 96, (50, 26, 20), 4)
    xt = torch.from_numpy(x)
    pl = plan_mod.Planner(calibration=None).plan(
        plan_mod.LinearSpec.for_vq(vq, M=4, x_dtype=torch.float32,
                                   out_dtype=torch.float32),
        PlanPolicy(vq_mode="eva", impl="cuda"))
    assert [b for b, _ in pl.ranking] == ["eva_fused", "eva_split"]
    np.testing.assert_allclose(
        ops.eva_matmul(xt, vq, impl="cuda", out_dtype=torch.float32).numpy(),
        ops.eva_matmul(xt, vq, out_dtype=torch.float32).numpy(), **TOL)
    with pytest.raises(ValueError, match="does not apply"):
        ops.eva_matmul(xt, vq, impl="cuda", epilogue="direct")


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_cuda_sites_keep_their_backends(arch):
    """Every VQ site of every smoke config: ``eva_fused`` in decode,
    ``dequant`` in prefill, dense sites ``fp`` (``int8_cuda`` under INT8
    prefill), ranked analytically, as before the plain epilogues were
    registered; under ``impl="torch"`` each decode VQ site is the plain
    epilogue ``select_epilogue`` names."""
    cfg = get_smoke_config(arch)
    params = build_model(cfg).param_specs(quantized=True)
    planner = plan_mod.Planner(calibration=None)
    dt = cfg.act_dtype
    for int8 in (False, True):
        pol = PlanPolicy(int8_prefill=int8)
        dec = plan_mod.preplan_params(params, pol, mode="decode", m=4,
                                      act_dtype=dt, planner=planner)
        pre = plan_mod.preplan_params(params, pol, mode="prefill", m=64,
                                      act_dtype=dt, planner=planner)
        for path, pl in dec:
            if pl.spec.kind == "vq":
                assert pl.backend == "eva_fused", path
                assert [b for b, _ in pl.ranking] == ["eva_fused",
                                                      "eva_split"]
        for path, pl in pre:
            if pl.spec.kind == "vq":
                assert pl.backend == "dequant", path
            elif pl.spec.kind in ("dense", "int8"):
                assert pl.backend == ("int8_cuda" if int8 else "fp"), path
    plain = plan_mod.preplan_params(params, PlanPolicy(impl="torch"),
                                    mode="decode", m=4, act_dtype=dt,
                                    planner=planner)
    for path, pl in plain:
        if pl.spec.kind == "vq":
            s = pl.spec
            kind = ops.select_epilogue(s.M, s.V, s.N, s.C, s.k, s.d)[0]
            assert pl.backend == f"eva_{kind}", path
