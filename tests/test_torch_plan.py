"""Port of the cost-ranked planner (``repro_torch/core/plan.py``): the
reference's TestRankedSelection (tests/test_plan.py) with the backends
named as in the port (``eva_fused_pallas`` -> ``eva_fused``,
``eva_split_pallas`` -> ``eva_split``), and the port's rankings and
predicted times held equal to the reference's on the same specs.

Tolerance: predicted times rel 1e-12 — both sides evaluate the same
integer cost terms with the same float constants. The split plan's
output is held to the dequant oracle at rtol=atol=2e-4, as in the
reference (fp32 reassociation over C*V terms)."""
import numpy as np
import pytest
import torch

from repro_torch.core import calibrate
from repro_torch.core import ops
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import LinearSpec, PlanPolicy
from repro_torch.core.vq import synthetic_vq

torch.set_num_threads(1)
CUDA = PlanPolicy(vq_mode="eva", impl="cuda")
PORT_NAME = {"eva_fused_pallas": "eva_fused", "eva_split_pallas": "eva_split"}


def _mk(K, N, splits, M):
    g = torch.Generator().manual_seed(K * N + M)
    vq = synthetic_vq(g, K, N, C=2, splits=splits, device="cpu")
    x = torch.randn((M, K), generator=g)
    return x, vq


def _spec(x, vq):
    return LinearSpec.for_vq(vq, M=x.numel() // vq.K, x_dtype=x.dtype,
                             out_dtype=torch.float32)


def _entry(overhead, rows=8, mac=0.0, add=0.0, byte=0.0, mod=calibrate):
    return mod.BackendCalibration(overhead_us=overhead, us_per_mac=mac,
                                  us_per_add=add, us_per_byte=byte, rows=rows)


def _calib(fused_overhead, split_overhead, rows=8):
    return calibrate.Calibration(
        version=calibrate.SCHEMA, source="test",
        backends={"eva_fused": _entry(fused_overhead, rows),
                  "eva_split": _entry(split_overhead, rows)})


class TestRankedSelection:
    """Every matching backend is a candidate and the cheapest predicted
    time wins. A decode VQ site is the overlapping registration: the
    fused kernel against the two-kernel split."""

    def test_analytic_fallback_ranks_fused_first(self):
        x, vq = _mk(80, 70, (), 2)
        pl = plan_mod.Planner(calibration=None).plan(_spec(x, vq), CUDA)
        assert pl.backend == "eva_fused" and pl.provenance == "analytic"
        assert [b for b, _ in pl.ranking] == ["eva_fused", "eva_split"]
        us = [u for _, u in pl.ranking]
        assert us == sorted(us) and us[0] < us[1]
        assert "pred=" in pl.describe() and "analytic" in pl.describe()
        assert "eva_split" in pl.describe_ranking()

    @pytest.mark.parametrize("impl", ["cuda", "torch"])
    def test_calibration_flips_choice_to_split(self, impl):
        """Under impl="cuda" the kernels' calibration flips the choice;
        under impl="torch" the one plain epilogue the reference's jnp
        planner picks (here direct) is the only candidate, priced
        analytically whatever the kernels' calibration says."""
        x, vq = _mk(96, 96, (50, 26, 20), 2)  # grouped family too
        planner = plan_mod.Planner(calibration=_calib(1e6, 1.0))
        pl = planner.plan(_spec(x, vq), PlanPolicy(vq_mode="eva", impl=impl))
        if impl == "cuda":
            assert pl.backend == "eva_split"
            assert pl.provenance == calibrate.SCHEMA
            assert [b for b, _ in pl.ranking] == ["eva_split", "eva_fused"]
        else:
            assert pl.backend == "eva_direct"
            assert pl.provenance == "analytic"
            assert [b for b, _ in pl.ranking] == ["eva_direct"]
        got = pl.execute(x, vq)
        ref = ops.dequant_matmul(x, vq, out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-4)

    def test_partial_calibration_never_mixes_models(self):
        x, vq = _mk(80, 70, (), 2)
        partial = calibrate.Calibration(
            version=calibrate.SCHEMA, source="partial",
            backends={"eva_split": _entry(1.0)})
        pl = plan_mod.Planner(calibration=partial).plan(_spec(x, vq), CUDA)
        assert pl.backend == "eva_fused" and pl.provenance == "analytic"

    def test_underfitted_entries_not_trusted_for_ranking(self):
        x, vq = _mk(80, 70, (), 2)
        thin = _calib(1e6, 1.0, rows=calibrate.MIN_FIT_ROWS - 1)
        pl = plan_mod.Planner(calibration=thin).plan(_spec(x, vq), CUDA)
        assert pl.backend == "eva_fused" and pl.provenance == "analytic"

    def test_choice_is_deterministic_across_planners(self):
        x, vq = _mk(80, 70, (), 1)
        for calib in (None, _calib(10.0, 1e6), _calib(1e6, 10.0)):
            pa = plan_mod.Planner(calibration=calib).plan(_spec(x, vq), CUDA)
            pb = plan_mod.Planner(calibration=calib).plan(_spec(x, vq), CUDA)
            assert pa.backend == pb.backend and pa.ranking == pb.ranking

    def test_cache_identity_unchanged_under_calibration_reload(self):
        x, vq = _mk(80, 70, (), 2)
        planner = plan_mod.Planner(calibration=None)
        spec = _spec(x, vq)
        p1 = planner.plan(spec, CUDA)
        assert p1.backend == "eva_fused"
        planner.reload_calibration(_calib(1e6, 1.0))
        assert planner.plan(spec, CUDA) is p1  # identity preserved
        assert planner.cache_info().hits >= 1
        x2, vq2 = _mk(88, 132, (), 2)
        assert planner.plan(_spec(x2, vq2), CUDA).backend == "eva_split"
        planner.cache_clear()
        assert planner.plan(spec, CUDA).backend == "eva_split"

    def test_split_plan_prices_two_launches_and_oc_round_trip(self):
        x, vq = _mk(256, 512, (), 1)
        pl = plan_mod.Planner(calibration=_calib(1e6, 1.0)).plan(
            _spec(x, vq), CUDA)
        assert pl.backend == "eva_split" and pl.cost.launches == 2
        assert pl.cost.intermediate_bytes == 2 * 4 * vq.C * 1 * vq.V * 256
        fused = plan_mod.Planner(calibration=None).plan(_spec(x, vq), CUDA)
        assert fused.cost.launches == 1 and fused.cost.intermediate_bytes == 0

    def test_single_candidate_sites_report_no_ranking(self):
        x, vq = _mk(80, 70, (), 1)
        pl = plan_mod.Planner(calibration=None).plan(
            _spec(x, vq), PlanPolicy(vq_mode="dequant"))
        assert len(pl.ranking) == 1 and pl.describe_ranking() == ""
        assert pl.predicted_us is not None

    def test_first_match_backend_reports_registration_order(self):
        x, vq = _mk(80, 70, (), 1)
        assert plan_mod.first_match_backend(_spec(x, vq), CUDA) == "eva_fused"
        assert plan_mod.first_match_backend(
            _spec(x, vq), PlanPolicy(vq_mode="dequant")) == "dequant"

    def test_no_backend_raises(self):
        x, vq = _mk(80, 70, (), 1)  # an unresolved vq_mode matches nothing
        with pytest.raises(ValueError, match="no registered backend"):
            plan_mod.Planner(calibration=None).plan(_spec(x, vq), PlanPolicy())


# -------------------------------------------------------- the two packages


def _ref_spec(M, K, N, C=2, splits=()):
    from repro.core.plan import LinearSpec as RefSpec

    return RefSpec(M=M, K=K, N=N, kind="vq", x_dtype="bfloat16",
                   out_dtype="bfloat16", C=C, V=K // 8, k=256, d=8,
                   splits=splits)


def _port_spec(M, K, N, C=2, splits=()):
    return LinearSpec(M=M, K=K, N=N, kind="vq", x_dtype="bfloat16",
                      out_dtype="bfloat16", C=C, V=K // 8, k=256, d=8,
                      splits=splits)


def _shared_calibrations():
    """One set of constants under each package's backend names."""
    from repro.core import calibrate as ref_calibrate

    consts = {"eva_fused_pallas": (7.5, 3e-7, 2.5e-6, 4e-6, 16),
              "eva_split_pallas": (3.25, 1e-7, 5e-7, 1.5e-6, 16)}
    build = lambda mod, name: {
        name(b): mod.BackendCalibration(*c[:4], rows=c[4])
        for b, c in consts.items()}
    ref = ref_calibrate.Calibration(ref_calibrate.SCHEMA, "shared",
                                    build(ref_calibrate, lambda b: b))
    port = calibrate.Calibration(calibrate.SCHEMA, "shared",
                                 build(calibrate, PORT_NAME.get))
    return ref, port


SHAPES = [(4, 4096, 12288, 2, (4096, 4096, 4096)), (4, 4096, 4096, 2, ()),
          (4, 4096, 22016, 2, (11008, 11008)), (4, 11008, 4096, 2, ()),
          (1, 80, 70, 1, ()), (8, 296, 100, 4, ())]


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("M,K,N,C,splits", SHAPES)
def test_ranking_and_predicted_us_equal_reference(M, K, N, C, splits,
                                                  calibrated):
    from repro.core import plan as ref_plan

    ref_cal, port_cal = _shared_calibrations() if calibrated else (None, None)
    want = ref_plan.Planner(calibration=ref_cal).plan(
        _ref_spec(M, K, N, C, splits),
        ref_plan.PlanPolicy(vq_mode="eva", impl="pallas", interpret=True))
    got = plan_mod.Planner(calibration=port_cal).plan(
        _port_spec(M, K, N, C, splits), CUDA)
    assert [b for b, _ in got.ranking] == [PORT_NAME[b] for b, _ in want.ranking]
    assert [u for _, u in got.ranking] == [u for _, u in want.ranking]
    assert got.predicted_us == pytest.approx(want.predicted_us, rel=1e-12)
    assert got.provenance == want.provenance
    for field in ("macs", "lookup_adds", "weight_bytes",
                  "intermediate_bytes", "launches"):
        assert getattr(got.cost, field) == getattr(want.cost, field)


@pytest.mark.parametrize("impl,ref_impl,backend,ref_backend", [
    ("torch", "jnp", "kvq_dequant_torch", "kvq_dequant_jnp"),
    ("cuda", "pallas", "kvq_flash_cuda", "kvq_flash_pallas"),
])
def test_kvq_attention_costs_equal_reference(impl, ref_impl, backend,
                                             ref_backend):
    from repro.core import plan as ref_plan

    geo = dict(B=4, S=512, H=32, Hk=32, hd=128, idx_width=64, entries=256)
    want = ref_plan.Planner(calibration=None).plan(
        ref_plan.kvq_attention_spec(**geo, x_dtype="bfloat16",
                                    out_dtype="bfloat16"),
        ref_plan.PlanPolicy(impl=ref_impl, interpret=True))
    got = plan_mod.Planner(calibration=None).plan(
        plan_mod.kvq_attention_spec(**geo, x_dtype=torch.bfloat16,
                                    out_dtype=torch.bfloat16),
        PlanPolicy(impl=impl))
    assert (got.backend, want.backend) == (backend, ref_backend)
    assert got.cost.__dict__ == want.cost.__dict__
    assert got.predicted_us == pytest.approx(want.predicted_us, rel=1e-12)


def test_preplan_params_walks_layer_lists():
    x, vq = _mk(80, 72, (24, 48), 1)
    params = {"layers": [{"attn": {"wqkv": {"vq": vq}}},
                         {"attn": {"wqkv": {"vq": vq}}}],
              "lm_head": {"w": torch.zeros(80, 16)},
              "norm": {"g": torch.ones(80)}}
    planner = plan_mod.Planner(calibration=None)
    dec = plan_mod.preplan_params(params, PlanPolicy(), mode="decode", m=4,
                                  act_dtype=torch.float32, planner=planner)
    assert [(p, pl.backend) for p, pl in dec] == [
        (("layers", 0, "attn", "wqkv"), "eva_fused"),
        (("layers", 1, "attn", "wqkv"), "eva_fused"),
        (("lm_head",), "fp")]
    assert dec[0][1] is dec[1][1]  # one spec, one cached plan
    pre = plan_mod.preplan_prefill_buckets(
        params, PlanPolicy(int8_prefill=True), buckets=(8, 16),
        act_dtype=torch.float32, planner=planner)
    assert sorted(pre) == [8, 16]
    assert [pl.backend for _, pl in pre[16]] == ["dequant", "dequant",
                                                 "int8_cuda"]
    assert pre[16][0][1].spec.M == 16
