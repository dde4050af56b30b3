"""The port's roofline report (``roofline/analysis.py``) and the dry run's
FC-parameter counts (``launch/dryrun.py``) against the reference's
(``tests/test_roofline.py``'s report cases): ``model_flops`` equal on
its cases, the bottleneck selection with the port's H100 constants, the
step-kind HBM model, the ring model of ``roofline/counting.py`` on the
reference's parser cases, and ``fc_param_counts`` equal, exactly, for
each of the eleven configs.
"""
import os

import pytest

from repro_torch.configs import ARCH_IDS
from repro_torch.roofline.analysis import (
    HBM_BW, LINK_BW, NVLINK_BW, PEAK_FLOPS, RooflineReport, hbm_bytes,
    model_flops)
from repro_torch.roofline.counting import ring_bytes


def _reference_dryrun():
    """``repro.launch.dryrun`` sets XLA_FLAGS (512 host devices) when
    imported; this process keeps its own."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


@pytest.mark.parametrize("case", [
    ("train", 4096, 256, 1e9, None),
    ("decode", 32768, 128, 1e9, 0.25e9),
    ("prefill", 32768, 32, 7e9, None),
    ("decode", 524288, 1, 141e9, 39e9),
])
def test_model_flops_equal_reference(case):
    from repro.roofline.analysis import model_flops as ref_model_flops

    kind, seq, batch, n, active = case
    assert model_flops(None, kind, seq, batch, n, active) \
        == ref_model_flops(None, kind, seq, batch, n, active)


def test_model_flops_reference_cases():
    assert model_flops(None, "train", 4096, 256, 1e9) \
        == 6 * 1e9 * 4096 * 256
    assert model_flops(None, "decode", 32768, 128, 1e9, 0.25e9) \
        == 2 * 0.25e9 * 128


def test_bottleneck_selection():
    r = RooflineReport(
        arch="a", shape="s", mesh="m", chips=256,
        flops_per_device=PEAK_FLOPS,      # 1 s compute
        hbm_bytes_per_device=HBM_BW / 2,  # 0.5 s memory
        collective_bytes_per_device=LINK_BW / 4,
        collective_breakdown={}, argument_bytes=0, output_bytes=0,
        temp_bytes=0, model_flops=PEAK_FLOPS * 256 / 2,
    ).finalize()
    assert r.bottleneck == "compute"
    assert r.t_compute == pytest.approx(1.0)
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.bound_time == pytest.approx(1.0)
    r = RooflineReport(
        arch="a", shape="s", mesh="m", chips=1, flops_per_device=0.0,
        hbm_bytes_per_device=HBM_BW, collective_bytes_per_device=LINK_BW * 2,
        collective_breakdown={}, argument_bytes=0, output_bytes=0,
        temp_bytes=0).finalize()
    assert r.bottleneck == "collective"
    assert r.t_collective == pytest.approx(2.0)


def test_h100_constants():
    assert (PEAK_FLOPS, HBM_BW, LINK_BW, NVLINK_BW) \
        == (989e12, 3.35e12, 50e9, 450e9)


def test_hbm_model_by_step_kind():
    assert hbm_bytes("decode", 10, 4, 100, cache_bytes_per_device=3) == 11
    assert hbm_bytes("decode", 10, 4, 100) == 14
    assert hbm_bytes("prefill", 10, 4, 100) == 114
    assert hbm_bytes("train", 10, 4, 100) == 214


def test_ring_model_reference_cases():
    # tests/test_roofline.py: an 8-way psum of f32[1024]; a 4-way
    # all-gather to f32[64]
    assert int(ring_bytes("all-reduce", 1024 * 4, 8)) \
        == int(2 * 1024 * 4 * 7 / 8)
    assert int(ring_bytes("all-gather", 64 * 4, 4)) == int(64 * 4 * 3 / 4)
    assert ring_bytes("reduce-scatter", 100, 4) == 300
    assert ring_bytes("collective-permute", 100, 2) == 100
    assert ring_bytes("all-reduce", 100, 1) == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fc_param_counts_equal_reference(arch):
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import fc_param_counts
    from repro_torch.models import build_model

    ref = _reference_dryrun()
    want = ref.fc_param_counts(jax_build_model(jax_config(arch)))
    got = fc_param_counts(build_model(get_config(arch)))
    assert got == want
