"""Port of ``core/calibrate.py`` (tests/test_calibrate.py with the port's
module): NNLS fitting from bench rows, exclusions, versioned persistence
and the analytic fallback; the fit held equal to the reference's on one
rows document; and the port's own calibration file, which is never the
reference's ``CALIBRATION.json``.

Tolerance: fitted constants rel 1e-12 against the reference — the same
numpy least squares on the same rows."""
import json

import numpy as np
import pytest

from repro_torch.core import calibrate


def _row(backend, us, *, macs=1000, adds=2000, bytes_=3000, extra=None):
    derived = {"plan": f"{backend} M=1 K=8 N=8", "backend": backend,
               "macs": macs, "lookup_adds": adds, "weight_bytes": bytes_}
    derived.update(extra or {})
    return {"module": "measured", "name": f"measured/{backend}",
            "derived": derived, "us_per_call": us}


def _doc(rows):
    return {"schema": "eva-bench-rows/v1", "rows": rows}


def _cost(macs, adds, b, inter=0, launches=1):
    return type("C", (), dict(macs=macs, lookup_adds=adds, weight_bytes=b,
                              intermediate_bytes=inter, launches=launches))()


def _random_doc(seed=0, n=8):
    """Rows of two backends timed from known constants plus noise, with
    the split backend's intermediate bytes and two launches."""
    rng = np.random.default_rng(seed)
    rows = []
    for backend, launches, true in (
            ("eva_fused", 1, (12.0, 2e-7, 3e-6, 5e-6)),
            ("eva_split", 2, (6.0, 1e-7, 1e-6, 2e-6))):
        for _ in range(n):
            macs, adds, b = (int(v) for v in rng.integers(10_000, 5_000_000, 3))
            inter = 0 if launches == 1 else int(rng.integers(10_000, 5_000_000))
            us = (true[0] * launches + macs * true[1] + adds * true[2]
                  + (b + inter) * true[3]) * rng.uniform(0.9, 1.1)
            rows.append(_row(backend, us, macs=macs, adds=adds, bytes_=b,
                             extra={"intermediate_bytes": inter,
                                    "launches": launches}))
    return _doc(rows)


class TestFit:
    def test_recovers_linear_model(self):
        true = calibrate.BackendCalibration(
            overhead_us=40.0, us_per_mac=1e-4, us_per_add=5e-4,
            us_per_byte=2e-5)
        rng = np.random.default_rng(0)
        rows, samples = [], []
        for _ in range(8):
            macs, adds, b = (int(v) for v in rng.integers(10_000, 5_000_000, 3))
            us = calibrate.predict_us(_cost(macs, adds, b), true)
            rows.append(_row("eva_fused", us, macs=macs, adds=adds, bytes_=b))
            samples.append((macs, adds, b, us))
        entry = calibrate.fit_calibration(_doc(rows)).get("eva_fused")
        assert entry is not None and entry.rows == 8
        assert entry.mean_abs_rel_err < 0.01
        for macs, adds, b, us in samples:
            assert calibrate.predict_us(_cost(macs, adds, b), entry) == \
                pytest.approx(us, rel=0.02)

    def test_interpret_failed_and_incomplete_rows_excluded(self):
        bad = _row("eva_split", 50.0)
        del bad["derived"]["macs"]
        rows = [_row("eva_fused", 999.0, extra={"interpret": 1}),
                _row("dequant", -1.0), bad, _row("fp", 100.0)]
        calib = calibrate.fit_calibration(_doc(rows))
        assert set(calib.backends) == {"fp"}

    def test_nonnegative_coefficients(self):
        rows = [_row("dequant", 100.0, macs=10_000, adds=10, bytes_=10),
                _row("dequant", 50.0, macs=20_000, adds=10, bytes_=10)]
        entry = calibrate.fit_calibration(_doc(rows)).get("dequant")
        for f in ("overhead_us", "us_per_mac", "us_per_add", "us_per_byte"):
            assert getattr(entry, f) >= 0.0

    def test_fit_equals_reference(self):
        from repro.core import calibrate as ref_calibrate

        doc = _random_doc()
        want = ref_calibrate.fit_calibration(doc, source="rows.json")
        got = calibrate.fit_calibration(doc, source="rows.json")
        assert set(got.backends) == set(want.backends) == {"eva_fused",
                                                           "eva_split"}
        for name, w in want.backends.items():
            g = got.get(name)
            assert g.rows == w.rows >= calibrate.MIN_FIT_ROWS
            for f in ("overhead_us", "us_per_mac", "us_per_add",
                      "us_per_byte", "mean_abs_rel_err"):
                assert getattr(g, f) == pytest.approx(getattr(w, f),
                                                      rel=1e-12, abs=0.0)


class TestPersistence:
    def test_roundtrip_and_cli(self, tmp_path, capsys):
        bench = tmp_path / "rows.json"
        bench.write_text(json.dumps(_random_doc()))
        out = str(tmp_path / "fit.json")
        calibrate.main([str(bench), "-o", out])
        assert "eva_split" in capsys.readouterr().out
        loaded = calibrate.load_calibration(out)
        assert loaded is not None and loaded.version == calibrate.SCHEMA
        assert loaded.source == "rows.json"
        assert loaded.backends == calibrate.fit_calibration_file(
            str(bench)).backends

    def test_version_mismatch_missing_or_garbage_returns_none(self, tmp_path):
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"schema": "eva-calibration/v0",
                                    "backends": {}}))
        assert calibrate.load_calibration(str(path)) is None
        assert calibrate.load_calibration(str(tmp_path / "nope.json")) is None
        path.write_text("{not json")
        assert calibrate.load_calibration(str(path)) is None

    def test_default_file_is_the_ports_own(self, tmp_path, monkeypatch):
        """The reference's CALIBRATION.json and $EVA_CALIBRATION are never
        read; CALIBRATION_TORCH.json in the working directory and
        $EVA_TORCH_CALIBRATION are."""
        ref = calibrate.Calibration(calibrate.SCHEMA, "reference", {})
        monkeypatch.chdir(tmp_path)
        monkeypatch.delenv(calibrate.ENV_VAR, raising=False)
        calibrate.save_calibration(ref, "CALIBRATION.json")
        calibrate.save_calibration(ref, "ref_env.json")
        monkeypatch.setenv("EVA_CALIBRATION", "ref_env.json")
        assert calibrate.load_default_calibration() is None
        calibrate.save_calibration(
            calibrate.Calibration(calibrate.SCHEMA, "port", {}),
            "CALIBRATION_TORCH.json")
        assert calibrate.load_default_calibration().source == "port"
        calibrate.save_calibration(
            calibrate.Calibration(calibrate.SCHEMA, "port-env", {}), "alt.json")
        monkeypatch.setenv("EVA_TORCH_CALIBRATION", "alt.json")
        assert calibrate.default_calibration_path() == "alt.json"
        assert calibrate.load_default_calibration().source == "port-env"


class TestPredict:
    def test_terms_priced_independently(self):
        entry = calibrate.BackendCalibration(
            overhead_us=10.0, us_per_mac=1.0, us_per_add=2.0, us_per_byte=3.0)
        assert calibrate.predict_us(_cost(5, 7, 11, 13, 2), entry) == \
            pytest.approx(10 * 2 + 5 * 1 + 7 * 2 + (11 + 13) * 3)

    def test_analytic_equals_reference_and_prefers_fused_shape(self):
        from repro.core import calibrate as ref_calibrate

        assert calibrate.ANALYTIC.__dict__ == ref_calibrate.ANALYTIC.__dict__
        assert calibrate.MIN_FIT_ROWS == ref_calibrate.MIN_FIT_ROWS
        fused = _cost(1000, 1000, 1000)
        split = _cost(1000, 1000, 1000, 8000, 2)
        assert calibrate.predict_us(fused, calibrate.ANALYTIC) < \
            calibrate.predict_us(split, calibrate.ANALYTIC)
