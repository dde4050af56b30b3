"""Calibrated per-backend cost models for the ranked Planner (the port's
own copy of ``repro/core/calibrate.py``).

``core/plan.py``'s Planner collects every backend whose matcher accepts a
(LinearSpec, PlanPolicy) pair and picks the one with the LOWEST predicted
execution time. The prediction is a four-term linear model over the
plan's analytic ``PlanCost``:

    t_us = overhead_us * launches
         + macs                                  * us_per_mac
         + lookup_adds                           * us_per_add
         + (weight_bytes + intermediate_bytes)   * us_per_byte

The four constants are PER BACKEND. They come from one of two places:

  * calibrated : ``fit_calibration()`` fits them (non-negative least
    squares) from timed ``eva-bench-rows/v1`` rows — each row carries
    ``us_per_call`` and ``derived`` = {backend, macs, lookup_adds,
    weight_bytes, intermediate_bytes, launches} — and
    ``save_calibration()`` persists them as a versioned JSON file.
    ``chip_smoke.py``'s calibration phase times the port's decode
    backends on the card and fits them with this module. Interpret-mode
    rows are excluded from fitting, as in the reference.
  * analytic   : when no calibration is loaded (or a backend has no
    usable entry) the shared ``ANALYTIC`` constants apply — the
    reference's order-of-magnitude rates, kept equal so that both
    packages rank alike; only the ranking they produce matters. The
    provenance is recorded on the MatmulPlan (``describe()`` prints it).

Only the kernels' backends are fitted (``chip_smoke.py`` times
``eva_fused`` and ``eva_split``): a site under ``impl="torch"`` matches
one plain ``eva_*`` epilogue, priced by the analytic constants.

The port keeps its own calibration file, never the reference's
``CALIBRATION.json`` (fitted on a CPU for the JAX backends): the default
path is ``CALIBRATION_TORCH.json`` in the working directory, overridden
by the ``EVA_TORCH_CALIBRATION`` environment variable. No such file is
committed, so a checkout ranks analytically.

CLI — fit a calibration file from a bench-rows file:

    PYTHONPATH=src python -m repro_torch.core.calibrate rows.json \
        -o CALIBRATION_TORCH.json
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

SCHEMA = "eva-calibration/v1"
DEFAULT_PATH = "CALIBRATION_TORCH.json"
ENV_VAR = "EVA_TORCH_CALIBRATION"

# Derived-row fields a bench row must carry to be a calibration sample.
COST_FIELDS = ("macs", "lookup_adds", "weight_bytes")

# Fewest samples a fitted entry needs before the Planner trusts it for
# ranking: the model has 4 free parameters, so an NNLS over fewer rows
# fits its samples perfectly while the constants are arbitrary splits of
# the total. Entries below the floor are still persisted (with their
# honest ``rows`` count); ``Planner._usable_entry`` declines them.
MIN_FIT_ROWS = 4


@dataclasses.dataclass(frozen=True)
class BackendCalibration:
    """Fitted constants of one backend's time model (all microseconds)."""

    overhead_us: float
    us_per_mac: float
    us_per_add: float
    us_per_byte: float
    rows: int = 0                  # samples the fit used (0 = analytic)
    mean_abs_rel_err: float = 0.0  # fit quality over its own samples


# Analytic fallback, equal to the reference's. The byte and launch terms
# make the two-kernel split backend analytically more expensive than the
# fused kernel (it round-trips the (C, M, V, 2^n) output codebook through
# device memory and launches twice); a fitted calibration can flip it.
ANALYTIC = BackendCalibration(
    overhead_us=50.0,      # per kernel launch / dispatch
    us_per_mac=2e-4,
    us_per_add=2e-3,
    us_per_byte=1e-4,
)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """A versioned set of per-backend fitted constants."""

    version: str
    source: str
    backends: Mapping[str, BackendCalibration]

    def get(self, backend: str) -> Optional[BackendCalibration]:
        return self.backends.get(backend)


def predict_us(cost: Any, entry: BackendCalibration) -> float:
    """Predicted execution time (us) of a plan's ``PlanCost`` under one
    backend's constants. ``cost`` is duck-typed (macs / lookup_adds /
    weight_bytes / intermediate_bytes / launches)."""
    return (
        entry.overhead_us * getattr(cost, "launches", 1)
        + cost.macs * entry.us_per_mac
        + cost.lookup_adds * entry.us_per_add
        + (cost.weight_bytes + getattr(cost, "intermediate_bytes", 0))
        * entry.us_per_byte
    )


def _nnls(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Non-negative least squares by greedy column dropping: solve the
    unconstrained lstsq, zero the most-negative coefficient, repeat."""
    active = list(range(A.shape[1]))
    coef = np.zeros(A.shape[1])
    while active:
        sol, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
        if (sol >= 0).all():
            for j, c in zip(active, sol):
                coef[j] = float(c)
            return coef
        active.pop(int(np.argmin(sol)))
    return coef


def _row_features(derived: Mapping[str, Any]) -> np.ndarray:
    return np.array([
        float(derived.get("launches", 1)),
        float(derived["macs"]),
        float(derived["lookup_adds"]),
        float(derived["weight_bytes"]) + float(derived.get("intermediate_bytes", 0)),
    ])


def eligible_rows(doc: Mapping[str, Any]) -> List[Tuple[str, np.ndarray, float]]:
    """(backend, features, us) samples from a bench-rows document: rows
    that carry ``backend`` and every COST_FIELDS entry and timed a real
    (non-interpret, non-failed) execution."""
    out = []
    for row in doc.get("rows", ()):
        derived = row.get("derived") or {}
        if not isinstance(derived, dict):
            continue
        backend = derived.get("backend")
        us = row.get("us_per_call", -1.0)
        if (not backend or us is None or us <= 0
                or derived.get("interpret")
                or any(f not in derived for f in COST_FIELDS)):
            continue
        out.append((str(backend), _row_features(derived), float(us)))
    return out


def fit_calibration(doc: Mapping[str, Any], *, source: str = "<inline>"
                    ) -> Calibration:
    """Fit per-backend constants from an ``eva-bench-rows/v1`` document."""
    by_backend: Dict[str, List[Tuple[np.ndarray, float]]] = {}
    for backend, feat, us in eligible_rows(doc):
        by_backend.setdefault(backend, []).append((feat, us))

    backends: Dict[str, BackendCalibration] = {}
    for backend, samples in sorted(by_backend.items()):
        A = np.stack([f for f, _ in samples])
        y = np.array([t for _, t in samples])
        coef = _nnls(A, y)
        pred = A @ coef
        rel = np.abs(pred - y) / np.maximum(y, 1e-9)
        backends[backend] = BackendCalibration(
            overhead_us=float(coef[0]), us_per_mac=float(coef[1]),
            us_per_add=float(coef[2]), us_per_byte=float(coef[3]),
            rows=len(samples), mean_abs_rel_err=float(rel.mean()),
        )
    return Calibration(version=SCHEMA, source=source, backends=backends)


def fit_calibration_file(bench_path: str) -> Calibration:
    with open(bench_path) as f:
        doc = json.load(f)
    return fit_calibration(doc, source=os.path.basename(bench_path))


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


def save_calibration(calib: Calibration, path: str) -> None:
    doc = {
        "schema": calib.version,
        "source": calib.source,
        "backends": {
            name: dataclasses.asdict(entry)
            for name, entry in sorted(calib.backends.items())
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def load_calibration(path: str) -> Optional[Calibration]:
    """Load a calibration file; None when it is missing, unreadable or of
    another schema (the analytic model then stays in force)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("schema") != SCHEMA:
        return None
    backends = {}
    try:
        for name, entry in doc.get("backends", {}).items():
            backends[name] = BackendCalibration(
                overhead_us=float(entry["overhead_us"]),
                us_per_mac=float(entry["us_per_mac"]),
                us_per_add=float(entry["us_per_add"]),
                us_per_byte=float(entry["us_per_byte"]),
                rows=int(entry.get("rows", 0)),
                mean_abs_rel_err=float(entry.get("mean_abs_rel_err", 0.0)),
            )
    except (KeyError, TypeError, ValueError):
        return None
    return Calibration(version=SCHEMA, source=str(doc.get("source", path)),
                       backends=backends)


def default_calibration_path() -> str:
    return os.environ.get(ENV_VAR, DEFAULT_PATH)


def load_default_calibration() -> Optional[Calibration]:
    return load_calibration(default_calibration_path())


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description=f"Fit {DEFAULT_PATH} from a bench-rows JSON")
    ap.add_argument("bench", help="an eva-bench-rows/v1 JSON file")
    ap.add_argument("-o", "--out", default=DEFAULT_PATH)
    args = ap.parse_args(list(argv) if argv is not None else None)
    calib = fit_calibration_file(args.bench)
    save_calibration(calib, args.out)
    for name, e in sorted(calib.backends.items()):
        print(f"{name:20s} rows={e.rows:2d} overhead={e.overhead_us:10.3f}us "
              f"mac={e.us_per_mac:.3e} add={e.us_per_add:.3e} "
              f"byte={e.us_per_byte:.3e} err={e.mean_abs_rel_err:.1%}")
    print(f"wrote {args.out} ({len(calib.backends)} backends, "
          f"source={calib.source})")


if __name__ == "__main__":
    main()
