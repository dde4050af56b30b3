"""Fit the EVA lookup kernels' cost model (``tiles.COST_NS``) on the card.

    PYTHONPATH=src python3 -m repro_torch.kernels.eva_lookup.sweep

Times every launch shape ``tiles.candidates`` offers for
``fused_vq_matmul`` and ``oc_lookup`` at llama2-7b's four decode linears
x M 1/2/3/4/8 (C = 2; CUDA events, median of 10 runs, the L2 flushed and
the stream held busy before each, as ``chip_smoke.py`` times), holds
each against the shape ``lookup_tiles`` picks, and fits the five terms
of ``tiles.cost_terms`` per kernel by least squares to the shapes within
2.5x of their case's fastest. Prints one JSON line per case (the shape
the model picks and its ms, the fastest shape and its ms, the pick under
the fitted terms) and one per kernel (the fitted ``COST_NS`` and the ms
each set of terms loses to the fastest shapes, summed over the cases).
Needs a CUDA device; the kernels are built at first use.
"""
from __future__ import annotations

import json
import statistics

import numpy as np
import torch

from repro_torch.core.vq import synthetic_vq
from repro_torch.kernels import build
from repro_torch.kernels.eva_lookup import tiles
from repro_torch.kernels.vq_gemm import vq_gemm

LINEARS = (("wqkv", 4096, 12288), ("wo", 4096, 4096), ("gu", 4096, 22016),
           ("down", 11008, 4096))
ROWS_M = (1, 2, 3, 4, 8)
C = 2
FIT_WITHIN = 2.5               # shapes fitted: within this factor of the fastest
SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's boost clock


def _median_ms(fn, flush: torch.Tensor, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.bitwise_not_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _launcher(name: str, t: tiles.LookupTiles, x, vq, O):
    """A call of kernel ``name`` with launch shape ``t`` (the wrappers
    pick their own; this bypasses them), returning y."""
    M, N = x.shape[0], vq.N
    y = torch.empty((M, N), dtype=torch.float32, device="cuda")
    ws = (torch.empty((t.groups, M, N), dtype=torch.float32, device="cuda")
          if t.groups > 1 else None)
    if name == "fused_vq_matmul":
        fn = build.bind(name, "fused_vq_matmul_launch", 6, 9)
        ptrs = [x.data_ptr(), vq.codebooks.data_ptr()]
    else:
        fn = build.bind(name, "oc_lookup_launch", 5, 9)
        ptrs = [O.data_ptr()]
    ptrs += [vq.idx.data_ptr(), vq.scale.data_ptr(), y.data_ptr(),
             ws.data_ptr() if ws is not None else None]
    ints = [M, vq.V, N, C, t.bn, t.stages, t.cs, t.groups, t.slabs_per_split]

    def run():
        build.check(fn(*ptrs, *ints, build.stream_of(y)), name)
        return y
    return run


def _pick(rows, cost_ns):
    """The row a set of terms picks (ties as ``lookup_tiles`` breaks them)."""
    return min(rows, key=lambda r: (float(np.dot(cost_ns, r["terms"])),
                                    -r["shape"][0], r["shape"][1] * r["shape"][2]))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sweep: needs a CUDA device")
    build.build_all(("fused_vq_matmul", "oc_lookup", "vq_gemm"))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    sm = build.device_sm_count(torch.cuda.current_device())
    cases = {True: [], False: []}
    for M in ROWS_M:
        for linear, K, N in LINEARS:
            vq = synthetic_vq(gen, K, N, C=C, device="cuda")
            x = torch.randn((M, K), generator=gen, device="cuda")
            X = x.reshape(M, vq.V, vq.d).contiguous()
            O = vq_gemm(x, vq.codebooks)
            for name, recompute in (("fused_vq_matmul", True),
                                    ("oc_lookup", False)):
                slots = tiles.cluster_slots(name, torch.cuda.current_device(),
                                            M, C, recompute)
                picked = tiles.lookup_tiles(M, vq.V, N, C, sm, recompute, slots)
                want = _launcher(name, picked, X, vq, O)().clone()
                rows = []
                for t, waves in tiles.candidates(M, vq.V, N, C, sm, recompute,
                                                 slots):
                    run = _launcher(name, t, X, vq, O)
                    torch.testing.assert_close(
                        run(), want, rtol=0,
                        atol=1e-4 * max(1.0, float(want.abs().max())))
                    rows.append({"shape": (t.bn, t.cs, t.groups,
                                           t.slabs_per_split),
                                 "ms": _median_ms(run, flush),
                                 "terms": tiles.cost_terms(
                                     C, t.mw, t.bn, t.groups,
                                     t.slabs_per_split, waves)})
                shape = (picked.bn, picked.cs, picked.groups,
                         picked.slabs_per_split)
                cases[recompute].append(
                    {"kernel": name, "linear": linear, "M": M, "rows": rows,
                     "picked": next(r for r in rows if r["shape"] == shape)})
            del vq, O
    for recompute, kernel_cases in cases.items():
        A, y = [], []
        for case in kernel_cases:
            fastest = min(r["ms"] for r in case["rows"])
            for r in case["rows"]:
                if r["ms"] <= FIT_WITHIN * fastest:
                    A.append(r["terms"])
                    y.append(r["ms"] * 1e6)
        fitted = np.linalg.lstsq(np.array(A), np.array(y), rcond=None)[0]
        lost = {"model": 0.0, "fitted": 0.0}
        for case in kernel_cases:
            fastest = min(case["rows"], key=lambda r: r["ms"])
            refit = _pick(case["rows"], fitted)
            lost["model"] += case["picked"]["ms"] - fastest["ms"]
            lost["fitted"] += refit["ms"] - fastest["ms"]
            print(json.dumps({
                "kernel": case["kernel"], "linear": case["linear"],
                "M": case["M"], "shapes": len(case["rows"]),
                "picked": case["picked"]["shape"],
                "picked_ms": case["picked"]["ms"],
                "fastest": fastest["shape"], "fastest_ms": fastest["ms"],
                "fitted_pick": refit["shape"], "fitted_pick_ms": refit["ms"]}),
                flush=True)
        print(json.dumps({
            "kernel": kernel_cases[0]["kernel"],
            "cost_terms": tiles.COST_TERMS,
            "cost_ns": tiles.COST_NS[recompute],
            "fitted_cost_ns": [round(float(v), -1) for v in fitted],
            "ms_lost_to_fastest": lost}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
