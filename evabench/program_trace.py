"""Run one cell as ``run.py --trace 1`` does, up to the profiler's traced
stretch, with the program-traced stretch (``bench/spans.py``) beside it,
and print what the engine's own tracer reads beside what the profiler
reads.

    python3 evabench/program_trace.py --workload qwen3_0_6b.chat_decode \
        --seed 7 --seconds 51

from the root of a checkout, on a CUDA device. The window and the
profiler's stretch are ``bench.cell.serve_window``'s. Just before the
profiler's stretch and again just after it run three stretches of
``spans.PROGRAM_TRACE_S`` seconds each: tracer off, on (the
program-traced stretch), off. Then two short ones with the tracer on:
one bounds the anchor's error with an event recorded as each readback
returns, the other compares the tracer's placing of each decode tick's
last mark with the readback's copy in the profiler's device trace. No
correctness check runs: ``run.py`` makes it.

The last line of standard output is one JSON object: ``metrics`` (the
cell's per-layer metrics, the program-traced stretch's after the
profiler, by their readers in ``evabench/metrics``),
``metrics_before_profiler``, ``cost`` (tokens/s of the window and of
each stretch; the mean ``engine.step`` span of decode-only ticks against
``engine.decode_step_ms``), ``profiler`` (its busy ms a decode-only tick
and that over ``model.decode_graph_ms``), ``anchor_error_us``,
``profiler_offset_us``, ``gaps_by_span``, ``segment_ms``,
``host_span_ms`` and the profiler's ``breakdown``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402

STRETCH_METRICS = ("device.starved_share", "model.decode_graph_ms",
                   "engine.host_ms_per_tick")
ANCHOR_TICKS = 40


def rate(ticks) -> float:
    """Tokens the ticks returned over their wall time."""
    n = sum(len(t.prefills) + len(t.attended) for t in ticks)
    return n / (ticks[-1].t1 - ticks[0].t0)


def stretches(eng, tick):
    """Tracer off, on (the program-traced stretch), off, each
    ``spans.PROGRAM_TRACE_S``: the tokens/s of each and the traced one's
    spans."""
    from bench import spans

    def off():
        ticks, t_end = [], time.perf_counter() + spans.PROGRAM_TRACE_S
        while not ticks or ticks[-1].t1 < t_end:
            ticks.append(tick())
        return rate(ticks)

    before = off()
    traced = spans.program_trace(eng, tick)
    return {"off_before": before, "on": rate(traced.ticks),
            "off_after": off()}, traced


def anchor_error_us(eng, tick, n: int):
    """How far the tracer's anchor places a tick's last device mark after
    the mark ran, us (quartiles and largest): at each wait span's end an
    event is recorded at once; the device time from the mark to it, less
    the host time from the wait's return to its record, bounds the
    readback's copy and wake-up from above (the new event's own launch
    is in it too)."""
    import torch

    from repro_torch.serve.tracing import OFF, Tracer

    tracer = eng.tracer = Tracer(eng.device)
    probe = torch.cuda.Event(enable_timing=True)
    errs = []
    resolve = tracer._resolve

    def timed(anchor_ns):
        mark, t = tracer._last, time.perf_counter_ns()
        probe.record()
        probe.synchronize()
        errs.append(mark.elapsed_time(probe) * 1e3 - (t - anchor_ns) * 1e-3)
        resolve(anchor_ns)

    tracer._resolve = timed
    try:
        for _ in range(n):
            tick()
    finally:
        eng.tracer = OFF
    q = statistics.quantiles(errs, n=4)
    return {"n": len(errs), "q1": q[0], "median": q[1], "q3": q[2],
            "max": max(errs)}


def profiler_offset_us(eng, tick, n: int):
    """Each decode tick's ``decode.epilogue`` end as the tracer places it
    less the start of the nearest device-to-host copy in the profiler's
    trace (the readback the mark precedes), us: the offset between the
    tracer's clock and the profiler's device timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.tracing import OFF, Tracer

    tracer = eng.tracer = Tracer(eng.device)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                tick()
    finally:
        eng.tracer = OFF
    cuda = torch.autograd.DeviceType.CUDA
    copies = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == cuda and "DtoH" in e.name())
    errs = []
    for r in tracer.records():
        if r["device"] and r["name"] == "decode.epilogue" and copies:
            i = bisect.bisect_left(copies, r["end_ns"])
            near = min(copies[max(i - 1, 0):i + 1],
                       key=lambda c: abs(c - r["end_ns"]))
            errs.append((r["end_ns"] - near) * 1e-3)
    if len(errs) < 4:
        return None
    q = statistics.quantiles(errs, n=4)
    return {"n": len(errs), "q1": q[0], "median": q[1], "q3": q[2],
            "max_abs": max(abs(e) for e in errs)}


def host_span_ms(sp) -> dict:
    """Mean host ms of each span name over its spans in the stretch."""
    per: dict = {}
    for r in sp.records:
        if not r["device"]:
            per.setdefault(r["name"], []).append(
                (r["end_ns"] - r["start_ns"]) * 1e-6)
    return {n: statistics.fmean(v) for n, v in per.items()}


def main(argv=None) -> int:
    args = run.parse(argv)
    for var, sub in run.CACHES.items():
        os.environ[var] = str(run.ROOT / "build" / "evabench" / sub)
    sys.path.insert(1, str(run.ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from bench import cell as cell_mod
    from bench import spans, weights
    from bench.manifest import load, reader
    from bench.port import Served, build_kernels

    cell = load(args.workload)
    w = weights.draw(cell.cfg, args.seed, "cuda")
    build_kernels(cell.workload["kernels"])
    served = Served(cell.cfg, w, cell.workload["engine"], "cuda")
    cell_mod.log(f"{time.perf_counter() - T_START:.3f} s: engine built")
    after = {}
    profile_ticks = cell_mod.profile_ticks

    def profile_then_program(tick, n):
        eng = served.eng
        after["rates_before_profiler"], after["spans_before"] = \
            stretches(eng, tick)
        trace = profile_ticks(tick, n)
        after["rates"], after["spans"] = stretches(eng, tick)
        cell_mod.log(f"stretches {after['rates_before_profiler']} before "
                     f"the profiler, {after['rates']} after")
        after["anchor"] = anchor_error_us(eng, tick, ANCHOR_TICKS)
        after["offset"] = profiler_offset_us(eng, tick, ANCHOR_TICKS)
        return trace

    cell_mod.profile_ticks = profile_then_program
    try:
        r = cell_mod.serve_window(cell, args.seed, args.seconds, True, "cuda",
                                  T_START, served)
    finally:
        cell_mod.profile_ticks = profile_ticks
    r.spans = after["spans"]
    names = [m["name"] for m in cell.per_layer] + list(STRETCH_METRICS) + [
        "output_tok_s"]
    metrics = {n: reader(n)(r) for n in names}
    before = after["spans_before"]
    metrics_before_profiler = {
        "device.starved_share": spans.starved_share(before),
        "model.decode_graph_ms": spans.segment_ms(before, "decode.graph"),
        "engine.host_ms_per_tick": spans.host_ms_per_tick(before)}
    sp = r.spans
    decode_only = {id(t) for t in sp.ticks if not t.prefills and t.attended}
    roots = sp.roots()
    # the stretch's ticks and its engine.step roots are one to one, in order
    step_ms = [(x["end_ns"] - x["start_ns"]) * 1e-6
               for x, t in zip(roots, sp.ticks) if id(t) in decode_only]
    prof_busy = [t.busy() * 1e3 for t in r.trace.ticks
                 if not t.info.prefills and t.info.attended] if r.trace else []
    busy = statistics.fmean(prof_busy) if prof_busy else None
    graph = metrics["model.decode_graph_ms"]
    out = {
        "device": torch.cuda.get_device_name(0),
        "metrics": metrics,
        "metrics_before_profiler": metrics_before_profiler,
        "cost": {"window_tok_s": metrics["output_tok_s"],
                 "stretch_tok_s": after["rates"],
                 "stretch_tok_s_before_profiler":
                     after["rates_before_profiler"],
                 "stretch_ticks": len(sp.ticks),
                 "engine_step_ms_decode_only": (statistics.fmean(step_ms)
                                                if step_ms else None),
                 "engine_decode_step_ms": metrics["engine.decode_step_ms"]},
        "profiler": {"busy_ms_per_decode_tick": busy,
                     "over_decode_graph_ms": (busy / graph
                                              if busy and graph else None)},
        "anchor_error_us": after["anchor"],
        "profiler_offset_us": after["offset"],
        "gaps_by_span": spans.gaps_by_span(sp),
        "segment_ms": {n: spans.segment_ms(sp, n) for n in (
            "decode.graph", "decode.epilogue", "prefill.replay",
            "prefill.insert", "prefill.sample")},
        "host_span_ms": host_span_ms(sp),
        "breakdown": ({"device_ops": r.trace.device_ops,
                       "idle_gaps": r.trace.idle_gaps,
                       "busy_s": r.trace.busy_s, "window_s": r.trace.window_s}
                      if r.trace else None),
    }
    served.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
