"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), then the correctness check on the freed device."""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from bench import judge, weights
from bench.loop import Clients, Stream, Tick
from bench.manifest import Cell, reader
from bench.trace import Trace, profile_ticks
from bench.traffic import ClosedLoop, prompt_lengths


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``evabench/metrics/<name>.py``)."""

    cell: Cell
    setup_s: float
    peak_bytes: int
    t_open: float
    t_close: float
    streams: List[Stream]
    ticks: List[Tick]            # the window's ticks
    counters_open: Dict[str, float]
    counters_close: Dict[str, float]
    trace: Optional[Trace] = None
    finished: List[Stream] = dataclasses.field(default_factory=list)

    @property
    def cfg(self) -> Dict:
        return self.cell.cfg


def log(msg: str) -> None:
    print(f"[evabench] {msg}", file=sys.stderr, flush=True)


def serve_window(cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, served) -> Run:
    """Warm the cell's buckets, fill every slot, then serve the window
    (and the traced stretch): the program's side of a run."""
    import torch

    loop = ClosedLoop(cell.traffic, cell.cfg["vocab_size"], seed)
    clients = Clients(served, loop)
    buckets = served.warm(prompt_lengths(cell.traffic))
    log(f"{time.perf_counter() - t_start:.3f} s: warmed prefill buckets "
        f"{buckets}")
    clients.start()
    fill = clients.run_until(lambda t: clients.filled())
    sync(torch, device)
    # what set-up made stays: the collector leaves it out of its scans
    gc.collect()
    gc.freeze()
    t_open = fill.t1
    n_fill = len(clients.ticks)
    counters_open = served.counters()
    setup_s = t_open - t_start
    log(f"set-up {setup_s:.3f} s ({n_fill} ticks to fill the slots)")
    last = clients.run_until(lambda t: t.t1 >= t_open + seconds)
    counters_close = served.counters()
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    run = Run(cell, setup_s, peak, t_open, last.t1,
              list(clients.streams.values()), clients.ticks[n_fill:],
              counters_open, counters_close)
    log(f"window {run.t_close - t_open:.3f} s, {len(run.ticks)} ticks")
    if trace:
        t0 = time.perf_counter()
        run.trace = profile_ticks(clients.tick, cell.workload["trace_ticks"])
        log(f"traced {cell.workload['trace_ticks']} ticks, read in "
            f"{time.perf_counter() - t0:.3f} s")
        if run.trace is not None:
            log("fused_vq_matmul launches a tick: " + str(
                [t.count("fused_vq_matmul") for t in run.trace.ticks]))
    run.streams = list(clients.streams.values())
    run.finished = clients.finished_in(t_open, run.t_close)
    return run


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, precisions: Tuple[str, ...] = ()
             ) -> Dict[str, Any]:
    """A whole run. Returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``breakdown``, ``compared``),
    the correctness check's ``readings``, with those of the reference in
    ``precisions`` beside the program's, and ``controls``: each of those
    precisions' ``correct`` and numbers compared against the cell's
    limits (``bench.judge``)."""
    import torch

    from bench.port import Served, build_kernels

    log(f"{time.perf_counter() - t_start:.3f} s: imports done")
    w = weights.draw(cell.cfg, seed, device)
    sync(torch, device)
    log(f"{time.perf_counter() - t_start:.3f} s: weights drawn, "
        f"{weights.nbytes(w) / 2 ** 30:.3f} GiB")
    if torch.device(device).type == "cuda":
        # a figure of its own in the log; it stays in set-up, as the
        # compiling first run of a checkout is set-up too
        build_s = build_kernels(cell.workload["kernels"])
        log(f"{time.perf_counter() - t_start:.3f} s: kernels "
            f"{cell.workload['kernels']} built or found in {build_s:.3f} s")
    served = Served(cell.cfg, w, cell.workload["engine"], device)
    log(f"{time.perf_counter() - t_start:.3f} s: engine built")
    run = serve_window(cell, seed, seconds, trace, device, t_start, served)
    # the program's state goes before the reference runs
    served.close()
    del served
    gc.unfreeze()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    finished = run.finished
    failed = [s for s in finished if s.finish != "length"]
    short = sum(1 for s in finished if len(s.tokens) != s.max_new)
    sample = judge.pick([s for s in finished if s.finish == "length"],
                        cell.workload["judge"]["sample"], seed)
    t0 = time.perf_counter()
    reading = (judge.readings(cell.config, w, sample, device, precisions)
               if sample else None)
    sync(torch, device)
    log(f"reference over {len(sample)} requests in "
        f"{time.perf_counter() - t0:.3f} s: {reading}")
    compared = judge.verdict(reading, cell.workload["judge"]["limits"], short)
    correct = judge.passed(compared, 0 if reading is None
                           else reading["tokens_compared"]) and not failed

    chosen = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in chosen:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": len(finished),
           "failed": len(failed), "metrics": metrics,
           "peak_bytes": run.peak_bytes, "compared": compared}
    if trace and run.trace is not None:
        out["busy_s"], out["window_s"] = run.trace.busy_s, run.trace.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                            "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    out["readings"] = reading
    # each precision of the reference read in the program's place, judged
    # as the program is
    out["controls"] = ({} if reading is None else
                       {p: v for p, v in judge.judge_all(
                           reading, cell.workload["judge"]["limits"],
                           short).items() if p != "served"})
    return out
