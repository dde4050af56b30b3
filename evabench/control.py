"""The correctness check's control on the chip: the plain reference put
in the program's place in fp8 (``bench.judge``), read over the same
prompts and served tokens as the program, and judged against the cell's
own limits as the program is. Each seed is a whole run of the cell at
its own size and load (``--seconds`` of window); the seeds run one after
another in this process. The benchmark's own runs never run the control.

    python3 evabench/control.py --workload qwen3_0_6b.chat_decode \\
        --seeds 11,12,13 --seconds 51

One JSON line a seed on standard output: the seed, the readings, the
program's ``correct`` and, for each precision, its ``correct`` and the
numbers compared beside their limits. Exit code 1 when the fp8 control
came out correct on any seed, or the program did not: the limits then
do not tell the two apart.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from run import CACHES, HERE, ROOT

CONTROL = "fp8"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--precisions", default=CONTROL,
                    help="the reference's precisions beside fp32: fp8 (the "
                         "control), bf16 (a witness)")
    args = ap.parse_args(argv)
    import os

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "evabench" / sub)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT / "src"))
    import torch

    from bench.cell import run_cell
    from bench.manifest import load

    if not torch.cuda.is_available():
        print("evabench: no CUDA device", file=sys.stderr)
        return 2
    cell = load(args.workload)
    precisions = tuple(args.precisions.split(","))
    faults = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, "cuda", t0,
                       precisions)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": out["readings"],
                          "correct": out["correct"],
                          "controls": out["controls"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "run_s": time.perf_counter() - t0}), flush=True)
        if not out["correct"]:
            faults.append(f"seed {seed}: the program came out not correct")
        control = out["controls"].get(CONTROL)
        if CONTROL in precisions and (control is None or control["correct"]):
            faults.append(f"seed {seed}: the {CONTROL} control came out "
                          f"correct: {control}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for f in faults:
        print(f"evabench control: {f}", file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
