"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 evabench/run.py --workload qwen2_72b.chat_decode --seed 7 \
        --seconds 40 --trace 0

from the root of a checkout (``BENCHMARK.json`` names the cells). The
seed draws the weights, the prompts and the order of the request sizes;
the same seed gives the same inputs. ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics read from a
traced stretch of ticks after the window. The last line of standard
output is the result, a JSON object; the last lines of standard error
are the numbers the correctness check compared, each beside its limit.

Exit codes: 0 a result was printed (correct or not); 2 no CUDA device or
fewer than the cell asks for; 3 a module of JAX or of the JAX package
was loaded; anything else, a failure of the run. Kernel builds and
caches stay in ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of the program and of its libraries, at fixed paths inside
# the checkout: only the first run in a checkout builds
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "nv_compute_cache"}
# top-level modules that may not be loaded in a run: JAX and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "evabench" / sub)
    sys.path.insert(0, str(HERE))
    from bench.cell import log, run_cell
    from bench.manifest import load

    cell = load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"evabench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    sys.path.insert(1, str(ROOT / "src"))       # the program under test
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    bad = forbidden_modules()
    if bad:
        print(f"evabench: loaded after the window: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["peak_bytes"]}
    if args.trace:
        device["busy_s"] = out.get("busy_s")
        device["window_s"] = out.get("window_s")
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["compared"] = out["compared"]
    log(f"total {time.perf_counter() - T_START:.3f} s")
    for name, v in out["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
