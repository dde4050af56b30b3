#!/usr/bin/env python3
"""Run `chip_smoke.py`'s `serve` phase once from a given checkout, to
compare two commits on one card.

    python3 tools/ab_serve.py <repo root>

Builds the three kernels `serve` launches from that root's sources,
full-width llama2-7b's weights from the seed, and runs that root's
``chip_smoke.serve_phase("serve")`` (8 greedy requests, 4 slots,
max_len 512, its checks and profiles), then prints one JSON line with
the decode ms a step and the prefill seconds. To compare a parent and a
change on one card, unpack the parent with ``git archive`` into a
directory git ignores (``build/parent``) and run parent, change, change,
parent in one call, each in its own process.
"""
import json
import sys
import time

root = sys.argv[1]
sys.path.insert(0, root + "/src")
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.plan import PlanPolicy  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import RunConfig  # noqa: E402
from repro_torch.serve import EngineConfig  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
build.build_all(("fused_vq_matmul", "flash_decode", "dequant_gemv"))
model, params, prompts = cs.build_weights(torch, "llama2_7b")
out = cs.serve_phase(
    torch, model, params, prompts, "serve",
    RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda")),
    EngineConfig(num_slots=cs.SLOTS, max_len=cs.MAX_LEN),
    ("fused_vq_matmul", "flash_decode", "dequant_gemv"))
m = out["metrics"]
print(json.dumps({"ab": root,
                  "decode_ms_per_step": m["decode_s"] * 1e3 / m["decode_steps"],
                  "prefill_s": m["prefill_s"], "tokens": m["tokens_generated"],
                  "process_s": time.perf_counter() - t0}), flush=True)
