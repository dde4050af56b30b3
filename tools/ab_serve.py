#!/usr/bin/env python3
"""Time one checkout's serving path, to compare two commits on one card.

    python3 tools/ab_serve.py <repo root>
    python3 tools/ab_serve.py <repo root> --decode-step <arch> <layers>

Builds the kernels from that root's sources and loads that root's
``chip_smoke``. With no option it runs ``chip_smoke.serve_phase("serve")``
on full-width llama2-7b's weights from the seed (8 greedy requests, 4
slots, max_len 512, its checks and profiles) and prints one JSON line
with the decode ms a step and the prefill seconds.

With ``--decode-step`` it builds ``arch`` at full width cut to ``layers``
layers (2-bit VQ weights from the seed), an engine of 4 slots and
max_len 512, writes a prefill of 64 random tokens into every slot of its
cache, profiles its captured decode step three times
(``chip_smoke.device_profile``, 20 replays each) and prints one JSON
line: the device-busy ms a step of each profile, the kernels a step and
the "other" ms.

To compare a parent and a change on one card, unpack the parent with
``git archive`` into a directory git ignores (``build/parent``) and run
parent, change, change, parent in one call, each in its own process.
"""
import dataclasses
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
from repro_torch.serve import Engine, EngineConfig  # noqa: E402

KERNELS = ("fused_vq_matmul", "flash_decode", "dequant_gemv")


def serve() -> dict:
    model, params, prompts = cs.build_weights(torch, "llama2_7b")
    out = cs.serve_phase(
        torch, model, params, prompts, "serve",
        RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda")),
        EngineConfig(num_slots=cs.SLOTS, max_len=cs.MAX_LEN), KERNELS)
    m = out["metrics"]
    return {"decode_ms_per_step": m["decode_s"] * 1e3 / m["decode_steps"],
            "prefill_s": m["prefill_s"], "tokens": m["tokens_generated"]}


def decode_step(arch: str, layers: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.serve.kvcache import pad_prefill_cache

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model, params, _ = cs.build_weights(torch, arch, cfg)
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    eng = Engine(model, params, rc,
                 EngineConfig(num_slots=cs.SLOTS, max_len=cs.MAX_LEN),
                 device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (cs.SLOTS, 64), generator=gen,
                         device="cuda", dtype=torch.int32)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks}, eng.rc)
        base = pad_prefill_cache(cache, cs.MAX_LEN, window=eng.window)
    for seg, node in eng.caches.items():
        for n, t in node.items():
            t.copy_(base[seg][n])
    tok = toks[:, -1:].cpu().numpy()
    pos = (tok * 0 + 64).astype("int32")
    runs = [cs.device_profile(
        torch, lambda: eng.decode_graph(tokens=tok, positions=pos), steps=20)
        for _ in range(3)]
    return {"arch": arch, "layers": layers,
            "busy_ms": [r["device_busy_ms_per_step"] for r in runs],
            "kernels": runs[0]["device_kernels_per_step"],
            "other_ms": [r["device_ms_by_kernel"]["other"] for r in runs]}


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all(KERNELS)
    if sys.argv[2:3] == ["--decode-step"]:
        out = decode_step(sys.argv[3], int(sys.argv[4]))
    else:
        out = serve()
    print(json.dumps({"ab": root, **out,
                      "process_s": time.perf_counter() - t0}), flush=True)
