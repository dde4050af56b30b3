"""Serving entry point: build a model's 2-bit EVA weights and serve a
synthetic request stream through the continuous-batching engine
(``repro/launch/serve.py``, the reference's CLI, flag for flag).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --smoke --device cpu --requests 8 --max-new 16 --sample

The weights are random, drawn on the device from a ``torch.Generator``
seeded with ``seed``, then quantized (``quantize(method="synthetic")``);
at full width the block linears are built as synthetic VQ weights
straight from their shapes (``Model.init(..., block_device="meta")``),
so the model never holds its dense block weights. A whisper model
prefills from 16 frames of d_model and a vision model from 8 image rows
of d_model, as the reference CLI's, drawn from the same generator after
the weights (the vision model keeps its zero gates, as the reference
CLI's does). The tokens differ from the
reference CLI's (another generator); the trace does not: the same numpy
prompts, lengths, sampling and stop flags, so the schedule and the
engine's counters match. ``--device`` (default ``cuda``) is the
port's only extra flag.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.plan import PlanPolicy
from repro_torch.models import RunConfig, build_model
from repro_torch.models.api import PREFILL_EXTRAS
from repro_torch.serve import (Engine, EngineConfig, GenerationRequest,
                               SamplingParams)

# rows of d_model drawn for each prefill extra, as the reference CLI's
_EXTRA_ROWS = {"frames": 16, "image_embeds": 8}


def serve(arch: str = "llama2-7b", *, smoke: bool = True, requests: int = 8,
          max_new: int = 16, prompt_len: int = 12, num_slots: int = 4,
          vq_mode: str = "eva", quantize: bool = True, seed: int = 0,
          sample: bool = False, temperature: float = 0.8, top_k: int = 40,
          top_p: float = 0.95, eos: Any = None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """Drive a synthetic trace through the engine on ``device`` (default
    "cuda"). ``sample=True`` mixes sampled requests (temperature / top_k /
    top_p, per-request seeds) among the greedy ones; ``eos`` adds a
    per-request stop token. Returns the reference's keys and the engine
    itself (``"engine"``)."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # full width: block linears as shapes only (a smoke config has linears
    # too narrow to quantize, which must be drawn)
    params = model.init(gen, device=dev,
                        block_device="meta" if quantize and not smoke else None)
    if quantize:
        params = model.quantize(params, method="synthetic", generator=gen,
                                device=dev)
    rc = RunConfig(mode="decode", attn_chunk=64, plan_policy=PlanPolicy(
        vq_mode=vq_mode if quantize else "none", impl="cuda"))
    ecfg = EngineConfig(num_slots=num_slots, max_len=prompt_len + max_new + 8)
    extras = {k: torch.randn((_EXTRA_ROWS[k], cfg.d_model), generator=gen,
                             device=dev)
              for k in PREFILL_EXTRAS.get(cfg.family, ())}
    eng = Engine(model, params, rc, ecfg, extras, device=dev)
    rng = np.random.default_rng(seed)
    eos_ids = () if eos is None else (int(eos),)
    reqs = []
    for i in range(requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              rng.integers(4, prompt_len + 1))
        sp = SamplingParams() if not sample or i % 2 == 0 else SamplingParams(
            greedy=False, temperature=temperature, top_k=top_k, top_p=top_p,
            seed=i)
        reqs.append(GenerationRequest(prompt=prompt, max_new_tokens=max_new,
                                      sampling=sp, eos_ids=eos_ids))
    t0 = time.time()
    uids = [eng.submit(r) for r in reqs]
    events = []
    while not eng.idle:
        events.extend(eng.step())
    dt = time.time() - t0
    results = {u: list(eng.output(u).tokens) for u in uids}
    total_tokens = sum(len(v) for v in results.values())
    return {
        "results": results,
        "outputs": {u: eng.output(u) for u in uids},
        "events": events,
        "metrics": eng.metrics(),
        "wall_s": dt,
        "tokens": total_tokens,
        "tok_per_s": total_tokens / max(dt, 1e-9),
        "engine": eng,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--vq-mode", default="eva", choices=["eva", "dequant"])
    ap.add_argument("--no-quantize", dest="quantize", action="store_false")
    ap.add_argument("--sample", action="store_true",
                    help="mix sampled requests among the greedy ones")
    ap.add_argument("--eos", type=int, default=None,
                    help="per-request stop token id")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)
    out = serve(args.arch, smoke=args.smoke, requests=args.requests,
                max_new=args.max_new, num_slots=args.slots,
                vq_mode=args.vq_mode, quantize=args.quantize,
                sample=args.sample, eos=args.eos, device=args.device)
    m = out["metrics"]
    print(f"served {len(out['results'])} requests, {out['tokens']} tokens, "
          f"{out['tok_per_s']:.1f} tok/s")
    print(f"engine: admitted={m['admitted']} rejected={m['rejected']} "
          f"finished={m['finished']} (stop={m['finished_stop']} "
          f"length={m['finished_length']}) decode_steps={m['decode_steps']} "
          f"occupancy={m['slot_occupancy']:.2f}")


if __name__ == "__main__":
    main()
