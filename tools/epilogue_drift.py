#!/usr/bin/env python3
"""How far a plain decode step drifts from the kernels' step under each
plain EVA epilogue, layer by layer.

    python3 tools/epilogue_drift.py <arch> [<arch> ...]

For each ``arch`` (full width and depth, 2-bit VQ weights drawn on the
card from the seed, as ``chip_smoke.build_weights``) it writes a prefill
of 16 random tokens into 4 slots, for each of three draws of those
tokens, then runs one decode step from that cache through the kernels
(B1, ``impl="cuda"``) and through the plain versions (``impl="torch"``)
with each plain epilogue pinned: direct, blocked and recon, and "auto",
what ``select_epilogue`` picks at each linear. It does so at the
config's activations (bf16) and at fp32 (the same params). The residual
stream after every layer is kept. Each pair of runs (each epilogue
against B1, blocked and recon against direct) gets max |h_a - h_b| /
max |h_b| after every layer, and the step's logit drift relative to
max |logit| with the argmax agreement (as ``chip_smoke.logit_drift``).

Prints one JSON line per (arch, activations, draw) with the drifts after
layers 1, L/8, L/4, L/2, 3L/4 and L and the logits', and writes every
layer's to ``chiprun_out/epilogue_drift.jsonl``.
"""
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.plan import PlanPolicy  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import RunConfig, build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.kvcache import pad_prefill_cache  # noqa: E402

EPILOGUES = ("direct", "blocked", "recon", "auto")
PAIRS = [(e, "b1") for e in EPILOGUES] + [("blocked", "direct"),
                                          ("recon", "direct")]
DRAWS, PROMPT = 3, 16
DEV = "cuda"


def step_states(model, params, step, cache, rc):
    """The decode step's logits and the residual stream (B, D) fp32 after
    each layer."""
    states = []
    layer_fwd = transformer._layer_fwd

    def keep(*args, **kwargs):
        x, nc = layer_fwd(*args, **kwargs)
        states.append(x[:, -1].float().clone())
        return x, nc

    transformer._layer_fwd = keep
    try:
        with torch.no_grad():
            logits, _ = model.decode(params, *step, cache, rc)
    finally:
        transformer._layer_fwd = layer_fwd
    return logits, states


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def drifts(model, params, toks, rc):
    """{pair: (per-layer drifts, logit drift, argmax agreement)} of one
    draw."""
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks}, rc)
    base = pad_prefill_cache(cache, cs.MAX_LEN)
    clone = lambda: cs.map_cache(lambda t: t.clone(), base)
    step = (toks[:, -1:], torch.full((cs.SLOTS, 1), PROMPT, dtype=torch.int32,
                                     device=DEV))
    runs = {"b1": step_states(model, params, step, clone(), rc)}
    for e in EPILOGUES:
        runs[e] = step_states(model, params, step, clone(),
                              rc.replace_policy(impl="torch", epilogue=e))
    vocab = model.cfg.vocab_size
    out = {}
    for a, b in PAIRS:
        (la, sa), (lb, sb) = runs[a], runs[b]
        _, r, agree, finite = cs.logit_drift(torch, la, lb, vocab)
        assert finite, (a, b)
        out[f"{a}_vs_{b}"] = ([rel(x, y) for x, y in zip(sa, sb)], r, agree)
    return out


def run(arch):
    model, params, _ = cs.build_weights(torch, arch)
    cfg = model.cfg
    rc = RunConfig(plan_policy=PlanPolicy(vq_mode="none", impl="cuda"))
    L = cfg.num_layers
    marks = sorted({1, max(1, L // 8), L // 4, L // 2, 3 * L // 4, L})
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    gen = torch.Generator(device=DEV).manual_seed(cs.SEED + 6)
    for draw in range(DRAWS):
        toks = torch.randint(0, cfg.vocab_size, (cs.SLOTS, PROMPT),
                             generator=gen, device=DEV, dtype=torch.int32)
        for acts, m in (("bf16", model), ("fp32", m32)):
            t0 = time.perf_counter()
            got = drifts(m, params, toks, rc)
            line = {"arch": arch, "layers": L, "activations": acts,
                    "draw": draw, "seconds": time.perf_counter() - t0}
            with open(os.path.join(ROOT, "chiprun_out",
                                   "epilogue_drift.jsonl"), "a") as f:
                f.write(json.dumps({**line, "pairs": got}) + "\n")
            print(json.dumps({**line, "marks": marks, "pairs": {
                k: {"layers": [v[0][i - 1] for i in marks],
                    "logit_rel": v[1], "argmax_agreement": v[2]}
                for k, v in got.items()}}), flush=True)
    del model, params, m32
    if DEV == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    print(cs.card_line(), flush=True)
    build.build_all(("fused_vq_matmul", "flash_decode", "dequant_gemv"))
    for a in sys.argv[1:]:
        run(a)
