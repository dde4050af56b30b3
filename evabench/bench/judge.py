"""What decides ``correct``: the served tokens against the plain reference.

After the window has closed and the program's state is freed, a sample
of the requests that finished in the window, drawn from the seed and
holding the one with the most served tokens, is run once through the
reference over its prompt and its served tokens (the last one not fed
back). At each served position the reference's fp32 logits give the gap
by which the served token's logit lies below the reference's best, and
the distance of the engine's log-probability of that token from the
reference's. The numbers compared are those the cell's limits name:
the mean gap (``mean_logit_gap``) and the mean distance
(``mean_logprob_error``) in every cell, and the widest gap
(``max_logit_gap``) where it separates the program from the control. In
qwen2-72b's 80 random layers a plain bf16 computation lands as far from
fp32 as fp8 does at a few positions of a few seeds, so no limit on the
widest gap tells rounding from a fault there, and it is only logged
(``PERF.md``).
Greedy decoding only: every request of the traffic is greedy.

The control reads the same prompts and tokens through the reference in
fp8 (``readings(..., precisions=("fp8",))``): at each position the token
the fp8 computation puts first, and its gap in the fp32 logits. Its
readings go through the same ``verdict`` and ``passed`` against the
cell's own limits (``judge_all``), and it has to come out not correct.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# a sample's draw is taken apart from the traffic's
SAMPLE_STREAM = 0x5EED


def pick(finished: Sequence, k: int, seed: int) -> List:
    """``k`` of the finished streams: the one with the most served tokens
    (the earliest on a tie), then others drawn from the seed."""
    if not finished:
        return []
    longest = max(finished, key=lambda s: (len(s.tokens), -s.index))
    rest = [s for s in finished if s is not longest]
    rng = np.random.default_rng([int(seed), SAMPLE_STREAM])
    take = rng.permutation(len(rest))[:max(0, k - 1)]
    return [longest] + [rest[i] for i in sorted(take)]


def reference_module(cfg_file: Dict):
    return importlib.import_module(f"reference.{cfg_file['reference']}")


def readings(cfg_file: Dict, w: Dict, sample: Sequence, device,
             precisions: Sequence[str] = ()) -> Dict:
    """The readings over ``sample``: ``max_logit_gap`` and
    ``mean_logit_gap``, the widest and the mean gap of a served token
    below the fp32 reference's best, and ``mean_logprob_error``, the mean
    distance of the served tokens' log-probabilities (as the engine
    reports them) from the reference's, under ``served``; the same two under each of ``precisions`` for the
    reference computed in that precision in the program's place (the
    gaps of the tokens it puts first, its log-probabilities of the
    served tokens; ``fp8``: the control); and the tokens compared."""
    ref = reference_module(cfg_file)
    cfg = cfg_file["run"]
    seqs, starts, served = [], [], []
    for s in sample:
        toks = np.concatenate([s.prompt, np.asarray(s.tokens[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, dtype=torch.int64, device=device))
        starts.append(len(s.prompt) - 1)
        served.append(torch.as_tensor(s.tokens, dtype=torch.int64,
                                      device=device))
    out = ref.logits(cfg, w, seqs, starts, ("fp32", *precisions))
    gaps = {p: [] for p in ("served", *precisions)}
    lp_err = {p: [] for p in ("served", *precisions)}
    for i, z in enumerate(out["fp32"]):
        best = z.max(dim=-1).values
        tok = served[i][:, None]
        gaps["served"].append(best - z.gather(1, tok)[:, 0])
        ref_lp = torch.log_softmax(z, dim=-1).gather(1, tok)[:, 0]
        got = torch.as_tensor(sample[i].logprobs, dtype=torch.float32,
                              device=z.device)
        lp_err["served"].append((got - ref_lp).abs())
        for p in precisions:
            top = out[p][i].argmax(dim=-1)
            gaps[p].append(best - z.gather(1, top[:, None])[:, 0])
            lp = torch.log_softmax(out[p][i], dim=-1).gather(1, tok)[:, 0]
            lp_err[p].append((lp - ref_lp).abs())
    res = {p: {"max_logit_gap": float(torch.cat(gaps[p]).max()),
               "mean_logit_gap": float(torch.cat(gaps[p]).mean()),
               "mean_logprob_error": float(torch.cat(lp_err[p]).mean())}
           for p in gaps}
    res["tokens_compared"] = int(sum(z.shape[0] for z in out["fp32"]))
    return res


def verdict(reading: Optional[Dict], limits: Dict[str, float], short: int,
            side: str = "served") -> Dict[str, Dict[str, float]]:
    """The numbers compared, each with its limit: the gaps the cell's
    ``limits`` name, read for ``side`` (the program's served tokens, or a
    precision of the reference put in its place), and the finished
    requests that served fewer tokens than asked (an exact comparison,
    limit 0)."""
    out = {}
    for name, limit in limits.items():
        value = (float("inf") if reading is None
                 else reading[side][name])
        out[name] = {"value": value, "limit": limit}
    out["requests_short"] = {"value": short, "limit": 0}
    return out


def passed(compared: Dict[str, Dict[str, float]], tokens: int) -> bool:
    return tokens > 0 and all(v["value"] <= v["limit"]
                              for v in compared.values())


def judge_all(reading: Dict, limits: Dict[str, float], short: int
              ) -> Dict[str, Dict]:
    """``correct`` and the numbers compared for every side the reading
    holds: the program (``served``) and each precision of the reference
    read in its place. A precision serves no tokens of its own, so none
    of its requests is short."""
    tokens = reading["tokens_compared"]
    out = {}
    for side in reading:
        if side == "tokens_compared":
            continue
        compared = verdict(reading, limits, short if side == "served" else 0,
                           side)
        out[side] = {"correct": passed(compared, tokens),
                     "compared": compared}
    return out
