"""A cell at a size the CPU holds, for the harness's tests: a two-layer
model of each kind the benchmark serves (qkv biases or per-head norms, a
tied or an untied head) under a short closed loop. Importing this module
puts ``evabench/`` and the program's ``src/`` on the path."""
from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # evabench/
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench.manifest import Cell, _applies, _json  # noqa: E402

# a run's window is timed: keep the CPU's ticks from contending for cores
torch.set_num_threads(2)


def config(kind: str = "qwen2") -> dict:
    run = {"name": f"{kind}-smoke", "hidden_size": 128,
           "intermediate_size": 256, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 32, "vocab_size": 512, "rms_norm_eps": 1e-6,
           "rope_theta": 1000000.0, "tie_word_embeddings": kind == "qwen3",
           "qkv_bias": kind == "qwen2", "qk_norm": kind == "qwen3",
           "torch_dtype": "bfloat16"}
    return {"name": f"{kind}_smoke", "reference": "dense_gqa", "run": run}


TRAFFIC = {"loop": "closed", "clients": 3, "think_s": 0,
           "prompt_len": [5, 20], "output_len": [3, 9], "strata": 8,
           "first_output_len": [1, 9]}


def cell(kind: str = "qwen2", name: str = "qwen2_72b.chat_decode",
         limits: dict = None) -> Cell:
    """A smoke cell with the metrics BENCHMARK.json gives cell ``name``."""
    bench = _json(ROOT / "BENCHMARK.json")
    return Cell(name=name, chips=1, config=config(kind), traffic=dict(TRAFFIC),
                workload={"engine": {"num_slots": 3, "max_len": 32},
                          "trace_ticks": 4,
                          "judge": {"sample": 3, "limits": dict(
                              limits or {"mean_logit_gap": 1.0})}},
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])
