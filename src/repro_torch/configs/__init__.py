"""Architecture registry of the port: ``get_config(arch)`` /
``get_smoke_config(arch)`` / ``all_configs()``. Every configuration of
the reference, in its ``ARCH_IDS`` order: the paper's own model
(llama2-7b), the four dense assigned architectures, whisper-medium (an
encoder-decoder with cross-attention), xlstm-125m (alternating mLSTM /
sLSTM blocks), deepseek-v2-lite (MLA, a dense first layer, 64 routed
experts top-6), mixtral (top-2 MoE with sliding-window rings),
recurrentgemma-2b (RG-LRU recurrent layers and local-attention rings)
and llama-3.2-vision-11b (gated cross-attention over image
embeddings)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

ARCH_IDS: List[str] = [
    "minitron_4b",
    "qwen3_0_6b",
    "llama3_8b",
    "qwen2_72b",
    "whisper_medium",
    "xlstm_125m",
    "deepseek_v2_lite_16b",
    "mixtral_8x22b",
    "recurrentgemma_2b",
    "llama_3_2_vision_11b",
    # the paper's own model
    "llama2_7b",
]


def _norm(arch: str) -> str:
    name = arch.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; known: {ARCH_IDS}")
    return name


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_norm(arch)}").CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_norm(arch)}").SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
