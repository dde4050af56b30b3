"""Architecture registry of the port: ``get_config(arch)`` /
``get_smoke_config(arch)``. Only the main path's model, llama2-7b, is
ported so far (the other dense configs are ROADMAP A3, the other
families A7)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.common import ModelConfig

ARCH_IDS: List[str] = ["llama2_7b"]


def _norm(arch: str) -> str:
    name = arch.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (ROADMAP A3, A7); ported: "
            f"{ARCH_IDS}")
    return name


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_norm(arch)}").CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_norm(arch)}").SMOKE
