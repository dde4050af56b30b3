"""Learning-rate schedules (``repro/optim/schedule.py``): a step (an int
or a tensor) -> an fp32 multiplier of ``cfg.lr``, on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def warmup_linear(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.0) -> torch.Tensor:
    step = _f32(step)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    lin = 1.0 - (1.0 - min_ratio) * torch.clamp(prog, 0.0, 1.0)
    return torch.where(step < warmup_steps, warm, lin)


def constant(step, **_) -> torch.Tensor:
    return torch.ones_like(_f32(step))
