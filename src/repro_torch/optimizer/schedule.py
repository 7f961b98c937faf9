"""Learning-rate schedules (port of ``repro/optimizer/schedule.py``).

The step may be a Python number or a tensor; the result is a float32
tensor on the step's device (the CPU for a Python number).
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def constant(step, base_lr: float) -> torch.Tensor:
    return torch.full_like(_f32(step), base_lr)
