"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``):
functions of the int step tensor that return an f32 scalar tensor."""
from __future__ import annotations

import math

import torch


def constant_lr(value: float):
    def f(step):
        return torch.tensor(value, dtype=torch.float32, device=step.device)
    return f


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor_frac: float = 0.1):
    def f(step):
        step = step.to(torch.float32)
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return f
