"""LR schedules — port of `repro/optim/schedules.py`. A schedule maps the
step (an int32 tensor) to the learning rate (a float32 tensor on the same
device)."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    def lr(step):
        step = step.to(torch.float32)
        warm = peak * step / max(1, warmup_steps)
        frac = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(value: float):
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=step.device)
