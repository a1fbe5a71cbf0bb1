"""Learning-rate schedules: pure functions of the step counter.

Counterpart of ``repro/optim/schedules.py``.  Each schedule maps a step
tensor (any integer or float dtype) to a float32 tensor on the step's
device, the value ``adamw._lr_at`` takes as it is.
"""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "warmup_linear", "constant"]


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def warmup_linear(lr: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        s = step.to(torch.float32)
        warm = s / max(1, warmup)
        frac = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
        return lr * torch.where(s < warmup, warm, 1.0 - (1.0 - floor) * frac)

    return f


def warmup_cosine(lr: float, warmup: int, total: int, floor_frac: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        warm = s / max(1, warmup)
        frac = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = floor_frac + (1.0 - floor_frac) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * torch.where(s < warmup, warm, cos)

    return f
