"""LR schedules (multipliers on the base LR), ``repro.optim.schedule``'s:
each takes the step as a tensor and computes in float32."""
from __future__ import annotations

import math

import torch


def warmup_cosine(warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        step = step.to(torch.float32)
        warm = step / max(warmup, 1)
        t = (step - warmup) / max(total - warmup, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * torch.clamp(t, 0, 1)))
        return torch.where(step < warmup, warm, cos)

    return fn


def constant():
    return lambda step: torch.ones_like(step, dtype=torch.float32)
