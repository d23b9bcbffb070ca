"""Learning-rate schedules as step -> lr callables (port of
``src/repro/optim/schedules.py``); ``step`` is an int32 tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def cosine_decay(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp_max(step.float(), total_steps) / max(total_steps, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)

    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(base_lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = step.float()
        warm = base_lr * s / max(warmup, 1)
        return torch.where(s < warmup, warm, cos(torch.clamp_min(step - warmup, 0)))

    return fn
