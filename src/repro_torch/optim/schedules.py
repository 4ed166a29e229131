"""LR schedules (reference `repro.optim.schedules`): plain callables
fn(step: 0-d int32 tensor) -> 0-d float32 tensor, for `resolve_lr`."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = (step.float() / max(total_steps, 1)).clamp(0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = step.float()
        warm = s / max(warmup_steps, 1)
        t = ((s - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(
            0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * t))
        return lr * torch.where(s < warmup_steps, warm, cos)

    return fn
