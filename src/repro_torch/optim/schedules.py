"""Learning-rate schedules, pure functions of the step counter (port of
``repro/optim/schedules.py``): each returns an f32 0-dim tensor on the
step's device."""
from __future__ import annotations

import math

import torch


def _step(step):
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(peak_lr: float, warmup: int, total: int,
                       floor_frac: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup, 1)
        t = ((step - warmup) / max(total - warmup, 1)).clamp(0, 1)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant(peak_lr: float):
    return lambda step: torch.full_like(_step(step), peak_lr)
