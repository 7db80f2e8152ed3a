"""Learning-rate schedules (port of ``repro/optim/schedules.py``), computed
in f32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1):
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)
