"""Learning-rate schedules, including the paper's Pegasos schedule.

A schedule maps the step (an integer tensor, any shape) to a float32 tensor
of the same shape on the same device, in the reference's float32 arithmetic.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "pegasos_schedule", "cosine_warmup"]


def constant(value: float):
    return lambda step: torch.full_like(torch.as_tensor(step), value, dtype=torch.float32)


def pegasos_schedule(lam: float):
    """alpha_t = 1 / (lambda * t), t 1-based — paper step (d)."""
    return lambda step: 1.0 / (lam * (torch.as_tensor(step).float() + 1.0))


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def sched(step) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        warm = peak * (s + 1.0) / max(1, warmup_steps)  # nonzero lr at step 0
        prog = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)

    return sched
