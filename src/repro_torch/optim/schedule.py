"""Learning-rate schedules: multiplicative factors over the step (an int
or a tensor), float32 as the reference computes them."""

from __future__ import annotations

import math

import torch


def cosine_schedule(total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(torch.as_tensor(step).to(torch.float32) / total_steps,
                        0.0, 1.0)
        return final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))

    return fn


def warmup_cosine(warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_schedule(max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm,
                           cos(torch.as_tensor(step) - warmup_steps))

    return fn
