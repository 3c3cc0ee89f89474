"""LR schedules: functions of the optimizer's int32 step count (a 0-d
tensor on the parameters' device) to a float32 0-d tensor on that device,
computed in float32 in the reference's order."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        warm = peak * c / max(1, warmup)
        prog = torch.clamp((c - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup, warm, cos)

    return lr


def constant(value: float):
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=count.device)
