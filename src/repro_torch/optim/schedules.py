"""Learning-rate schedules, step -> lr (port of
``repro/optim/schedules.py``).

A schedule takes the optimizer's step, a 0-dim integer tensor on the
params' device, and returns the rate as a 0-dim float32 tensor there,
computed with torch ops in the reference's expression order. So an update
captured in a CUDA graph reads the step on the device at each replay; no
host float is baked in.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division by the float32 constant, as JAX divides
    (a division by a Python scalar may become a multiply by its reciprocal
    on the card)."""
    return x / torch.full_like(x, c)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=_F32, device=step.device)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_div(step.to(_F32), total_steps), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(1, total_steps - warmup), final_frac)

    def fn(step):
        s = step.to(_F32)
        return torch.where(s < warmup, _div(lr * s, max(1, warmup)),
                           cos(s - warmup))
    return fn
