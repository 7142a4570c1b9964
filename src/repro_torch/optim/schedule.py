"""Learning-rate schedules (port of ``repro/optim/schedule.py``): each
returns the multiplier in [0, 1] of ``AdamWConfig.lr`` as a 0-dim f32
tensor, in f32 arithmetic as ``repro``'s jnp."""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32)


def cosine_schedule(step, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warmup then cosine decay to min_ratio."""
    step = _f32(step)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def linear_schedule(step, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.0):
    step = _f32(step)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    lin = 1.0 - (1.0 - min_ratio) * torch.clamp(prog, 0.0, 1.0)
    return torch.where(step < warmup_steps, warm, lin)
