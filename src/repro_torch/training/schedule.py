"""Learning-rate schedules (step -> lr callables; port of
``repro/training/schedule.py``).

Each schedule maps an int32 step tensor to an fp32 tensor on the step's
device, reckoned in fp32 op for op as the reference's ``jnp`` code."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return f


def warmup_rsqrt(peak_lr: float, warmup_steps: int):
    def f(step):
        s = torch.clamp_min(torch.as_tensor(step).to(torch.float32), 1.0)
        warm = peak_lr * s / max(warmup_steps, 1)
        decay = peak_lr * (warmup_steps ** 0.5) / torch.sqrt(s)
        return torch.where(s < warmup_steps, warm, decay)

    return f
