"""LR and μ schedules (port of ``src/repro/optim/schedules.py``).

``cosine_warmup`` takes a step as a Python number or a 0-d tensor and
computes in float32, as the reference does under JAX."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: lr


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        w = torch.clamp_max(s / max(warmup, 1), 1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return peak * w * (floor + (1 - floor)
                           * 0.5 * (1 + torch.cos(math.pi * t)))
    return f


def lstep_decay(base: float, decay: float = 0.98):
    """Paper §6: lr_base · decay^lc_step, constant within each L step."""
    return lambda lc_step: base * (decay ** lc_step)


def mu_exponential(mu0: float, a: float, n: int) -> list[float]:
    return [mu0 * a**k for k in range(n)]
