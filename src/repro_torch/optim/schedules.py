"""LR schedules as pure ``step -> lr`` functions: port of
``repro.optim.schedules``.  ``step`` is an int or an integer tensor (the
train state's step, on the device: no host read); the lr is an fp32 0-dim
tensor on ``step``'s device, computed in fp32 in the reference's order."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_with_warmup", "step_decay", "exponential_decay"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device if torch.is_tensor(step) else None)


def cosine_with_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        s = _f32(step)
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)

    return f


def step_decay(base: float, gamma: float, every: int):
    """Paper App. B: e.g. ResNet18 uses 1e-3 decayed x0.1 every 30 epochs."""

    def f(step):
        k = torch.floor(_f32(step) / every)
        return base * gamma**k

    return f


def exponential_decay(base: float, gamma: float, every: int = 1):
    """Paper App. B: MobileNetV1 / ESPCN style per-epoch x0.9 / x0.98 decay."""

    def f(step):
        k = _f32(step) / every
        return base * gamma**k

    return f
