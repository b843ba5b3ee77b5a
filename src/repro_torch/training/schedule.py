"""Learning-rate schedules (pure functions of the step) — port of
``repro/training/schedule.py``.  They compute in fp32 0-d tensors, as the
JAX functions do, and return one."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=_F32)


def warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = torch.div(base_lr * step, _f32(max(warmup_steps, 1)))
    t = torch.clamp(torch.div(step - warmup_steps,
                              _f32(max(total_steps - warmup_steps, 1))), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def warmup_constant(step, base_lr: float, warmup_steps: int) -> torch.Tensor:
    step = _f32(step)
    return base_lr * torch.clamp(torch.div(step, _f32(max(warmup_steps, 1))),
                                 max=1.0)


def constant(step, base_lr: float) -> torch.Tensor:
    del step
    return _f32(base_lr)
