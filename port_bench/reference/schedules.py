"""Frozen copy of `rodygs_tpu_torch/ops/schedules.py` (the parts the
benchmark's plain reference uses): later changes to the program do not
reach it. The original docstring follows.

Learning-rate schedules. Port of `rodygs_tpu/ops/schedules.py`.

Evaluated in float32 on 0-dim tensors, as the JAX package evaluates them
on a traced f32 step, so the per-step learning rates agree to the bit
pattern's rounding.
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    """Log-linear interpolation from lr_init to lr_final over max_steps with
    an optional reverse-cosine delay ramp. Returns 0 where disabled."""
    step = _f32(step)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(_f32(math.log(lr_init)) * (1 - t)
                         + _f32(math.log(lr_final)) * t)
    lr = delay_rate * log_lerp
    return torch.where(step < 0, torch.zeros_like(lr), lr)


def warmup_cosine_lr(step, max_lr: float, warmup_steps: int, total_steps: int):
    """Linear warmup then cosine annealing to zero."""
    step = _f32(step)
    if warmup_steps > 0:
        warm = max_lr * (step / warmup_steps)
    else:
        warm = torch.full_like(step, max_lr)
    progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    cos = max_lr * 0.5 * (1 + torch.cos(math.pi * progress))
    return torch.where(step < warmup_steps, warm, cos)
