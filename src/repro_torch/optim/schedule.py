"""LR schedules (pure functions of the step counter), in fp32 as the
reference computes them; each returns a 0-dim fp32 tensor on the CPU, which
PyTorch reads as a scalar beside tensors on the card."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr: float, warmup: int, total: int,
                       final_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full((), peak_lr, dtype=torch.float32)
