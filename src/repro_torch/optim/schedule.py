"""LR schedules (pure functions of step), the reference's
`optim/schedule.py` in float32 torch."""
import math

import torch


def cosine_schedule(step, *, peak_lr=3e-4, warmup=100, total=10000,
                    min_frac=0.1):
    """Linear warm-up to `peak_lr`, then a cosine decay to
    `min_frac * peak_lr` at `total`; a float32 0-d tensor on step's
    device (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5 *
                     (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
