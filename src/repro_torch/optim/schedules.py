"""LR schedules: WSD (minicpm's warmup-stable-decay), cosine, constant.

PyTorch counterpart of ``repro.optim.schedules``: each takes the step
count (an int or an integer tensor) and returns the rate as a float32
0-d tensor on the count's device, computed in float32 in the reference's
order.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(F32)


def wsd(step, peak_lr: float, warmup: int, stable: int, decay: int,
        floor: float = 0.1) -> torch.Tensor:
    """MiniCPM's warmup-stable-decay: linear warmup, flat plateau, then a
    linear decay to ``floor * peak`` over ``decay`` steps."""
    step = _step(step)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    in_decay = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0,
                           1.0)
    decay_mult = (1.0 - in_decay) + in_decay * floor
    return torch.where(step < warmup + stable, warm, peak_lr * decay_mult)


def cosine(step, peak_lr: float, warmup: int, total: int,
           floor: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, peak_lr * cos)


def constant(step, peak_lr: float, warmup: int = 0) -> torch.Tensor:
    step = _step(step)
    if warmup:
        return peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    return torch.full_like(step, peak_lr)


def make(name: str, peak_lr: float, total_steps: int, warmup: int = 100):
    """The schedule of ``name`` (``"wsd"``, ``"cosine"``, anything else
    constant) as a function of the step count."""
    if name == "wsd":
        stable = int(total_steps * 0.8) - warmup
        decay = total_steps - warmup - stable
        return lambda s: wsd(s, peak_lr, warmup, max(stable, 1),
                             max(decay, 1))
    if name == "cosine":
        return lambda s: cosine(s, peak_lr, warmup, total_steps)
    return lambda s: constant(s, peak_lr, warmup)
