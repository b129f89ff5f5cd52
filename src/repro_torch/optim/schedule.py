"""LR schedules, computed in fp32 as the reference computes them. WSD
(warmup-stable-decay) is the MiniCPM schedule [arXiv:2404.06395] —
assigned arch minicpm-2b trains with it.

Port of the reference package's ``optim/schedule.py``. Each returns a
0-d fp32 tensor on the device of ``step`` (the CPU for a Python int).
"""
from __future__ import annotations

import math

import torch


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def wsd_schedule(step, peak_lr: float, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    in_decay = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
    # exponential-style decay to final_frac (MiniCPM uses ~0.1 * peak);
    # log(final_frac) taken in fp32, as jnp.log of a Python float is
    decayed = peak_lr * torch.exp(torch.log(_f32(final_frac, s)) * in_decay)
    return torch.where(s < warmup + stable, warm, decayed)


def cosine_schedule(step, peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi, s) * t))
    return torch.where(s < warmup, warm, peak_lr * cos)
