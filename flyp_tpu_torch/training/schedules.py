"""Learning-rate schedules.

Counterpart of ``flyp_tpu/training/schedules.py``: each schedule maps a step
(a Python number or a tensor, on any device) to a float32 tensor of the
same device, so a step counter kept on the card gives the rate on the card
without a host round trip.  ``warmup_cosine_lr`` is FLYP's linear warmup
``base*(step+1)/warmup`` then ``0.5*(1+cos(pi*e/es))*base + min_lr`` (the
minimum is *added*, the upstream convention); ``crestart_lr`` is the
warm-restart cosine stepped with the epoch index, constant within an epoch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def _as_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine_lr(base_lr: float, warmup_length: int, steps: int, min_lr: float = 0.0) -> Callable:
    def schedule(step):
        step = _as_f32(step)
        warm = base_lr * (step + 1.0) / max(warmup_length, 1)
        e = step - warmup_length
        es = max(steps - warmup_length, 1)
        cos = 0.5 * (1.0 + torch.cos(math.pi * e / es)) * base_lr + min_lr
        return torch.where(step < warmup_length, warm, cos)

    return schedule


def crestart_lr(base_lr: float, t_0: int, eta_min: float = 0.01, steps_per_epoch: Optional[int] = None) -> Callable:
    """Warm-restart cosine, restarting every ``t_0`` epochs (T_mult=1).  With
    ``steps_per_epoch`` the step maps to its epoch first."""

    def schedule(step):
        e = _as_f32(step)
        if steps_per_epoch is not None:
            e = torch.floor(e / steps_per_epoch)
        t_cur = torch.remainder(e, t_0)
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + torch.cos(math.pi * t_cur / t_0))

    return schedule


def make_scheduler(
    name: str,
    base_lr: float,
    warmup_length: int,
    epochs: int,
    num_batches: int,
    min_lr: float = 0.0,
    start_epoch: int = 0,
) -> Callable:
    """The trainer's schedule by name: 'default'/'drestart', 'default_slower'
    or 'crestart'."""
    total = (epochs - start_epoch) * num_batches
    if name in ("default", "drestart"):
        return warmup_cosine_lr(base_lr, warmup_length, total, min_lr)
    if name == "default_slower":
        return warmup_cosine_lr(base_lr, warmup_length, total * 2, min_lr)
    if name == "crestart":
        return crestart_lr(base_lr, t_0=num_batches, eta_min=0.01, steps_per_epoch=num_batches)
    raise ValueError(f"invalid scheduler type {name}!")
