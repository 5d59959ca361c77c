"""Train state, optimizer and schedules — port of
pixelspointspolygons_tpu/train/state.py.

The schedules are functions of the update count with optax's indexing: the
n-th update (n = 0, 1, ...) uses schedule(n). `torch.optim.lr_scheduler.
LambdaLR` reproduces that when it is stepped once after every optimizer
step. AdamW is optax's: every parameter is decayed (BatchNorm and biases
too), eps 1e-8.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""

    def f(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return f


def _join(schedules: list, boundaries: list) -> Callable[[int], float]:
    """optax.join_schedules."""

    def f(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return f


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""

    def f(count: int) -> float:
        c = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1.0 - alpha) * c + alpha)

    return f


def linear_warmup_decay(base_lr: float, total_steps: int, warmup_frac: float = 0.05):
    warmup = max(int(total_steps * warmup_frac), 1)
    return _join(
        [_linear(0.0, base_lr, warmup), _linear(base_lr, 0.0, max(total_steps - warmup, 1))],
        [warmup],
    )


def cosine_with_warmup(base_lr: float, total_steps: int, warmup_frac: float = 0.0):
    """optax.warmup_cosine_decay_schedule(init, base_lr, warmup, total)."""
    warmup = int(total_steps * warmup_frac)
    decay_steps = max(total_steps, 1)
    init = 0.0 if warmup else base_lr
    return _join([_linear(init, base_lr, warmup), _cosine(base_lr, decay_steps - warmup)], [warmup])


def make_optimizer(name: str, params, base_lr: float, weight_decay: float = 0.0, b1=0.9, b2=0.999):
    if name == "adamw":
        return torch.optim.AdamW(params, lr=base_lr, betas=(b1, b2), eps=1e-8, weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=base_lr, betas=(b1, b2), eps=1e-8)
    raise ValueError(name)


def make_scheduler(optimizer, schedule: Callable[[int], float], base_lr: float):
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda n: schedule(n) / base_lr)


@dataclass
class TrainState:
    """Model, optimizer and schedule, and the count of updates taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, payload: dict) -> None:
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.scheduler.load_state_dict(payload["scheduler"])
        self.step = int(payload["step"])


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
