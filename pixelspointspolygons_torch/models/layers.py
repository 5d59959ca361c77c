"""Layers with flax.linen's semantics, so bridged weights train the same way.

- `BatchNorm`: flax `nn.BatchNorm(momentum=0.9)` on NCHW. Flax updates the
  running variance with the *biased* batch variance; `torch.nn.BatchNorm2d`
  uses the unbiased one, so it cannot stand in. Torch momentum 0.1 is flax
  momentum 0.9.
- `init_flax_defaults`: flax's default initializers — conv kernels
  `lecun_normal` (truncated normal on [-2σ, 2σ], fan_in), zero biases,
  BatchNorm scale 1 and bias 0 — instead of torch's kaiming-uniform.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
            )
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return out


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> None:
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # std of N(0,1) cut at ±2
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_flax_defaults(module: nn.Module, generator: torch.Generator | None = None) -> None:
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
