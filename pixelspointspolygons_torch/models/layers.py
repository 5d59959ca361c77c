"""Layers with flax.linen's semantics, so bridged weights train the same way
— port of pixelspointspolygons_tpu/models/layers.py plus flax's defaults.

- `BatchNorm`: flax `nn.BatchNorm(momentum=0.9)` over the channel axis 1
  (NCHW maps, or (N, C) rows). Flax updates the running variance with the
  *biased* batch variance; `torch.nn.BatchNorm2d` uses the unbiased one, so
  it cannot stand in. Torch momentum 0.1 is flax momentum 0.9.
- `LayerNorm`: flax's eps is 1e-6 (torch's default 1e-5).
- `MultiHeadAttention`: explicit q/k/v/o projections, logits divided by
  √Dh after the product, softmax in float32, masks as an additive −1e9
  (`causal_bias`, `padding_bias`); `project_kv` and `attend` let the
  KV-cached decode reuse the weights.
- `init_flax_defaults`: flax's default initializers — conv and dense
  kernels and embeddings `lecun_normal` (truncated normal on [-2σ, 2σ],
  fan_in), zero biases, BatchNorm and LayerNorm scale 1 and bias 0 —
  instead of torch's kaiming-uniform; modules with raw parameters draw them
  in their own `reset_flax_parameters(generator)`.
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
            var, mean = torch.var_mean(x, dim=[d for d in range(x.ndim) if d != 1], unbiased=False)
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
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            # flax Embed: variance_scaling(1, fan_in, normal) over (V, D), fan_in D
            lecun_normal_(m.weight, generator)
        elif isinstance(m, (BatchNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        if hasattr(m, "reset_flax_parameters"):
            m.reset_flax_parameters(generator)


def LayerNorm(dim: int, device=None) -> nn.LayerNorm:
    """flax `nn.LayerNorm()`: eps 1e-6, scale and bias."""
    return nn.LayerNorm(dim, eps=1e-6, device=device)


def adaptive_avg_pool1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool1d over the last axis: window i averages
    [floor(i·in/out), ceil((i+1)·in/out)) (the reference's channel
    bottleneck 384 → 256 on (B, L, C))."""
    if x.shape[-1] == out_size:
        return x
    return F.adaptive_avg_pool1d(x, out_size)


class MlpBlock(nn.Module):
    """Dense → exact (erf) GELU or ReLU → Dense. Flax Dense_0/Dense_1 are
    dense0/dense1."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, activation: str = "gelu", device=None):
        super().__init__()
        self.dense0 = nn.Linear(in_dim, hidden_dim, device=device)
        self.dense1 = nn.Linear(hidden_dim, out_dim, device=device)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dense0(x)
        h = F.gelu(h) if self.activation == "gelu" else F.relu(h)
        return self.dense1(h)


class MultiHeadAttention(nn.Module):
    """Explicit q/k/v/o projections; takes external K/V and an additive bias."""

    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim, device=device)
        self.k = nn.Linear(dim, dim, device=device)
        self.v = nn.Linear(dim, dim, device=device)
        self.o = nn.Linear(dim, dim, device=device)

    def project_kv(self, kv_src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """K/V of a source (e.g. the cross-attention memory), once."""
        return self.k(kv_src), self.v(kv_src)

    def attend(self, q_src: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
        """q_src: (B, Lq, D); k, v: (B, Lk, D); bias broadcastable to
        (B, H, Lq, Lk), added to the logits."""
        B, Lq, _ = q_src.shape
        H = self.num_heads
        Dh = self.dim // H
        q = self.q(q_src).reshape(B, Lq, H, Dh).transpose(1, 2)
        kh = k.reshape(B, -1, H, Dh).transpose(1, 2)
        vh = v.reshape(B, -1, H, Dh).transpose(1, 2)
        logits = torch.matmul(q, kh.transpose(-1, -2)) / math.sqrt(Dh)
        if bias is not None:
            logits = logits + bias
        w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.matmul(w, vh).transpose(1, 2).reshape(B, Lq, self.dim)
        return self.o(out)

    def forward(self, q_src, kv_src, bias=None):
        k, v = self.project_kv(kv_src)
        return self.attend(q_src, k, v, bias)


def causal_bias(length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, 1, L, L) additive causal mask: 0 on and below the diagonal, −1e9 above."""
    future = torch.ones(length, length, dtype=torch.bool, device=device).triu(1)
    return torch.zeros(length, length, dtype=dtype, device=device).masked_fill_(future, -1e9)[None, None]


def padding_bias(pad_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """pad_mask: (B, Lk) True where PAD → (B, 1, 1, Lk) additive bias."""
    return torch.zeros(pad_mask.shape, dtype=dtype, device=pad_mask.device).masked_fill(pad_mask, -1e9)[:, None, None, :]
