"""Vision Transformer token encoder (ViT-S family) — port of
pixelspointspolygons_tpu/models/vit.py (:32-129).

- `ViTBackbone`: patch embedding, CLS token, learned position embeddings,
  pre-norm blocks, final LayerNorm → (B, 1 + N, dim) tokens.
- `ViTEncoder`: backbone → drop CLS → AdaptiveAvgPool1d channel bottleneck
  (384 → out_dim) → (B, N, out_dim).
- `ViTCNNEncoder` (JAX :132-158): backbone → drop CLS → the token grid
  resized bilinearly to out_size (`layers.resize_bilinear`, JAX's
  `jax.image.resize`) → Conv3×3 + BatchNorm + ReLU → (B, S, S, out_dim)
  NHWC, the dense map of the HiSup and FFL heads.

Images arrive NHWC, as the loader gives them. The flax patch embedding is an
NHWC conv whose (B, gh, gw, dim) output is flattened row-major over
(gh, gw); the NCHW `Conv2d` here flattens (B, dim, gh, gw) the same way, so
token i is patch (i // gw, i % gw) in both. Attention is the explicit
`MultiHeadAttention` of `layers.py`, the same module the decoder uses.
Module names follow the flax tree (`utils/bridge.py`): LayerNorm_0/1 are
ln0/ln1, MultiHeadAttention_0 is attn, MlpBlock_0 is mlp. `dtype` is the
compute dtype (`layers.py`): at bfloat16 the patch embedding, the CLS token
and the position embeddings are cast to it, so the residual stream is
bfloat16, as in the flax modules (JAX vit.py:77-96).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    BatchNorm,
    Conv2d,
    LayerNorm,
    MlpBlock,
    MultiHeadAttention,
    adaptive_avg_pool1d,
    cast_to,
    resize_bilinear,
)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, layer_scale: bool = False, dtype=None,
                 device=None):
        super().__init__()
        self.ln0 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, dtype=dtype, device=device)
        self.ln1 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dim, dtype=dtype, device=device)
        self.layer_scale = layer_scale
        if layer_scale:  # DINOv2 LayerScale gammas
            self.ls1 = nn.Parameter(torch.full((dim,), 1e-5, device=device))
            self.ls2 = nn.Parameter(torch.full((dim,), 1e-5, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ln0(x)
        h = self.attn(h, h)
        if self.layer_scale:
            h = h * cast_to(self.ls1, h.dtype)
        x = x + h
        h = self.mlp(self.ln1(x))
        if self.layer_scale:
            h = h * cast_to(self.ls2, h.dtype)
        return x + h


class ViTBackbone(nn.Module):
    """ViT trunk producing (B, 1 + N, dim) tokens (CLS first).

    With `num_tokens` the trunk takes precomputed (B, num_tokens, dim)
    tokens from another patch embedding (the LiDAR pillar canvas, the
    early-fusion conv; JAX vit.py:66-88) and holds no `patch_embed`, as a
    flax trunk that is called with `tokens` never creates one."""

    def __init__(self, img_size: int = 224, patch_size: int = 8, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, layer_scale: bool = False, num_tokens: int | None = None, dtype=None,
                 device=None):
        super().__init__()
        self.depth = depth
        self.compute_dtype = dtype
        n = (img_size // patch_size) ** 2 if num_tokens is None else num_tokens
        self.patch_embed = None if num_tokens is not None else nn.Conv2d(3, dim, patch_size, stride=patch_size,
                                                                        device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim, device=device))
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, num_heads, layer_scale=layer_scale, dtype=dtype, device=device))
        self.norm = LayerNorm(dim, dtype=dtype, device=device)

    def reset_flax_parameters(self, generator=None) -> None:
        with torch.no_grad():
            nn.init.normal_(self.cls_token, 0.0, 0.02, generator=generator)
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)

    def forward(self, images: torch.Tensor | None = None, tokens: torch.Tensor | None = None) -> torch.Tensor:
        """images: (B, H, W, 3) NHWC, or `tokens` (B, N, dim) for a trunk
        built with `num_tokens`."""
        if tokens is None:
            dt, pe = self.compute_dtype, self.patch_embed
            x = F.conv2d(cast_to(images.permute(0, 3, 1, 2), dt), cast_to(pe.weight, dt), cast_to(pe.bias, dt),
                         stride=pe.stride)
            x = x.flatten(2).transpose(1, 2)  # (B, gh·gw, dim), row-major patches
        else:
            x = tokens
        x = torch.cat([cast_to(self.cls_token, x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
        x = x + cast_to(self.pos_embed, x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x)


class ViTEncoder(nn.Module):
    """Token encoder: drop CLS, optional channel bottleneck. Output (B, N, D)."""

    def __init__(self, img_size: int = 224, patch_size: int = 8, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, out_dim: int | None = 256, layer_scale: bool = False, dtype=None, device=None):
        super().__init__()
        self.vit = ViTBackbone(img_size, patch_size, dim, depth, num_heads, layer_scale=layer_scale, dtype=dtype,
                               device=device)
        self.out_dim = dim if out_dim is None else out_dim

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool1d(self.vit(images)[:, 1:], self.out_dim)


def token_map_head(tokens: torch.Tensor, conv: nn.Module, bn: nn.Module, out_size: int) -> torch.Tensor:
    """(B, N, C) tokens of a √N x √N grid → bilinear resize to out_size →
    conv, BatchNorm, ReLU → NHWC (the head of JAX's ViTCNN-style encoders)."""
    B, N, C = tokens.shape
    g = int(round(N ** 0.5))
    x = resize_bilinear(tokens.transpose(1, 2).reshape(B, C, g, g), out_size)  # token i is cell (i // g, i % g)
    return F.relu(bn(conv(x))).permute(0, 2, 3, 1)


class ViTCNNEncoder(nn.Module):
    """Dense-map encoder of the HiSup and FFL heads. Output (B, S, S,
    out_dim) NHWC (a permuted view of the NCHW map). The flax auto-names
    Conv_0 and BatchNorm_0 are conv0 and bn0 (`utils/bridge.py`)."""

    def __init__(self, img_size: int = 224, patch_size: int = 8, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, out_size: int = 224, out_dim: int = 256, layer_scale: bool = False,
                 dtype=None, device=None):
        super().__init__()
        self.out_size = out_size
        self.vit = ViTBackbone(img_size, patch_size, dim, depth, num_heads, layer_scale=layer_scale, dtype=dtype,
                               device=device)
        self.conv0 = Conv2d(dim, out_dim, 3, padding=1, bias=True, dtype=dtype, device=device)
        self.bn0 = BatchNorm(out_dim, dtype=dtype, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return token_map_head(self.vit(images)[:, 1:], self.conv0, self.bn0, self.out_size)
