"""Scharr spatial gradient in (i, j) = (row, col) coordinates — port of
pixelspointspolygons_tpu/ops/spatial_grad.py (the vendored kornia
SpatialGradient with coord="ij", which FFL's seg-gradient losses read).

A depthwise convolution (`groups=C`) with zero "SAME" padding and the
normalized Scharr kernel (the sum of |weights| is 1). Output (B, C, 2, H, W):
[d/di (rows), d/dj (cols)] per channel, in the order of JAX's `jnp.tile`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SCHARR_DJ = [[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]]


def spatial_gradient(x: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W) → (B, C, 2, H, W) with [d/di, d/dj]."""
    b, c, h, w = x.shape
    dj = torch.tensor(_SCHARR_DJ, dtype=torch.float32, device=x.device) / 32.0
    k = torch.stack([dj.T, dj])[:, None].repeat(c, 1, 1, 1).to(x.dtype)  # (2C, 1, 3, 3)
    return F.conv2d(x, k, padding=1, groups=c).reshape(b, c, 2, h, w)
