"""Batched bilinear map lookup (the ACM polygonization's data term) — port
of pixelspointspolygons_tpu/ops/bilinear.py.

Positions are (y, x) float pixel coordinates; the corner pixels clamp at
the border; the channels are gathered per position. Differentiable in the
positions (the floors and indices carry no gradient, as in JAX).
"""

from __future__ import annotations

import torch


def bilinear_interpolate(im: torch.Tensor, pos: torch.Tensor, batch: torch.Tensor | None = None) -> torch.Tensor:
    """Sample `im` (B, C, H, W) at `pos` (N, 2) (y, x), from the maps
    `batch` (N,) (all 0 by default). Returns (N, C)."""
    B, C, H, W = im.shape
    y = pos[:, 0]
    x = pos[:, 1]
    if batch is None:
        batch = torch.zeros(pos.shape[0], dtype=torch.long, device=pos.device)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0

    x0i = x0.long().clamp(0, W - 1)
    x1i = x1.long().clamp(0, W - 1)
    y0i = y0.long().clamp(0, H - 1)
    y1i = y1.long().clamp(0, H - 1)

    Ia = im[batch, :, y0i, x0i]  # (N, C)
    Ib = im[batch, :, y1i, x0i]
    Ic = im[batch, :, y0i, x1i]
    Id = im[batch, :, y1i, x1i]

    wa = ((x1 - x) * (y1 - y))[:, None]
    wb = ((x1 - x) * (y - y0))[:, None]
    wc = ((x - x0) * (y1 - y))[:, None]
    wd = ((x - x0) * (y - y0))[:, None]

    return wa * Ia + wb * Ib + wc * Ic + wd * Id
