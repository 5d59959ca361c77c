"""ConvNeXt-V2 dense encoder (FFL's `convnext`) — port of
pixelspointspolygons_tpu/models/convnext.py (`GRN`, `ConvNeXtBlock`,
`ConvNeXtEncoder`, :20-81): a 4×4/4 patchify stem, stages of depthwise 7×7
and pointwise-MLP blocks with global response normalization, a LayerNorm
and 2×2/2 convolution between stages, and the stages' maps resized to the
stride-4 map, concatenated and projected (1×1 convolution, BatchNorm,
ReLU). The defaults are ConvNeXt-V2-T.

Module names are the flax auto-names as `utils/bridge.py` maps them: the
encoder's `Conv_i`/`LayerNorm_i` → `conv{i}`/`ln{i}` (stem first, then one
LayerNorm and one convolution per downsampling, then the projection),
`ConvNeXtBlock_k` → `block{k}` numbered over all stages, `BatchNorm_0` →
`bn0`; in a block `conv0` (depthwise), `ln0`, `dense0`, `grn0`, `dense1`.

The encoder takes and gives NHWC as JAX's does. Convolutions run on NCHW
views in the channels_last layout; a block's LayerNorm, Dense layers, GELU
and GRN act on its channels-last view, as flax's do, in JAX's order.

`dtype` is the compute dtype (flax's `dtype=`): convolutions, Dense
layers and LayerNorms give it, BatchNorm computes in float32 and gives it.
GRN computes in its input's dtype with float32 sums (`jnp.sum` and
`jnp.mean` widen a bfloat16 input and round the result), and its raw
float32 `gamma`/`beta` widen its output to float32, as jnp's promotion
does; the next Dense casts it back.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, Dense, LayerNorm, resize_bilinear, widen


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class GRN(nn.Module):
    """Global response normalization over a channels-last (B, H, W, C) map:
    each channel's L2 norm over H·W, divided by the mean over channels."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        # flax's init: zeros, as here
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim, device=device))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wide = widen(x.dtype)
        gx = torch.sqrt(x.square().sum(dim=(1, 2), keepdim=True, dtype=wide).to(x.dtype) + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True, dtype=wide).to(x.dtype) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtBlock(nn.Module):
    """Depthwise 7×7 → LayerNorm → Dense 4·dim → tanh GELU → GRN → Dense dim,
    added to the input. flax 0.12's `nn.gelu` is the tanh approximation
    (`approximate=True`), torch's default the exact one."""

    def __init__(self, dim: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        # flax (7, 7, 1, dim) kernel with feature_group_count=dim = torch's
        # (dim, 1, 7, 7) with groups=dim; "SAME" at stride 1 pads 3 each side
        self.conv0 = Conv2d(dim, dim, 7, padding=3, groups=dim, **kw)
        self.ln0 = LayerNorm(dim, **kw)
        self.dense0 = Dense(dim, 4 * dim, **kw)
        self.grn0 = GRN(4 * dim, device=device)
        self.dense1 = Dense(4 * dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        h = _nhwc(self.conv0(x))
        h = F.gelu(self.dense0(self.ln0(h)), approximate="tanh")
        h = self.dense1(self.grn0(h))
        return x + _nchw(h)


class ConvNeXtEncoder(nn.Module):
    """(B, S, S, 3) → (B, S/4, S/4, out_dim)."""

    def __init__(self, in_size: int = 224, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), out_dim: int = 256, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.in_size = in_size
        self.depths = tuple(depths)
        self.conv0 = Conv2d(3, dims[0], 4, 4, **kw)
        self.ln0 = LayerNorm(dims[0], **kw)
        k = 0
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            if si > 0:
                self.add_module(f"ln{si}", LayerNorm(dims[si - 1], **kw))
                self.add_module(f"conv{si}", Conv2d(dims[si - 1], dim, 2, 2, **kw))
            for _ in range(depth):
                self.add_module(f"block{k}", ConvNeXtBlock(dim, **kw))
                k += 1
        self.add_module(f"conv{len(depths)}", Conv2d(sum(dims), out_dim, 1, **kw))  # the projection
        self.bn0 = BatchNorm(out_dim, **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # flax's "SAME" padding of the 4×4/4 stem and the 2×2/2 downsamplings
        # is none when each stage's size divides by its stride; other sizes
        # would pad, and are refused rather than sampled on another grid
        size = images.shape[1]
        if images.shape[1] != images.shape[2] or size % (4 * 2 ** (len(self.depths) - 1)):
            raise ValueError(f"ConvNeXtEncoder takes square inputs whose size divides by "
                             f"{4 * 2 ** (len(self.depths) - 1)}, got {tuple(images.shape[1:3])}")
        x = self.conv0(_nchw(images))
        x = _nchw(self.ln0(_nhwc(x)))
        feats, k = [], 0
        for si, depth in enumerate(self.depths):
            if si > 0:
                x = getattr(self, f"conv{si}")(_nchw(getattr(self, f"ln{si}")(_nhwc(x))))
            for _ in range(depth):
                x = getattr(self, f"block{k}")(x)
                k += 1
            feats.append(x)
        tgt = feats[0].shape[-1]
        x = torch.cat([feats[0]] + [resize_bilinear(f, tgt) for f in feats[1:]], dim=1)
        x = F.relu(self.bn0(getattr(self, f"conv{len(self.depths)}")(x)))
        return _nhwc(x)
